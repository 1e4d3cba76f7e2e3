"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card, its power limit and the toolchain.
2. Builds every CUDA kernel of the port from ``soar_tpu_torch/csrc`` with
   nvcc (sm_90a), one process per source, all started together, and prints
   each kernel instance's registers and spills (``-Xptxas -v``); no
   kernel may spill.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes its paths give it, and times both (CUDA events around wrapper
   calls; for the block composites also the kernel's device time alone,
   ``device_ms``, :func:`kernel_ms`): the forward
   composite at the turntable's K=96 (C=7 main pass, C=3 occ pass), the
   backward composite at the training step's K=64 (NT=1024 and 256; two
   launches on the same inputs must be bit-equal); the count-bounded tile
   composite at K=96 with per-tile counts over 0..K is checked with its
   path (5), after the views are timed.
4. Drives the port's turntable (``soar_tpu_torch.cli.render_rot.
   run_turntable``) at full width — the 125,664-surfel procedural scene,
   16-level 2^18 hash field, 512x512 renders — with every launch counter
   set to 0 just before and read just after, and checks the outputs.
   Records the inputs of the composite launches of one bench-camera view
   and replays each launch (device time, bound on the same inputs).
   Then times one view, and holds it against the same view with the plain
   composite, at bench.py's camera and at one that frames the whole body.
5. Drives the tile-list path of the count-bounded composite
   (``render.tiled.gather_tile_lists`` -> ``render.tiles_composite.
   composite_tiles``) on the real tile lists of both views, its launch
   counter set to 0 just before and read just after, and holds the result
   against its plain version and against the forward composite's
   accumulations on the same lists (colour, normal and T to the bit); two
   launches must be bit-equal and a wrapper call one device op.  Prints
   the heaviest tile's slots and the kernel's ns per slot walked there.
6. Runs the truncation probe: the tiled render (kernel composite, K=64 and
   K=96) against the exact oracle (``render.oracle.rasterize_oracle_at``) at
   4,096 seeded pixels of both views; prints PSNR inside the oracle's
   silhouette, which is reference behaviour and not gated.
7. Runs the export's pipeline (``io.meshing.extract_mesh``) at full width:
   the 125,664 Gaussians of the scene with the field's scales and
   opacities; only the grid resolution is cut (64, ``--export-resolution
   128`` for the CLI's default).
8. Drives the port's training step (``soar_tpu_torch.train.trainer.
   make_train_step``) at the full width of bench_trainstep.py's guidance-
   free production step: the same scene and its 8 random GT frames, 4 gen
   views at 256x256, the GT pass and the normal front/back pass at
   512x512, K=64, and the normal-LPIPS terms through a bf16 VGG16
   (``train.lpips.make_lpips_fn``; random weights drawn on the card from
   seed 7 and written as the ``--lpips-weights`` pickle).  2 warm-up
   steps, then 5 timed steps with the counters set to 0 just before and
   read just after: 13 forward and 8 backward kernel launches a step.
   Checks the losses, the parameter updates and that no op of a step
   computes on the CPU, profiles one step, times the VGG16's forward and
   backward inside synced steps, holds bf16 LPIPS against f32 on the
   step's normal render, and holds the kernel step's losses and gradients
   against the plain composite's (f32 LPIPS in both).  The last warm-up
   step's composite launches are recorded and replayed as the view's are
   (backward: two launches bit-equal).
9. The image prompt (``[image prompt]``): ``guidance.build.build_guidance(
   "imagedream", mock=True)`` at full shape in bf16 (UNet 893,131,204, VAE
   encoder 34,163,664, CLIP ViT-H/14 penultimate 611,086,080 and
   Resampler 48,541,696 parameters, checked); the ip tokens of the 8
   frames' 512x512 ``images_crop`` through ``embed_ref`` ([16, 1024],
   finite, different across frames; ms per frame, peak memory), bf16
   against f32 tokens, and the memory ``release_image_encoder()`` frees
   (at least the towers' bf16 bytes).
10. Drives the guided training step (``[guided train]``): the same scene,
   views, raster and LPIPS, stage 1 from its first step, with that
   guidance and each frame's ip tokens in its batch.  2 warm-up and 5
   timed steps, counted (13 forward and 8 backward launches a step), with
   finite SDS metrics and no gradient on a guidance weight; a profiled
   step and its peak memory; the UNet's and the VAE encoder's device ms
   inside a synced step; no op on the CPU; the SDS term's reach to the
   colours and the occ hook (SDS pull at occ high at most half that at occ
   low); the kernel step against the plain one with float32 networks and
   LPIPS (loss terms 1e-3 relative, gradients as in 8); one stage-0 step.
11. Runs the training CLI (``--synthetic --stage both --steps 3``), the
   turntable CLI on its checkpoint, and the mesh-export CLI on it (default
   flags with and without ``--field-attrs``), reads the OBJs back, and
   checks that no op of the density field computes on the CPU; then the
   guided CLI: ``--guidance mvdream --mock-guidance --stage both --steps 3
   --sds-start 0``; ``--guidance imagedream --mock-guidance --stage 1
   --steps 3 --sds-start 0 --lpips-weights <pickle> --lambda-vgg 0.1
   --eval``, fused and with ``--sds-mode split`` (the precomputed-ip-tokens
   line, finite ``loss_sds`` and ``loss_vgg``, an LPIPS column in
   ``average.txt``, the first guided step's ``loss_sds`` equal within
   1e-4 relative); ``--guidance mvdream --mock-guidance
   --prompt-embeddings <seeded npz>``.
12. The real-capture path (``[real capture]``), in one temporary directory:
   ``data.mock_capture`` writes the 20-frame 512x512 capture of the
   procedural body ``test:10,7,28`` on the card (GT without truncation,
   covered); ``data.dataset.load_sequence`` loads it (shapes, the w2c row
   flip, every decoded PNG equal to the uint8 image written); ``cli.train
   --dataroot ... --num-subdiv 3 --gen-res 256 --guidance imagedream
   --mock-guidance --lpips-weights <pickle> --stage both --steps 8
   --sds-start 0 --eval`` at full width (125,664 surfels, the full field
   distilled 1000 steps), counted (13 forward and 8 backward launches in
   every step), with finite losses, one step under host_ops (no op on the
   CPU) and one profiled, ms/step per stage, ``real_setup`` and
   distillation seconds, peak memory and the eval's PSNR/SSIM/LPIPS
   (reported, not gated); then ``cli.render_rot`` and ``cli.export_mesh``
   with the same capture flags on its stage-1 checkpoint.
13. The reference checkpoint (``[reference import]``), on that capture:
   a Lightning ``.ckpt`` written by the script (``torch.save``) with the
   explicit tensors of the avatar ``real_setup`` builds there (125,664
   surfels) and an attribute field at the reference's widths (16 levels,
   16 to 2048, 2^18 rows, hidden 64) with random values, in the tcnn
   (packed fp16) and in the torch layout; per layout,
   ``reference_field_apply`` at every surfel on the card, timed, against
   the CPU on 4,096 points (1e-5); ``cli.train --config
   configs/surfel_stage0.yaml --import-ckpt <tcnn file> --steps 4
   --guidance imagedream --mock-guidance --sds-start 0 --trace-steps 1``,
   counted (13 + 8 launches a step), a trace written; ``cli.render_rot
   --ckpt <tcnn file>``.  Before the kernels, ``[yaml config]`` reads both
   ``configs/*.yaml`` with the port's own YAML reader (no PyYAML here).
14. The GaussianDreamer system (``[dreamer]``): the bench scene padded to
   capacity 251,328, ``DreamerConfig``'s defaults (4 views at 256x256,
   K=96, surface off, sigmoid opacities: the main passes composite at
   C = 4), full-shape bf16 mock MVDream (text only); 6 steps, densify at
   steps 2 and 4 with a threshold taken from the run's statistics, prune
   at 5, counted (8 forward and 4 backward launches a step); alive after
   each ``maintain`` (grows, within capacity), no host sync and no CPU op
   in a loss step, a profiled step; a step's launches replayed and held
   against their plain versions; the kernel step against the plain one
   (f32 networks; loss 1e-3, gradients 2e-3); a gradient on the opacity
   logits; dead slots never counted visible; everything finite.
15. Preprocessing (``[preprocess]``, :func:`run_preprocess`): a mock
   SMPL-X body (``make_test_body(55, 4, 48)`` widened and dressed with
   landmark tables, 10,608 vertices) written as an ``.npz``; a 20-frame
   512x512 capture of it rendered from its mesh; OpenPose and SMPLer-X
   outputs made from its parameters; ``compute_kp_and_mask --mask-backend
   sam`` with a mock full ViT-H checkpoint; ``preprocess_custom`` with a
   mock full-shape ECON checkpoint (SMPLify and NormalNet normal maps,
   gated on the reprojection error, the pose, the PNGs, CPU ops and
   ``render_mesh`` card = CPU); the template fallback's IoU (>= 0.7);
   ``cli.train --dataroot`` on the result, 2 steps a stage, counted
   (13 + 8 launches a step).
16. Prints the wall seconds of each phase (``[time]``), a
   ``{"kernels": [...]}`` line (the block composites with the summed
   device ms and bound of their recorded main-path launches,
   ``main_path_ms`` and ``main_path_bound_ms``, and their launches per step
   or view of the counted runs, ``main_path_launches``), then
   as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line.  It needs CUDA and the repository's ``soar_tpu_torch`` package beside
it.  A JSON report also goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

H100_F32_FLOPS = 67e12  # non-tensor-core f32, H100 SXM data sheet (700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
SLICE_NT, SLICE_P, SLICE_K = 1024, 256, 96  # 512x512 render, 16x16 tiles, K=96
TRAIN_K = 64  # the training step's max_per_tile (cli.train's default)
NUM_VIEWS = 2
KERNEL_TOL = 1e-4  # |kernel - plain| per element (accum values are O(1))
KERNEL_FLIP_SHARE = 0.01  # pixels allowed a T-cutoff flip (see composite.py)
# The backward's gfeat entries, relative to their column's largest
# magnitude: at most 0.1% beyond KERNEL_TOL (a pixel whose stop slot flips
# moves one slot's sum over 256 pixels; none flipped at these seeds), and
# none beyond 1e-2, so an off-by-one slot cannot hide in the allowance.
BWD_FLIP_SHARE = 1e-3
BWD_CAP = 1e-2
# Per pixel-slot operation counts of the composite, for the bound: an
# evaluated slot costs offsets, power, exp, clamp, the skip tests and the
# T update (19); a blended slot adds w = a*T, C channel FMAs and corr (2C+6).
OPS_PER_EVAL = 19
# composite_block's alpha clamp, alpha_min and t_min, as the paths pass them.
COMPOSITE_CONSTS = (0.99, 1.0 / 255.0, 1e-4)
# A blended slot of the tile composite: w = a*T, six colour and normal FMAs,
# the plane-corrected depth (dx*e0 + dy*e1 and the subtraction: 4) and its
# FMA.  The plane's coefficients e are formed once per slot that is read (two
# products and a sum each), as the plain version and composite_fwd's caller
# form them; the kernel's own per-pixel du0/du1 form costs more and is not
# what the function needs.
TILES_OPS_PER_BLEND = 19
TILES_OPS_PER_SLOT = 6
# The largest |kernel - plain| allowed on any pixel of the tile composite: a
# pixel whose stop slot flips gains or loses one slot's weight a*T with T
# near 1e-4, far below this; a wrong slot or channel is O(1).
TILES_CAP = 1e-2
# Bytes of one slot of the tile lists: 23 floats (xy 2, conic 3, opacity,
# colour 3, normal 3, depth, jinv 10) and the valid byte.
TILES_BYTES_PER_SLOT = 93
PROBE_PIXELS = 4096
# Grid resolution of the full-width export; the export CLI's default is 128,
# cut here for the script's time (8x fewer grid points).
EXPORT_RESOLUTION = 64
# The backward walks every evaluated slot twice (2 * 19); a blended slot
# costs gw and the running sum in pass 1 (2C+7), and in pass 2 gw again,
# the prefix, S_k, dL/dalpha, the clamp and exp chain and the 8 + C
# per-slot gradients (3C+41); every slot some pixel of the tile blended
# adds its 8 + C sums over the tile's P pixels.
BWD_OPS_PER_BLEND_C = 5
BWD_OPS_PER_BLEND = 48
# Kernel-vs-plain gradients of one full-width step, as the relative L2
# difference per parameter leaf.  Both steps see the same state and draws;
# what differs: a pixel whose T crosses the 1e-4 cutoff between the
# kernel's sequential product and the plain cumprod takes another stop
# slot (the kernel tests allow 1% of pixels), the packed gather's backward
# is an atomic scatter-add whose order changes from run to run, and the
# hash tables' cotangents are scatter-added in bf16 (the bf16 gather copy
# the JAX package also has).  So 1e-2 for the hash tables, 2e-3 elsewhere.
STEP_GRAD_TOL = 2e-3
STEP_GRAD_TOL_BF16 = 1e-2
STEP_LOSS_RTOL = 1e-4


T_START = time.perf_counter()  # after the imports of torch and numpy
WALL_S = {}  # wall seconds per phase of this script, for the [time] line


class timed:
    """Adds the wall seconds of a ``with`` block to ``WALL_S[name]``."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        WALL_S[self.name] = WALL_S.get(self.name, 0.0) + time.perf_counter() - self.t0


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


# Device cycles the queue waits behind before a kernel_ms window: ~25 ms at
# the H100's clocks, longer than the host takes to enqueue a window's calls.
QUEUE_SLEEP_CYCLES = 50_000_000


def kernel_ms(fn, iters, warmup=3):
    """Device ms per call of ``fn`` run back to back.  The window's calls
    are queued behind a device-side sleep, so the events time the kernels
    and not the host's enqueue rate: a wrapper call costs ~20 us of host
    time, more than a composite takes on the renderer's real tile lists."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def card_info():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    from soar_tpu_torch import kernels

    nvcc = kernels.nvcc_version().strip().splitlines()[-1]
    try:
        import triton

        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    return {
        "nvidia_smi": smi,
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "python": sys.version.split()[0],
        "nvcc": nvcc,
        "triton": triton_v,
        "cutlass_headers": os.path.isdir("/usr/local/cutlass/include"),
    }


# ------------------------------------------------------------------ kernels


def composite_scene(C, seed, NT=SLICE_NT, K=SLICE_K):
    """The composite's inputs at a path's shapes: a square grid of NT 16x16
    tiles, K slots, ~15% invalid slots plus short tile runs, half the
    tiles saturating (opacity 0.9-1.0, so the T < 1e-4 stop fires)."""
    rng = np.random.RandomState(seed)
    P, tile = SLICE_P, 16
    side = int(round(NT ** 0.5))
    t_ar = np.arange(NT)
    origins = np.stack([(t_ar % side) * tile, (t_ar // side) * tile], -1).astype(np.float32)
    xy = origins[:, None, :] + rng.uniform(-4, tile + 4, (NT, K, 2))
    conic = np.zeros((NT, K, 3), np.float32)
    conic[..., 0] = rng.uniform(0.02, 0.3, (NT, K))
    conic[..., 2] = rng.uniform(0.02, 0.3, (NT, K))
    conic[..., 1] = rng.uniform(-0.02, 0.02, (NT, K))
    saturate = rng.rand(NT, 1) < 0.5
    opac = np.where(saturate, rng.uniform(0.9, 1.0, (NT, K)), rng.uniform(0.2, 0.9, (NT, K)))
    counts = np.where(rng.rand(NT) < 0.25, rng.randint(0, K, NT), K)
    valid = (np.arange(K)[None] < counts[:, None]) & (rng.rand(NT, K) > 0.15)
    attrs = rng.uniform(-1, 1, (NT, K, C))
    e = rng.uniform(-0.3, 0.3, (NT, K, 2))
    lx = np.tile(np.arange(tile), tile)
    ly = np.repeat(np.arange(tile), tile)
    pixf = np.stack([origins[:, None, 0] + lx[None], origins[:, None, 1] + ly[None]], -1)
    arrs = (xy, conic, opac, valid, attrs, e, pixf)
    return tuple(torch.from_numpy(np.asarray(a, bool if a is valid else np.float32)).cuda()
                 for a in arrs)


def walk_masks(args):
    """[NT, P, K] masks of the pixel-slot pairs this data makes the
    composite walk: evaluated (up to and including a pixel's early-stop
    slot, valid slots only) and blended (weight > 0)."""
    from soar_tpu_torch.render.composite import composite_weights, splat_alpha

    xy, conic, opac, valid, attrs, e, pixf = args
    K = valid.shape[1]
    d = xy[:, None] - pixf[:, :, None]
    alpha = splat_alpha(d, conic[:, None], opac[:, None], valid[:, None])
    w, _ = composite_weights(alpha)
    one_minus = 1.0 - alpha
    t_excl = torch.cat([torch.ones_like(alpha[..., :1]),
                        torch.cumprod(one_minus[..., :-1], -1)], -1)
    viol = (t_excl * one_minus) < 1e-4
    stop = torch.where(viol.any(-1), viol.float().argmax(-1), torch.full_like(viol[..., 0], K - 1, dtype=torch.long))
    walked = torch.arange(K, device=xy.device)[None, None] <= stop[..., None]
    return walked & valid[:, None], w > 0


def walk_counts(args):
    """The pairs of :func:`walk_masks` counted: evaluated, blended, and the
    (tile, slot) pairs some pixel blended."""
    evaluated, blended = walk_masks(args)
    return int(evaluated.sum()), int(blended.sum()), int(blended.any(1).sum())


def _bound(ops, nbytes):
    t_ops, t_bytes = ops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def composite_bound_ms(args, C):
    """Least time for this call: max(bytes / HBM rate, ops / f32 rate) with
    the pixel-slot pairs this data makes the kernel walk."""
    NT, K = args[3].shape
    P = args[6].shape[1]
    evals, blends, _ = walk_counts(args)
    out = _bound(evals * OPS_PER_EVAL + blends * (2 * C + 6),
                 4 * (NT * K * (9 + C) + NT * P * 2 + NT * P * (C + 2)))
    out.update(pairs_evaluated=evals, pairs_blended=blends)
    return out


def composite_bwd_bound_ms(args, C):
    """The backward's least time: it reads feat, pixf and the three
    cotangents once and writes gfeat once; its operations are two walks
    over the evaluated pairs, the gradient chain over the blended pairs and
    the per-slot pixel sums (the constants above)."""
    NT, K = args[3].shape
    P = args[6].shape[1]
    F = 9 + C
    evals, blends, slots = walk_counts(args)
    ops = (2 * evals * OPS_PER_EVAL + blends * (BWD_OPS_PER_BLEND_C * C + BWD_OPS_PER_BLEND)
           + slots * (F - 1) * P)
    out = _bound(ops, 4 * (2 * NT * K * F + NT * P * 2 + NT * P * (C + 2)))
    out.update(pairs_evaluated=evals, pairs_blended=blends, slots_blended=slots)
    return out


def gate_fwd(label, got, want):
    """The forward composite's gate, kernel ``got`` against plain ``want``
    (accum, corr, T): all finite, at most KERNEL_FLIP_SHARE of the pixels
    beyond KERNEL_TOL (a T-cutoff flip).  Returns the max |difference| per
    output and that share."""
    errs, share = {}, 0.0
    for g, w, name in zip(got, want, ("accum", "corr", "T")):
        check(bool(torch.isfinite(g).all()), f"{label}: kernel {name} not finite")
        diff = (g - w).abs()
        errs[name] = float(diff.max())
        per_pixel = diff.reshape(diff.shape[0], diff.shape[1], -1).amax(-1)
        share = max(share, float((per_pixel > KERNEL_TOL).float().mean()))
    check(share <= KERNEL_FLIP_SHARE,
          f"{label}: {share:.4%} of pixels differ from the plain version by > {KERNEL_TOL}")
    return errs, share


def gate_bwd(label, got, want):
    """The backward composite's gate on gfeat: finite, a zero ``valid``
    column; per column, the largest |kernel - plain| relative to the
    column's largest magnitude, at most BWD_FLIP_SHARE of the entries beyond
    KERNEL_TOL and none beyond BWD_CAP.  Returns the per-column relative
    errors, that share and the max |difference|."""
    check(bool(torch.isfinite(got).all()), f"{label}: gfeat not finite")
    check(bool((got[..., 6] == 0).all()), f"{label}: the valid column has a gradient")
    scale = want.abs().amax((0, 1))
    diff = (got - want).abs()
    rel = (diff.amax((0, 1)) / scale.clamp_min(1e-30)).tolist()
    share = float((diff > KERNEL_TOL * scale).float().mean())
    check(share <= BWD_FLIP_SHARE,
          f"{label}: {share:.4%} of gfeat entries beyond {KERNEL_TOL} x column max")
    check(max(rel) <= BWD_CAP, f"{label}: a gfeat entry beyond {BWD_CAP} x column max")
    return rel, share, float(diff.max())


def check_composite_kernel(C, seed):
    from soar_tpu_torch.render.block_composite import _launch_fwd, _pack, composite_block
    from soar_tpu_torch.render.composite import composite_block_plain

    args = composite_scene(C, seed)
    with torch.no_grad():
        got = composite_block(*args)
        torch.cuda.synchronize()
        want = composite_block_plain(*args)
    errs, share = gate_fwd(f"C={C}", got, want)
    with torch.no_grad():
        ms = cuda_ms(lambda: composite_block(*args), 200)
        # The kernel alone: without the wrapper's packing of the inputs (a
        # torch.cat) and its host time.
        feat = _pack(*args[:6]).contiguous()
        device_ms = kernel_ms(lambda: _launch_fwd(feat, args[6], *COMPOSITE_CONSTS), 200)
        plain_ms = cuda_ms(lambda: composite_block_plain(*args), 10)
    out = {"C": C, "max_abs_err": max(errs.values()), "err": errs,
           "share_beyond_tol": share, "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms}
    out.update(composite_bound_ms(args, C))
    print(f"[composite_fwd C={C}] max|kernel-plain| accum {errs['accum']:.3g} corr "
          f"{errs['corr']:.3g} T {errs['T']:.3g}; pixels beyond {KERNEL_TOL}: {share:.4%}; "
          f"kernel {ms:.4f} ms (device alone {device_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}); library call: none (no single "
          f"PyTorch op computes it)")
    return out


def check_composite_bwd_kernel(NT, C, seed):
    """composite_bwd against composite_block_bwd_plain at the training
    step's K: per gfeat column, the largest |kernel - plain| relative to
    the column's largest magnitude, held to KERNEL_TOL with BWD_FLIP_SHARE
    of the entries allowed beyond it, and every entry to BWD_CAP."""
    from soar_tpu_torch.render.block_composite import _launch_bwd, _pack, composite_block_bwd
    from soar_tpu_torch.render.composite import composite_block_bwd_plain

    args = composite_scene(C, seed, NT=NT, K=TRAIN_K)
    g = torch.Generator(device="cuda").manual_seed(seed)
    P = args[6].shape[1]
    cots = (torch.randn((NT, C, P), generator=g, device="cuda"),
            torch.randn((NT, P), generator=g, device="cuda"),
            torch.randn((NT, P), generator=g, device="cuda"))
    got = composite_block_bwd(*args, *cots)
    torch.cuda.synchronize()
    want = composite_block_bwd_plain(*args, *cots)
    rel, share, max_err = gate_bwd(f"bwd NT={NT} C={C}", got, want)
    check(torch.equal(composite_block_bwd(*args, *cots), got),
          f"bwd NT={NT} C={C}: two launches on the same inputs differ")
    ms = cuda_ms(lambda: composite_block_bwd(*args, *cots), 100)
    feat = _pack(*args[:6]).contiguous()
    device_ms = kernel_ms(lambda: _launch_bwd(feat, args[6], *cots, *COMPOSITE_CONSTS), 100)
    plain_ms = cuda_ms(lambda: composite_block_bwd_plain(*args, *cots), 5)
    out = {"NT": NT, "C": C, "K": TRAIN_K, "max_abs_err": max_err,
           "col_rel_err": rel, "share_beyond_tol": share, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms}
    out.update(composite_bwd_bound_ms(args, C))
    print(f"[composite_bwd NT={NT} C={C} K={TRAIN_K}] max|kernel-plain|/column max per gfeat "
          f"column {[f'{x:.2e}' for x in rel]} (valid column 0); entries beyond {KERNEL_TOL}: "
          f"{share:.4%}; two launches bit-equal; kernel {ms:.4f} ms (device alone {device_ms:.4f} "
          f"ms), plain {plain_ms:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}); library call: none (no single "
          f"PyTorch op computes the composite's backward)")
    return out


def record_launches(fn):
    """Runs ``fn`` once with block_composite's two launch functions wrapped
    (the package is not changed) and returns copies of the inputs of every
    composite_fwd launch ``(feat, pixf, alpha_clamp, alpha_min, t_min)`` and
    composite_bwd launch ``(feat, pixf, gacc, gcorr, gT, alpha_clamp,
    alpha_min, t_min)``, in launch order: the shapes and data the main path
    hands the kernels.  The cotangents are kept as the wrapper hands them to
    the kernel (float32, contiguous)."""
    from soar_tpu_torch.render import block_composite as bc

    fwd, bwd = [], []
    launch_fwd, launch_bwd = bc._launch_fwd, bc._launch_bwd

    def rec_fwd(feat, pixf, *consts):
        fwd.append((feat.detach().clone(), pixf.clone(), *consts))
        return launch_fwd(feat, pixf, *consts)

    def rec_bwd(feat, pixf, gacc, gcorr, gT, *consts):
        cots = tuple(g.detach().to(torch.float32).contiguous().clone() for g in (gacc, gcorr, gT))
        bwd.append((feat.detach().clone(), pixf.clone(), *cots, *consts))
        return launch_bwd(feat, pixf, gacc, gcorr, gT, *consts)

    bc._launch_fwd, bc._launch_bwd = rec_fwd, rec_bwd
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        bc._launch_fwd, bc._launch_bwd = launch_fwd, launch_bwd
    return fwd, bwd


def unpack_feat(feat, pixf):
    """The packed [NT, K, 9 + C] features as composite_block's arguments."""
    return (feat[..., 0:2], feat[..., 2:5], feat[..., 5], feat[..., 6] > 0.5,
            feat[..., 9:], feat[..., 7:9], pixf)


def replay_launches(label, fwd, bwd, iters=20):
    """Times every recorded launch again through its wrapper (device ms,
    :func:`kernel_ms`) and computes its bound on the same inputs; checks that
    two composite_bwd launches on the same inputs give bit-equal gfeat.
    Returns per kernel the sums over the launches, and each launch's shape
    and numbers."""
    from soar_tpu_torch.render import block_composite as bc

    out = {}
    for name, recs, launch, bound in (
            ("composite_fwd", fwd, bc._launch_fwd, composite_bound_ms),
            ("composite_bwd", bwd, bc._launch_bwd, composite_bwd_bound_ms)):
        if not recs:
            continue
        rows = []
        for rec in recs:
            feat, pixf = rec[0], rec[1]
            NT, K, F = feat.shape
            if name == "composite_bwd":
                check(torch.equal(launch(*rec), launch(*rec)),
                      f"{label}: two composite_bwd launches at NT={NT} K={K} differ")
            b = bound(unpack_feat(feat, pixf), F - 9)
            rows.append({"NT": NT, "K": K, "C": F - 9, "ms": kernel_ms(lambda: launch(*rec), iters),
                         "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                         "pairs_evaluated": b["pairs_evaluated"],
                         "tiles_with_a_valid_slot": int((feat[..., 6] > 0.5).any(1).sum())})
        out[name] = {"launches": len(rows), "ms": sum(r["ms"] for r in rows),
                     "bound_ms": sum(r["bound_ms"] for r in rows), "per_launch": rows}
        o = out[name]
        print(f"[main path {label}] {name}: {o['launches']} launches, {o['ms']:.4f} ms "
              f"(device, each launch replayed on its own inputs), bound {o['bound_ms']:.4f} ms; "
              + ("two launches bit-equal on each; " if name == "composite_bwd" else "")
              + "per launch (NT, K, C, tiles with a valid slot, ms, bound ms): "
              + ", ".join(f"({r['NT']}, {r['K']}, {r['C']}, {r['tiles_with_a_valid_slot']}, "
                          f"{r['ms']:.4f}, {r['bound_ms']:.4f})" for r in rows))
    return out


def tiles_scene(seed, NT=SLICE_NT, K=SLICE_K):
    """Synthetic gathered tile lists at the render's shapes, as
    ``composite_tiles`` takes them: the slots of ``composite_scene`` (half
    the tiles saturating, ~15% invalid slots) with colours, normals, sorted
    depths and a local homography per slot, and per-tile counts drawn over
    0..K."""
    xy, conic, opac, valid, attrs, e, pixf = composite_scene(7, seed, NT=NT, K=K)
    rng = np.random.RandomState(seed + 1000)
    depths = np.sort(rng.uniform(1, 4, (NT, K)), axis=-1).astype(np.float32)
    jinv = rng.uniform(-0.5, 0.5, (NT, K, 10)).astype(np.float32)
    slot_valid = rng.rand(NT, K) > 0.15
    counts = rng.randint(0, K + 1, NT).astype(np.int32)
    origins = pixf[:, 0, :].to(torch.int32)
    host = (depths, jinv, slot_valid, counts)
    return (xy, conic, opac, attrs[..., 0:3].contiguous(), attrs[..., 3:6].contiguous(),
            *(torch.from_numpy(a).cuda() for a in host), origins)


def as_block_args(lists, tile=16):
    """The tile lists as ``composite_block``'s arguments: the slot mask with
    the counts folded in, colour | normal | depth as the linear channels and
    the plane correction's coefficients ``e``."""
    from soar_tpu_torch.render.composite import depth_plane_coeffs, tile_pixel_centres

    xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts, origins = lists
    K = xy.shape[1]
    valid = slot_valid & (torch.arange(K, device=xy.device)[None] < counts[:, None])
    attrs = torch.cat([colors, normals, depths[..., None]], -1)
    return (xy, conic, opac, valid, attrs, depth_plane_coeffs(jinv),
            tile_pixel_centres(origins, tile))


def tiles_bound_ms(lists):
    """Least time for this call of the tile composite.  Operations: the
    pairs this data makes any implementation evaluate (per pixel, the valid
    slots below min(count, K) up to and including its stop slot) and blend.
    Bytes: each tile's slots up to the last one any of its pixels evaluates
    (no later slot has to be read), its count and origin, and the four
    outputs."""
    block = as_block_args(lists)
    NT, K = block[3].shape
    P = block[6].shape[1]
    evaluated, blended = walk_masks(block)
    evals, blends = int(evaluated.sum()), int(blended.sum())
    slot_seen = evaluated.any(1)  # [NT, K]
    k_ar = torch.arange(1, K + 1, device=slot_seen.device)
    read_per_tile = (slot_seen * k_ar).amax(1)
    slots_read = int(read_per_tile.sum())
    out = _bound(evals * OPS_PER_EVAL + blends * TILES_OPS_PER_BLEND
                 + slots_read * TILES_OPS_PER_SLOT,
                 slots_read * TILES_BYTES_PER_SLOT + NT * 12 + 4 * NT * P * 8)
    heaviest = int(read_per_tile.argmax())
    out.update(pairs_evaluated=evals, pairs_blended=blends, slots_read=slots_read,
               slots_below_count=int(torch.clamp(lists[8], 0, K).sum()),
               pairs_until_tile_exit=slots_read * P,
               # The tile whose pixels walk furthest: its slot bound (1 + its
               # last valid slot below the count) and the slots it walks.
               heaviest_tile_slot_bound=int((block[3] * k_ar).amax(1)[heaviest]),
               heaviest_tile_walked=int(read_per_tile[heaviest]))
    return out


def compare_tiles(label, got, want, names=("color", "normal", "depth", "T")):
    """max |got - want| per output, held to TILES_CAP, and the share of
    pixels beyond KERNEL_TOL, gated at KERNEL_FLIP_SHARE (the forward
    composite's gate).  The share is taken over the pixels some splat
    touches (T < 1 in either result): a view whose body fills a few tiles
    leaves every other pixel at zeros and T = 1 whatever the kernel does.
    Returns the errors, the share and the number of touched pixels."""
    touched = (got[3] < 1) | (want[3] < 1)  # [NT, P]
    n_touched = int(touched.sum())
    errs, share = {}, 0.0
    for g, w, name in zip(got, want, names):
        check(g.shape == w.shape, f"{label}: {name} shape {tuple(g.shape)}")
        check(bool(torch.isfinite(g).all()), f"{label}: {name} not finite")
        diff = (g - w).abs()
        errs[name] = float(diff.max())
        per_pixel = diff.reshape(diff.shape[0], diff.shape[1], -1).amax(-1)
        check(bool((per_pixel[~touched] == 0).all()),
              f"{label}: {name} differs on a pixel no splat touches")
        if n_touched:
            share = max(share, float((per_pixel[touched] > KERNEL_TOL).float().mean()))
    check(share <= KERNEL_FLIP_SHARE,
          f"{label}: {share:.4%} of the {n_touched} touched pixels differ by > {KERNEL_TOL}")
    check(max(errs.values()) <= TILES_CAP,
          f"{label}: largest difference {max(errs.values()):.3g} > {TILES_CAP}")
    return errs, share, n_touched


def check_composite_tiles(label, lists, vs_fwd=False):
    """composite_tiles against composite_tiles_plain on the card and, with
    ``vs_fwd``, against composite_fwd's accumulations on the same lists;
    times the kernel and the plain version and computes the bound."""
    from soar_tpu_torch.render.block_composite import composite_block
    from soar_tpu_torch.render.composite import composite_tiles_plain
    from soar_tpu_torch.render.tiles_composite import composite_tiles

    tag = f"[composite_tiles {label}]"
    got = composite_tiles(*lists)
    again = composite_tiles(*lists)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{label}: two launches of composite_tiles differ")
    want = composite_tiles_plain(*lists)
    errs, share, touched = compare_tiles(f"{label}: kernel vs plain", got, want)
    empty = torch.clamp(lists[8], 0) == 0
    check(bool((got[3][empty] == 1).all()) and bool((got[0][empty] == 0).all()),
          f"{label}: a tile with count 0 is not empty")
    out = {"max_abs_err": max(errs.values()), "err": errs, "share_beyond_tol": share,
           "touched_pixels": touched, "NT": int(lists[0].shape[0]), "K": int(lists[0].shape[1]),
           "tiles_with_count_0": int(empty.sum()),
           "tiles_with_count_above_K": int((lists[8] > lists[0].shape[1]).sum())}
    if vs_fwd:
        with torch.no_grad():
            accum, corr, T = composite_block(*as_block_args(lists))
        fwd = (accum[..., 0:3], accum[..., 3:6], accum[..., 6] - corr, T)
        errs_f, share_f, _ = compare_tiles(f"{label}: kernel vs composite_fwd", got, fwd)
        # The same operations in the same order per pixel: colour, normal and
        # T to the bit (the depth's plane correction is associated otherwise).
        check(all(torch.equal(got[i], fwd[i]) for i in (0, 1, 3)),
              f"{label}: colour, normal or T differ from composite_fwd's")
        out.update(vs_fwd_err=errs_f, vs_fwd_share_beyond_tol=share_f)
        print(f"{tag} max|composite_tiles - composite_fwd accumulations| "
              + ", ".join(f"{k} {v:.3g}" for k, v in errs_f.items())
              + f"; of {touched} touched pixels beyond {KERNEL_TOL}: {share_f:.4%}")
    out["ms"] = cuda_ms(lambda: composite_tiles(*lists), 200)
    out["plain_ms"] = cuda_ms(lambda: composite_tiles_plain(*lists), 10)
    # The kernel alone on the device timeline; ``ms`` above is the wrapper's
    # call, with its host work.  The wrapper reads the lists as they come,
    # so a call is one device op: the kernel.
    # The profiler (CUPTI) now and then records none of a window's kernels
    # (seen once in ~12 runs); a window is profiled again, up to twice more,
    # only when it lacks some of its own 10 launches.
    for _ in range(3):
        prof = profile_view(lambda: [composite_tiles(*lists) for _ in range(10)])
        if prof["composite_tiles_kernels"] == 10:
            break
    check(prof["composite_tiles_kernels"] == 10,
          f"{label}: the profiler saw {prof['composite_tiles_kernels']} of 10 composite_tiles "
          "kernels in three windows")
    out["device_ms"] = prof["composite_tiles_ms"] / 10
    out["wrapper_device_ops"] = prof["device_kernels"] / 10
    check(out["wrapper_device_ops"] == 1,
          f"{label}: {out['wrapper_device_ops']} device ops per composite_tiles call, want 1")
    out.update(tiles_bound_ms(lists))
    out["ns_per_slot_heaviest"] = 1e6 * out["device_ms"] / max(out["heaviest_tile_walked"], 1)
    print(f"{tag} NT={out['NT']} K={out['K']}, {out['tiles_with_count_0']} tiles with count 0, "
          f"{out['tiles_with_count_above_K']} above K; max|kernel-plain| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; of {touched} touched pixels beyond {KERNEL_TOL}: {share:.4%} (largest allowed "
          f"{TILES_CAP}); kernel {out['ms']:.4f} ms per call of "
          f"the wrapper ({out['wrapper_device_ops']:g} device ops, the kernel alone "
          f"{out['device_ms']:.4f} ms by the profiler), plain {out['plain_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms ({out['bound_by']}: "
          f"{out['pairs_evaluated']} pairs evaluated, {out['pairs_blended']} blended, "
          f"{out['slots_read']} of {out['slots_below_count']} slots below the counts read, "
          f"{out['pairs_until_tile_exit']} pairs until the tiles' exits); heaviest tile: "
          f"slot bound {out['heaviest_tile_slot_bound']}, {out['heaviest_tile_walked']} slots "
          f"walked, {out['ns_per_slot_heaviest']:.1f} ns of the kernel per walked slot; "
          f"library call: none (no single PyTorch op computes it)")
    return out


# -------------------------------------------------------------- the slice


def slice_scene(device):
    """The repo's production bench scene (bench_trainstep.build_scene):
    procedural body 10 joints x 7 segments x 28 ring, 3 subdivisions,
    16-level 2^18 hash field; dataset camera = bench.py's (identity c2w,
    fov 0.7 rad, 512x512)."""
    from soar_tpu_torch.avatar.state import init_avatar
    from soar_tpu_torch.body.model import make_test_body
    from soar_tpu_torch.data.dataset import AvatarDataset
    from soar_tpu_torch.field.attribute_field import AttributeFieldConfig
    from soar_tpu_torch.field.hashgrid import HashGridConfig

    body = make_test_body(num_joints=10, segments_per_bone=7, ring=28, device=device)
    F = 8
    rng = np.random.RandomState(0)
    sp = {
        "betas": np.zeros((1, body.num_betas), np.float32),
        "body_pose": (rng.randn(F, (body.num_joints - 1) * 3) * 0.05).astype(np.float32),
        "global_orient": np.zeros((F, 3), np.float32),
        "transl": np.tile([[0.0, 0.9, -2.8]], (F, 1)).astype(np.float32),
    }
    fc = AttributeFieldConfig(grid=HashGridConfig(
        num_levels=16, min_res=16, max_res=2048, log2_hashmap_size=18))
    params, model = init_avatar(body, sp, num_subdiv=3, field_cfg=fc,
                                distill_steps=0, device=device)
    size = 512
    focal = size / (2.0 * np.tan(0.7 / 2.0))
    K = np.array([[focal, 0, size / 2], [0, focal, size / 2], [0, 0, 1]], np.float32)
    Ks = np.tile(K[None], (F, 1, 1))
    ds = AvatarDataset(
        images=np.zeros((1, size, size, 3), np.float32),
        masks=np.zeros((1, size, size), np.float32),
        normal_F=np.zeros((0,)), normal_B=np.zeros((0,)), normal_mask=np.zeros((0,)),
        images_crop=np.zeros((0,)), masks_crop=np.zeros((0,)),
        smpl_params=sp, w2c=np.eye(4, dtype=np.float32), Ks=Ks, normal_Ks=Ks.copy(),
        train_idx=list(range(F)), val_idx=[], test_idx=[],
    )
    return ds, params, model


def profile_view(render):
    """Device time by kernel over one call of ``render`` (a view or a
    training step; torch.profiler / CUPTI): only device-side events are
    summed, so an aten op and the kernel it launched are not counted
    twice.  A ``record_function`` range (``Optimizer.step#Adam.step``) is
    mirrored on the device timeline over the kernels it launched; it is
    left out too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    host_keys = {ev.key for ev in events if ev.device_type == DeviceType.CPU}
    rows = sorted(
        ((ev.self_device_time_total / 1e3, ev.count, ev.key) for ev in events
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
         and ev.key not in host_keys),
        reverse=True,
    )
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": sum(r[0] for r in rows),
        "device_kernels": sum(r[1] for r in rows),
        "composite_fwd_ms": sum(r[0] for r in rows if "composite_fwd" in r[2]),
        "composite_bwd_ms": sum(r[0] for r in rows if "composite_bwd" in r[2]),
        "composite_tiles_ms": sum(r[0] for r in rows if "composite_tiles" in r[2]),
        "composite_tiles_kernels": sum(r[1] for r in rows if "composite_tiles" in r[2]),
        "top": [{"ms": r[0], "calls": r[1], "name": r[2][:90]} for r in rows[:15]],
    }


def host_ops(fn):
    """Runs ``fn`` and returns the aten ops that produced a tensor on the
    CPU, by name and count (device transfers and literal tensors that go
    straight to the card are listed apart), plus the number of aten ops and
    of host syncs (a device scalar read on the host)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    transfers = ("lift_fresh", "_to_copy", "copy_", "detach", "alias")

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.compute, self.moves = Counter(), Counter()
            self.ops = self.syncs = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops += 1
            self.syncs += "_local_scalar_dense" in str(func)
            if any(isinstance(t, torch.Tensor) and t.device.type == "cpu"
                   for t in tree_flatten(out)[0]):
                name = str(func)
                (self.moves if name.split(".")[1] in transfers else self.compute)[name] += 1
            return out

    rec = Record()
    with rec:
        fn()
    return dict(rec.compute), dict(rec.moves), rec.ops, rec.syncs


def layer_ms(params, model, cam, bg, ov):
    """Time per call of each layer under render_view, at the slice's view."""
    import dataclasses

    from soar_tpu_torch.avatar.renderer import RenderSettings, posed_gaussians
    from soar_tpu_torch.render.preprocess import preprocess
    from soar_tpu_torch.render.tiled import bin_and_sort, rasterize_with_occ

    size = (512, 512)
    st = RenderSettings()
    cfg = dataclasses.replace(st.raster, render_front=False, sort_descending=False)
    g, occ = posed_gaussians(params, model, 0, st, smpl_override=ov)
    pre = preprocess(g, cam, size, cfg)
    return {
        "posed_gaussians": cuda_ms(lambda: posed_gaussians(params, model, 0, st, smpl_override=ov), 10),
        "preprocess": cuda_ms(lambda: preprocess(g, cam, size, cfg), 10),
        "bin_and_sort": cuda_ms(lambda: bin_and_sort(pre, size, cfg), 10),
        "rasterize_with_occ": cuda_ms(lambda: rasterize_with_occ(g, occ, cam, size, bg, cfg), 10),
    }


def slice_views(ds, params, model, device):
    """The two cameras every per-view check uses, and the pose override
    they render with: bench.py's camera and one that frames the body."""
    from soar_tpu_torch.cli.render_rot import gt_camera
    from soar_tpu_torch.core.transforms import rotmat_to_rotvec

    ov = {"global_orient": rotmat_to_rotvec(torch.eye(3, device=device))}
    return {"bench": gt_camera(ds, 0, device),
            "framed": framed_camera(params, model, ov, device)}, ov


def run_slice(ds, params, model, views, ov, device):
    from soar_tpu_torch.cli.render_rot import run_turntable
    from soar_tpu_torch.render import block_composite

    N = params.xyz.shape[0]

    # ---- the main path, counted: launch counters 0 just before, read after
    with tempfile.TemporaryDirectory() as out_dir:
        block_composite.composite_block.launches = 0
        t0 = time.perf_counter()
        outs = run_turntable(out_dir, ds, params, model, False, NUM_VIEWS, device=device)
        torch.cuda.synchronize()
        turntable_s = time.perf_counter() - t0
        launches = block_composite.composite_block.launches
        pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    check(launches == 2 * NUM_VIEWS,
          f"composite kernel launched {launches} times, want {2 * NUM_VIEWS}")
    check(len(pngs) == 4 * NUM_VIEWS, f"wrote {len(pngs)} pngs")
    shapes = {"render": (512, 512, 3), "normal": (512, 512, 3), "depth": (512, 512),
              "mask": (512, 512), "occ": (512, 512, 3), "curv": (512, 512),
              "pred_normal": (512, 512, 3)}
    overflow, coverage = [], []
    for i, out in enumerate(outs):
        for k, shape in shapes.items():
            v = out[k]
            check(v.device.type == "cuda", f"view {i} {k} on {v.device}")
            check(tuple(v.shape) == shape, f"view {i} {k} shape {tuple(v.shape)}")
            check(bool(torch.isfinite(v).all()), f"view {i} {k} not finite")
        # bench.py's camera frames only the root end of the 2.5 m chain
        # body (~0.1% of the pixels): require some coverage, not a share.
        cover_px = int((out["mask"] > 0.5).sum())
        check(cover_px >= 100, f"view {i}: mask covers only {cover_px} pixels")
        coverage.append(cover_px)
        overflow.append([int(x) for x in out["overflow"].cpu()])
    print(f"[slice] run_turntable {NUM_VIEWS} views: {turntable_s:.3f} s incl. png "
          f"writes; composite launches {launches}; overflow [dropped, capped] per "
          f"view {overflow}; mask>0.5 pixels per view {coverage}")

    # ---- per-view time and kernel vs plain, at bench.py's camera and at
    # one that frames the whole body (not counted)
    reports = {label: view_report(label, params, model, cam, ov)
               for label, cam in views.items()}
    return {
        "surfels": N, "turntable_s": turntable_s, "launches": launches,
        "overflow": overflow, "mask_pixels": coverage, "views": reports,
    }


def framed_camera(params, model, ov, device):
    """A camera that frames the whole posed body of frame 0: c2w without
    rotation (looking down -z, as bench.py's), fov 0.7 rad, backed off from
    the body's box until its x and y extent fit with a 10% margin.  The
    turntable turns the body about y, its long axis, so it stays framed."""
    from soar_tpu_torch.avatar.renderer import RenderSettings, posed_gaussians
    from soar_tpu_torch.core.camera import camera_from_c2w

    with torch.no_grad():
        xyz = posed_gaussians(params, model, 0, RenderSettings(), smpl_override=ov)[0].means3d
    lo, hi = xyz.amin(0), xyz.amax(0)
    half = (hi - lo) / 2
    c2w = torch.eye(4, device=device)
    c2w[:3, 3] = (lo + hi) / 2
    c2w[2, 3] += 1.1 * float(half[:2].max()) / np.tan(0.35) + float(half[2])
    return camera_from_c2w(c2w, 0.7, 0.7, znear=0.1, zfar=100.0,
                           prcppoint=torch.tensor([0.5, 0.5], device=device))


def view_fn(params, model, cam, ov, composite="kernel"):
    """One turntable view at ``cam`` (white background, frame 0), with the
    kernel composite or the plain one, as a function of no arguments."""
    from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
    from soar_tpu_torch.render.types import RasterConfig

    bg = torch.ones(3, device=cam.w2c.device)
    st = RenderSettings(raster=RasterConfig(composite=composite))
    return lambda: render_view(params, model, cam, (512, 512), bg, 0, st, smpl_override=ov)


def view_report(label, params, model, cam, ov):
    """ms per view with the kernel and with the plain composite, the view's
    kernel-vs-plain difference, its device profile, host ops and layers."""
    bg = torch.ones(3, device=cam.w2c.device)

    def view(composite):
        return view_fn(params, model, cam, ov, composite)

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        ms_view = cuda_ms(view("kernel"), 10)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        ms_view_plain = cuda_ms(view("plain"), 5)
        got, want = view("kernel")(), view("plain")()
        diffs = {k: float((got[k] - want[k]).abs().max()) for k in ("render", "normal", "mask", "occ")}
        inner = want["mask"] > 0.5
        cover_px = int(inner.sum())
        diffs["depth_in_mask"] = float((got["depth"][inner] - want["depth"][inner]).abs().max())
        # The composite only shows where the body is: the share is taken
        # over the covered pixels, of the worst of render and normal.
        px_diff = torch.maximum((got["render"] - want["render"]).abs().amax(-1),
                                (got["normal"] - want["normal"]).abs().amax(-1))
        px_share = float((px_diff[inner] > KERNEL_TOL).float().mean())
        overflow = [int(x) for x in got["overflow"].cpu()]
        prof = profile_view(view("kernel"))
        cpu_compute, cpu_moves, n_ops, n_syncs = host_ops(view("kernel"))
        layers = layer_ms(params, model, cam, bg, ov)
    tag = f"[view {label}]"
    check(cover_px >= 100, f"{label} view: mask covers only {cover_px} pixels")
    check(not cpu_compute, f"{label} view: render_view computed on the CPU: {cpu_compute}")
    print(f"{tag} {cover_px} of {512 * 512} pixels mask>0.5; overflow [dropped, capped] "
          f"{overflow}; {n_ops} aten ops, {n_syncs} host syncs, none computed on the CPU; "
          f"ops with a CPU result (transfers) {cpu_moves}")
    check(px_share <= KERNEL_FLIP_SHARE,
          f"{label} view: {px_share:.4%} of covered pixels differ from plain by > {KERNEL_TOL}")
    print(f"{tag} render_view: {ms_view:.3f} ms/view (kernel), {ms_view_plain:.3f} ms/view "
          f"(plain composite); max|kernel-plain| {diffs}; covered pixels beyond "
          f"{KERNEL_TOL}: {px_share:.4%}")
    busy = prof["device_busy_ms"]
    check(busy > 0 and prof["composite_fwd_ms"] > 0, "the profiler saw no device time")
    # ms_view is the steady-state time of one view among back-to-back
    # renders; the device idles for the part of it no device op covers.
    prof["idle_share"] = 1.0 - busy / ms_view
    print(f"{tag} profile: device busy {busy:.3f} ms in {prof['device_kernels']} device ops "
          f"(composite_fwd {prof['composite_fwd_ms']:.4f} ms, {prof['composite_fwd_ms'] / busy:.4f} "
          f"of busy), idle share {prof['idle_share']:.4f} of {ms_view:.3f} ms; profiled wall "
          f"{prof['profiled_wall_ms']:.3f} ms; peak memory {peak_gib:.3f} GiB")
    for row in prof["top"]:
        print(f"    {row['ms']:9.4f} ms  x{row['calls']:<5d} {row['name']}")
    print(f"{tag} layers, ms per call (CUDA events, back to back): "
          + ", ".join(f"{k} {v:.3f}" for k, v in layers.items()))
    return {
        "mask_pixels": cover_px, "overflow": overflow, "ms_per_view": ms_view,
        "ms_per_view_plain": ms_view_plain, "kernel_vs_plain": diffs,
        "covered_px_share_beyond_tol": px_share, "profile": prof,
        "cpu_transfers_per_view": cpu_moves, "aten_ops_per_view": n_ops,
        "host_syncs_per_view": n_syncs, "peak_memory_gib": peak_gib, "layer_ms": layers,
    }


VIEW_SIZE = (512, 512)


def view_tile_raster():
    """The main pass's raster settings of a turntable view, front to back."""
    import dataclasses

    from soar_tpu_torch.avatar.renderer import RenderSettings

    st = RenderSettings()
    return st, dataclasses.replace(st.raster, render_front=False, sort_descending=False)


def view_tile_lists(params, model, cam, ov):
    """The gathered tile lists of one view (125,664 surfels, 512x512,
    K=96) as the rasterizer gathers them: ``(lists, (ntx, nty),
    overflow)``, the lists in ``composite_tiles``' argument order."""
    from soar_tpu_torch.avatar.renderer import posed_gaussians
    from soar_tpu_torch.render.preprocess import preprocess
    from soar_tpu_torch.render.tiled import gather_tile_lists

    st, cfg = view_tile_raster()
    with torch.no_grad():
        g, _ = posed_gaussians(params, model, 0, st, smpl_override=ov)
        return gather_tile_lists(preprocess(g, cam, VIEW_SIZE, cfg), VIEW_SIZE, cfg)


def run_tile_lists(params, model, views, ov):
    """The count-bounded tile composite on the real tile lists of the
    views (125,664 surfels, 512x512, K=96): gathered as the rasterizer
    gathers them, composited by the kernel with its launch counter set to 0
    just before and read just after, assembled to an image; then, not
    counted, held against the plain version and against composite_fwd's
    accumulations on the same lists, and timed."""
    from soar_tpu_torch.render import tiles_composite
    from soar_tpu_torch.render.composite import finalize_accum
    from soar_tpu_torch.render.tilegrid import untile

    size = VIEW_SIZE
    _, cfg = view_tile_raster()
    bg = torch.ones(3, device="cuda")
    all_lists, images = {}, {}
    tiles_composite.composite_tiles.launches = 0
    with torch.no_grad():
        for label, cam in views.items():
            lists, (ntx, nty), overflow = view_tile_lists(params, model, cam, ov)
            accum = tiles_composite.composite_tiles(*lists, tile=cfg.tile)
            color, normal, depth, opac, _ = finalize_accum(*accum, bg, cfg.normalize_depth)
            images[label] = {"render": untile(color, 3, ntx, nty, cfg.tile, *size),
                             "mask": untile(opac[..., None], 1, ntx, nty, cfg.tile, *size)[..., 0],
                             "overflow": [int(x) for x in overflow.cpu()]}
            all_lists[label] = lists
    torch.cuda.synchronize()
    launches = tiles_composite.composite_tiles.launches
    check(launches == len(views), f"composite_tiles launched {launches} times, want {len(views)}")

    reports = {}
    with torch.no_grad():
        for label, lists in all_lists.items():
            img = images[label]
            check(bool(torch.isfinite(img["render"]).all()), f"tile lists {label}: image not finite")
            cover_px = int((img["mask"] > 0.5).sum())
            check(cover_px >= 100, f"tile lists {label}: mask covers only {cover_px} pixels")
            rep = check_composite_tiles(f"{label} view", lists, vs_fwd=True)
            rep.update(mask_pixels=cover_px, overflow=img["overflow"])
            reports[label] = rep
    return {"launches": launches, "views": reports}


def run_oracle_probe(params, model, views, ov):
    """The truncation probe of bench_trainstep.py on the card: the tiled
    render (kernel composite) against the exact oracle at PROBE_PIXELS
    seeded pixels, colour and normal PSNR inside the oracle's silhouette.
    The PSNR is reference behaviour (the bounded-K renderer is a measured
    approximation of the oracle) and is not gated; the probe must run on
    the card, cover the body in the framed view and be finite."""
    from soar_tpu_torch.avatar.renderer import RenderSettings, posed_gaussians
    from soar_tpu_torch.render.oracle import rasterize_oracle_at
    from soar_tpu_torch.render.tiled import rasterize
    from soar_tpu_torch.render.types import RasterConfig

    size = (512, 512)
    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randint(0, size[1], PROBE_PIXELS)).cuda()
    ys = torch.from_numpy(rng.randint(0, size[0], PROBE_PIXELS)).cuda()
    pix = torch.stack([xs, ys], -1).float()
    bg = torch.zeros(3, device="cuda")
    rasters = {"K=64": RasterConfig(max_per_tile=64, dup_side=5), "K=96": RasterConfig()}

    def psnr(a, b, m):
        """None where the silhouette holds no probe pixel; inf when equal."""
        if not bool(m.any()):
            return None
        mse = float(torch.mean((a[m] - b[m]) ** 2))
        return float("inf") if mse == 0 else 10.0 * float(np.log10(1.0 / mse))

    reports = {}
    with torch.no_grad():
        for label, cam in views.items():
            g, _ = posed_gaussians(params, model, 0, RenderSettings(), smpl_override=ov)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            o_color, o_normal, _, o_opac, _ = rasterize_oracle_at(g, cam, size, bg, pix, rasters["K=96"])
            torch.cuda.synchronize()
            oracle_s = time.perf_counter() - t0
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
            check(o_color.is_cuda, f"probe {label}: the oracle's output is_cuda is False")
            check(bool(torch.isfinite(o_color).all()) and bool(torch.isfinite(o_normal).all()),
                  f"probe {label}: oracle not finite")
            m = o_opac > 1e-3  # inside the oracle's silhouette
            rep = {"probe_pixels": int(m.sum()), "oracle_s": oracle_s, "oracle_peak_gib": peak_gib}
            for name, raster in rasters.items():
                out = rasterize(g, cam, size, bg, raster)
                t_color, t_normal = out.color[ys, xs], out.normal[ys, xs]
                check(bool(torch.isfinite(t_color).all()), f"probe {label} {name}: tiled not finite")
                rep[name] = {"color_psnr": psnr(t_color, o_color, m),
                             "normal_psnr": psnr((t_normal + 1) / 2, (o_normal + 1) / 2, m),
                             "overflow": [int(x) for x in out.overflow.cpu()]}
            rep["probe_s"] = time.perf_counter() - t0
            reports[label] = rep
            print(f"[oracle {label}] {PROBE_PIXELS} seeded pixels, {rep['probe_pixels']} inside the "
                  f"oracle's silhouette; oracle {oracle_s:.3f} s (peak {peak_gib:.3f} GiB), probe "
                  f"{rep['probe_s']:.3f} s; tiled vs oracle PSNR dB (colour, normal) and overflow "
                  f"[dropped, capped]: " + "; ".join(
                      f"{k} {rep[k]['color_psnr']}, {rep[k]['normal_psnr']}, {rep[k]['overflow']}"
                      for k in rasters))
    check(reports["framed"]["probe_pixels"] >= 20,
          f"probe: only {reports['framed']['probe_pixels']} probe pixels on the framed body")
    for name in rasters:
        v = reports["framed"][name]
        check(v["color_psnr"] is not None and not np.isnan(v["color_psnr"])
              and not np.isnan(v["normal_psnr"]), f"probe framed {name}: PSNR {v}")
    return reports


# ----------------------------------------------------------- the training


def train_dataset(ds_turntable):
    """bench_trainstep.build_scene's dataset: its RandomState(0) draws after
    the body pose (8 frames of 512x512 random RGB, masks, front and back
    normal maps, normal masks and crops), focal 600, identity extrinsics."""
    from soar_tpu_torch.data.dataset import AvatarDataset

    sp = ds_turntable.smpl_params
    F, H = sp["body_pose"].shape[0], 512
    rng = np.random.RandomState(0)
    rng.randn(*sp["body_pose"].shape)  # the body pose, drawn first
    f32 = np.float32
    images = rng.rand(F, H, H, 3).astype(f32)
    masks = (rng.rand(F, H, H) > 0.5).astype(f32)
    normal_F = rng.rand(F, 512, 512, 3).astype(f32)
    normal_B = rng.rand(F, 512, 512, 3).astype(f32)
    normal_mask = (rng.rand(F, 512, 512) > 0.5).astype(f32)
    images_crop = rng.rand(F, 512, 512, 3).astype(f32)
    masks_crop = (rng.rand(F, 512, 512) > 0.5).astype(f32)
    K = np.array([[600.0, 0, H / 2], [0, 600.0, H / 2], [0, 0, 1]], f32)
    return AvatarDataset(
        images=images, masks=masks, normal_F=normal_F, normal_B=normal_B,
        normal_mask=normal_mask, images_crop=images_crop, masks_crop=masks_crop,
        smpl_params=sp, w2c=np.eye(4, dtype=f32), Ks=np.tile(K[None], (F, 1, 1)),
        normal_Ks=np.tile(K[None], (F, 1, 1)), train_idx=list(range(F)), val_idx=[],
        test_idx=[],
    )


TRAIN_STEPS, WARMUP_STEPS = 5, 2
TRAIN_SIZES = dict(gen_size=(256, 256), gt_size=(512, 512), normal_size=(512, 512))
FWD_PER_STEP = 13  # 4 gen views x (main + occ), GT main + occ, normal front + back + occ
BWD_PER_STEP = 8  # 4 gen mains, GT main + occ, normal front + back (see PERF.md)
CHANGING_GROUPS = {"xyz", "rotation", "occ", "field", "field_scales"}


def train_setup(ds, params, model, device, lpips_fn):
    """The full-width guidance-free training step (bench_trainstep.py's
    production step): stage 0, 4 gen views at 256x256, GT and normal passes
    at 512x512, K=64, the attribute field, the normal-LPIPS terms through
    ``lpips_fn`` (bf16 VGG16).  Returns its config, state, optimizer, step,
    GT batches, the draws' generators and ``one_step()``, which draws and
    runs one step."""
    from types import SimpleNamespace

    from soar_tpu_torch.render.types import RasterConfig
    from soar_tpu_torch.train.config import StageConfig, TrainConfig
    from soar_tpu_torch.train.trainer import (
        init_train_state,
        make_gt_batch,
        make_train_step,
        sample_step_draws,
    )

    cfg = TrainConfig(n_views=4, head_prob=0.0)
    stage = StageConfig()
    raster = RasterConfig(max_per_tile=TRAIN_K, dup_side=5, composite_dtype="bf16")
    sizes = dict(TRAIN_SIZES)
    state, opt = init_train_state(params, cfg, stage=stage)
    step = make_train_step(model, cfg, stage, opt, raster=raster, use_explicit=False,
                           has_normals=True, lpips_fn=lpips_fn, **sizes)
    with timed("train: GT batches"):
        batches = [make_gt_batch(ds, model, f, device) for f in ds.train_idx]
    gen = torch.Generator(device=device).manual_seed(0)
    frames = np.random.RandomState(1)

    def one_step():
        draws = sample_step_draws(gen, cfg)
        return step(state, batches[frames.randint(len(batches))], draws)

    return SimpleNamespace(cfg=cfg, stage=stage, raster=raster, sizes=sizes, state=state,
                           opt=opt, step=step, batches=batches, gen=gen, frames=frames,
                           one_step=one_step, lpips_fn=lpips_fn)


def run_training(ds, params, model, device, lpips_path):
    """Drives and checks the training step of :func:`train_setup`, with the
    LPIPS weights of ``lpips_path``."""
    import dataclasses

    from soar_tpu_torch.render import block_composite
    from soar_tpu_torch.train.lpips import make_lpips_fn
    from soar_tpu_torch.train.trainer import make_train_step, sample_step_draws

    lpips16 = make_lpips_fn(lpips_path, dtype=torch.bfloat16, device=device)
    lpips32 = make_lpips_fn(lpips_path, dtype=torch.float32, device=device)
    ts = train_setup(ds, params, model, device, lpips16)
    cfg, stage, raster, sizes, state, opt, step = (
        ts.cfg, ts.stage, ts.raster, ts.sizes, ts.state, ts.opt, ts.step)
    batches, gen, frames, one_step = ts.batches, ts.gen, ts.frames, ts.one_step

    with timed("train: 2 warm-up steps"):
        for _ in range(WARMUP_STEPS - 1):
            one_step()
        rec_fwd, rec_bwd = record_launches(one_step)
    check((len(rec_fwd), len(rec_bwd)) == (FWD_PER_STEP, BWD_PER_STEP),
          f"training: recorded {len(rec_fwd)} forward and {len(rec_bwd)} backward launches")
    # Replayed and freed now, so the copies do not count in the step's peak
    # memory below.
    with timed("train: main-path launches replayed"):
        main_path = replay_launches("train step", rec_fwd, rec_bwd)
    del rec_fwd, rec_bwd
    groups = {name: [p.detach().clone() for p in ps] for name, ps in opt.groups.items()}

    # ---- the main path, counted: launch counters 0 just before, read after
    block_composite.composite_block.launches = 0
    block_composite.composite_block.bwd_launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    ev[0].record()
    metrics = []
    with timed("train: 5 timed steps"):
        for i in range(TRAIN_STEPS):
            metrics.append(one_step()[1])
            ev[i + 1].record()
        torch.cuda.synchronize()
    fwd = block_composite.composite_block.launches
    bwd = block_composite.composite_block.bwd_launches
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TRAIN_STEPS)]
    ms = sum(step_ms) / TRAIN_STEPS
    check(fwd == FWD_PER_STEP * TRAIN_STEPS,
          f"training: composite_fwd launched {fwd} times, want {FWD_PER_STEP * TRAIN_STEPS}")
    check(bwd == BWD_PER_STEP * TRAIN_STEPS,
          f"training: composite_bwd launched {bwd} times, want {BWD_PER_STEP * TRAIN_STEPS}")
    rows = [{k: float(v) for k, v in m.items()} for m in metrics]
    for r in rows:
        check(all(np.isfinite(v) for v in r.values()), f"training: a loss is not finite: {r}")
        # The LPIPS terms are in: each normal term exceeds its cosine part
        # (0.2 x a cosine loss in [0, 2]) only with them, and on random
        # weights LPIPS is far from 0.
        check(r["loss_normal_F"] > 0 and r["loss_normal_B"] > 0, f"training: normal terms {r}")
    changed = {name for name, ps in opt.groups.items()
               if any(not torch.equal(p, q) for p, q in zip(ps, groups[name]))}
    check(changed == CHANGING_GROUPS,
          f"training: groups changed {sorted(changed)}, want {sorted(CHANGING_GROUPS)}")
    print(f"[train] {ds.num_frames} frames, 4 gen views 256x256, GT + normal F/B 512x512, "
          f"K={TRAIN_K}, normal-LPIPS terms (bf16 VGG16): {ms:.3f} ms/step over {TRAIN_STEPS} steps ({[round(x, 3) for x in step_ms]} "
          f"ms) after {WARMUP_STEPS} warm-up; launches fwd {fwd} ({fwd // TRAIN_STEPS}/step), "
          f"bwd {bwd} ({bwd // TRAIN_STEPS}/step); groups updated {sorted(changed)} (colors, "
          f"opacity, scaling, latent_pose and the offsets/opacities heads get no gradient in "
          f"the field-driven step, as in the JAX package)")
    print(f"[train] canaries per step: raster_dropped {[r['raster_dropped'] for r in rows]}, "
          f"raster_capped {[r['raster_capped'] for r in rows]}")
    print("[train] last step's losses " + json.dumps({k: round(v, 6) for k, v in rows[-1].items()}))

    with timed("train: profiled step"):
        torch.cuda.reset_peak_memory_stats()
        prof = profile_view(one_step)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    busy = prof["device_busy_ms"]
    check(busy > 0 and prof["composite_fwd_ms"] > 0 and prof["composite_bwd_ms"] > 0,
          "training: the profiler saw no device time in a kernel")
    prof["idle_share"] = 1.0 - busy / ms
    with timed("train: host-op step"):
        cpu_compute, cpu_moves, n_ops, n_syncs = host_ops(one_step)
    check(not cpu_compute, f"training: an op of the step computed on the CPU: {cpu_compute}")
    print(f"[train] profile of one step: device busy {busy:.3f} ms in {prof['device_kernels']} "
          f"device ops (composite_fwd {prof['composite_fwd_ms']:.3f} ms = "
          f"{prof['composite_fwd_ms'] / busy:.4f} of busy, composite_bwd "
          f"{prof['composite_bwd_ms']:.3f} ms = {prof['composite_bwd_ms'] / busy:.4f}), idle "
          f"share {prof['idle_share']:.4f} of {ms:.3f} ms; peak memory {peak_gib:.3f} GiB; "
          f"{n_ops} aten ops, {n_syncs} host syncs, none computed on the CPU; ops with a CPU "
          f"result (transfers) {cpu_moves}")
    for row in prof["top"]:
        print(f"    {row['ms']:9.4f} ms  x{row['calls']:<5d} {row['name']}")

    # ---- where a step's wall time goes: the loss (every render), the
    # backward and the optimizer, each ended by a sync, over 3 steps; the
    # VGG16's forward and backward device ms inside them (CUDA events from
    # module hooks; two LPIPS calls a step, normal front and back)
    phases = {"forward": [], "backward": [], "optimizer": [], "vgg_forward": [],
              "vgg_backward": []}
    t_phases = time.perf_counter()
    vgg = ts.lpips_fn.net.vgg
    for _ in range(3):
        draws = sample_step_draws(gen, cfg)
        batch = batches[frames.randint(len(batches))]
        opt.zero_grad()
        torch.cuda.synchronize()
        with module_spans(vgg, backward=True) as sv:
            t0 = time.perf_counter()
            loss, _, _ = step.loss_fn(state.params, state.bg_params, batch, draws, state.step)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        state.step += 1
        for name, a, b in (("forward", t0, t1), ("backward", t1, t2), ("optimizer", t2, t3)):
            phases[name].append(1e3 * (b - a))
        check(len(sv.events["forward"]) == len(sv.events["backward"]) == 2,
              f"training: {len(sv.events['forward'])} VGG forwards in a step, want 2")
        spans = sv.ms()
        phases["vgg_forward"].append(spans["forward"])
        phases["vgg_backward"].append(spans["backward"])
    phase_ms = {k: float(np.median(v)) for k, v in phases.items()}
    WALL_S["train: 3 synced phase steps"] = time.perf_counter() - t_phases
    print("[train] phases, median ms of 3 synced steps: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phase_ms.items() if not k.startswith("vgg"))
        + f"; VGG16 (2 LPIPS calls, bf16) forward {phase_ms['vgg_forward']:.3f} ms, backward "
        f"{phase_ms['vgg_backward']:.3f} ms device time between CUDA events from module hooks")

    # ---- bf16 against f32 LPIPS (the same weights) on the step's normal
    # render and the GT normals, as the front normal term feeds them
    draws = sample_step_draws(gen, cfg)
    with torch.no_grad():
        _, _, aux = step.loss_fn(state.params, state.bg_params, batches[0], draws, state.step)
    nm = batches[0]["gt_normal_mask"][..., None]
    pred = (aux["gt_normal_F"]["normal"].detach() * nm - 0.5) * 2.0
    gt_n = (batches[0]["gt_normal_F"] * nm - 0.5) * 2.0
    del aux

    def lpips_of(fn):
        x = pred.clone().requires_grad_(True)
        val = fn(x, gt_n)
        val.backward()
        return float(val.detach()), x.grad

    with timed("train: bf16 vs f32 LPIPS"):
        l16, d16 = lpips_of(lpips16)
        l32, d32 = lpips_of(lpips32)
    lpips_spread = {"loss": abs(l16 - l32) / max(abs(l32), 1e-30),
                    "input_grad": float((d16 - d32).norm() / d32.norm().clamp_min(1e-30))}
    del d16, d32
    print(f"[train] bf16 vs f32 LPIPS (same weights; the step's front-normal render against "
          f"the GT, 512x512): {l16:.6g} vs {l32:.6g}, rel diff {lpips_spread['loss']:.4g} "
          f"(bound {LPIPS_BF16_LOSS_RTOL}); gradient on the render rel L2 diff "
          f"{lpips_spread['input_grad']:.4g} (bound {LPIPS_BF16_GRAD_RTOL})")
    check(np.isfinite(l16) and l32 > 0, f"LPIPS bf16 vs f32: {l16}, {l32}")
    check(lpips_spread["loss"] <= LPIPS_BF16_LOSS_RTOL,
          f"LPIPS bf16 vs f32: the loss differs by {lpips_spread['loss']:.4g}")
    check(lpips_spread["input_grad"] <= LPIPS_BF16_GRAD_RTOL,
          f"LPIPS bf16 vs f32: the render's gradient differs by {lpips_spread['input_grad']:.4g}")

    # ---- the same step with the plain composite: same state and draws,
    # both with float32 LPIPS (bf16 would round the two renders' small
    # differences to whole bf16 steps)
    kern = make_train_step(model, cfg, stage, opt, raster=raster, use_explicit=False,
                           has_normals=True, lpips_fn=lpips32, **sizes)
    plain = make_train_step(model, cfg, stage, opt, use_explicit=False, has_normals=True,
                            raster=dataclasses.replace(raster, composite="plain",
                                                       composite_dtype="f32"),
                            lpips_fn=lpips32, **sizes)
    draws = sample_step_draws(gen, cfg)

    def grads_of(fn):
        """Losses, grads, wall ms and the (forward, backward) kernel
        launches of one loss + backward."""
        opt.zero_grad()
        counts = (block_composite.composite_block.launches,
                  block_composite.composite_block.bwd_launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, m, _ = fn.loss_fn(state.params, state.bg_params, batches[0], draws, state.step)
        loss.backward()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        g = {k: p.grad.detach().clone() for k, p in state.params.named_parameters()
             if p.grad is not None}
        launched = (block_composite.composite_block.launches - counts[0],
                    block_composite.composite_block.bwd_launches - counts[1])
        return {k: float(v.detach()) for k, v in m.items()}, g, wall, launched

    with timed("train: kernel vs plain step"):
        mk, gk, wall_k, launched_k = grads_of(kern)
        mp, gp, wall_p, launched_p = grads_of(plain)
    opt.zero_grad()
    # The comparison is between two paths: the kernels' and the plain one.
    check(launched_k == (FWD_PER_STEP, BWD_PER_STEP) and launched_p == (0, 0),
          f"kernel vs plain: launches {launched_k} and {launched_p}")
    check(set(gk) == set(gp), f"kernel vs plain: grads of {sorted(gk)} vs {sorted(gp)}")
    loss_rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp}
    grad_rel = {k: float((gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30)) for k in gp}
    print(f"[train] kernel vs plain step (same state and draws, f32 LPIPS; loss + backward "
          f"{wall_k:.1f} ms kernel, {wall_p:.1f} ms plain): loss terms rel diff "
          + json.dumps({k: float(f"{v:.3g}") for k, v in loss_rel.items()}))
    print("[train] gradient rel L2 diff per leaf " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in grad_rel.items()}))
    for k, v in loss_rel.items():
        if not k.startswith("raster_"):
            check(v <= STEP_LOSS_RTOL, f"kernel vs plain: {k} differs by {v:.3g} relative")
    for k, v in grad_rel.items():
        tol = STEP_GRAD_TOL_BF16 if k.endswith("encoding") else STEP_GRAD_TOL
        check(v <= tol, f"kernel vs plain: grad of {k} differs by {v:.3g} (tolerance {tol})")
    return {
        "main_path": main_path,
        "ms_per_step": ms, "step_ms": step_ms, "launches_fwd": fwd, "launches_bwd": bwd,
        "losses": rows, "groups_changed": sorted(changed), "peak_memory_gib": peak_gib,
        "profile": prof, "phase_ms": phase_ms, "aten_ops_per_step": n_ops,
        "host_syncs_per_step": n_syncs,
        "cpu_transfers_per_step": cpu_moves, "kernel_vs_plain": {
            "loss_rel": loss_rel, "grad_rel_l2": grad_rel, "wall_ms_kernel": wall_k,
            "wall_ms_plain": wall_p},
        "lpips_bf16_vs_f32": lpips_spread, "lpips_bf16_f32_values": [l16, l32],
    }


# bf16 LPIPS (the loss path) against f32 with the same weights, on the
# step's front-normal render: the loss and its gradient on the render,
# relative.  About 3.6x and 2x the spread measured on an H100 (1.37e-4 and
# 0.121; PERF.md section 6).
LPIPS_BF16_LOSS_RTOL = 5e-4
LPIPS_BF16_GRAD_RTOL = 0.25

# The image prompt: ImageDream's CLIP ViT-H/14 in penultimate mode (31 of
# its 32 blocks, no ln_post or proj) and the Resampler, by their
# checkpoints' key manifests.
CLIP_PARAMS_PENULTIMATE = 611_086_080
RESAMPLER_PARAMS = 48_541_696
# bf16 ip tokens against f32 ones (the same weights, widened), relative L2
# over the 8 frames: about 3x the spread measured on an H100 (9.02e-3;
# PERF.md section 6).
IP_BF16_REL_L2 = 0.03
# Tokens of different frames must differ by more than this, relative L2.
IP_FRAME_SPREAD_MIN = 1e-3


def run_image_prompt(ds, device):
    """``[image prompt]``: the full-shape mock ImageDream guidance in bf16
    (UNet, VAE, CLIP tower and Resampler; the weights that
    :func:`run_guided_training` trains with), the towers' parameter counts,
    the ip tokens of the 8 training frames' 512x512 ``images_crop`` through
    ``embed_ref`` (ms per frame by CUDA events, peak memory), bf16 against
    f32 tokens, and the memory ``release_image_encoder()`` frees.  Returns
    the guidance and the tokens [F, 16, 1024]."""
    import gc

    from soar_tpu_torch.guidance.build import build_guidance, make_image_encoder
    from soar_tpu_torch.guidance.clip_vit import make_image_embed_fn
    from soar_tpu_torch.train.config import stage1_config

    gen_t = torch.Generator(device=device).manual_seed(100)
    with timed("image prompt: build"):
        g = build_guidance("imagedream", stage1_config(), generator=gen_t, mock=True,
                           dtype=torch.bfloat16, device=device)
        torch.cuda.synchronize()
    enc = g.image_encoder
    n_clip = sum(p.numel() for p in enc["clip"].parameters())
    n_res = sum(p.numel() for p in enc["resampler"].parameters())
    check((n_clip, n_res) == (CLIP_PARAMS_PENULTIMATE, RESAMPLER_PARAMS),
          f"image towers' parameters {n_clip}, {n_res}, want {CLIP_PARAMS_PENULTIMATE}, "
          f"{RESAMPLER_PARAMS}")
    check(all(p.dtype == torch.bfloat16 and p.device.type == "cuda" and not p.requires_grad
              for m in enc.values() for p in m.parameters()),
          "image towers not frozen bf16 on the card")
    tower_bytes = sum(p.numel() * p.element_size() for m in enc.values() for p in m.parameters())
    crops = [torch.as_tensor(ds.images_crop[f], device=device) for f in ds.train_idx]

    with timed("image prompt: embed 8 frames"):
        g.embed_ref(crops[0])  # first call: cuBLAS / cuDNN set-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(crops) + 1)]
        ev[0].record()
        tokens = []
        for i, c in enumerate(crops):
            tokens.append(g.embed_ref(c))
            ev[i + 1].record()
        torch.cuda.synchronize()
        frame_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(crops))]
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        peak_over_gib = (torch.cuda.max_memory_allocated() - base) / 2**30
    ip_table = torch.stack(tokens)
    check(tuple(ip_table.shape) == (len(crops),) + g.shapes.ip_shape == (8, 16, 1024)
          and ip_table.dtype == torch.float32 and bool(torch.isfinite(ip_table).all()),
          f"ip tokens {tuple(ip_table.shape)} {ip_table.dtype}")
    spread = min(float((ip_table[i] - ip_table[0]).norm() / ip_table[0].norm())
                 for i in range(1, len(crops)))
    check(spread > IP_FRAME_SPREAD_MIN, f"ip tokens hardly differ across frames ({spread:.3g})")

    # ---- bf16 against f32 tokens: the same weights, widened
    with timed("image prompt: bf16 vs f32 tokens"):
        clip32, res32 = make_image_encoder(g.shapes, dtype=torch.float32, device=device)
        clip32.load_state_dict(enc["clip"].state_dict())
        res32.load_state_dict(enc["resampler"].state_dict())
        embed32 = make_image_embed_fn(clip32.eval(), res32.eval())
        t32 = torch.stack([embed32(c) for c in crops])
        bf16_rel = float((ip_table - t32).norm() / t32.norm())
        del clip32, res32, embed32, t32
        gc.collect()
        torch.cuda.empty_cache()

    # ---- the release frees the towers
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    g.release_image_encoder()
    del enc
    gc.collect()
    after = torch.cuda.memory_allocated()
    freed = before - after
    check(freed >= tower_bytes, f"release_image_encoder freed {freed} bytes, the towers hold "
          f"{tower_bytes}")
    check(g.image_encoder == {"clip": None, "resampler": None}, "towers still held")
    try:
        g.embed_ref(crops[0])
        released = False
    except RuntimeError:
        released = True
    check(released, "embed_ref still runs after release_image_encoder()")
    print(f"[image prompt] imagedream (mock, bf16): CLIP ViT-H/14 penultimate {n_clip:,} "
          f"parameters, Resampler {n_res:,}; {len(crops)} frames' 512x512 images_crop -> ip "
          f"tokens {tuple(ip_table.shape[1:])}: {np.mean(frame_ms):.3f} ms/frame "
          f"({[round(x, 3) for x in frame_ms]} ms, CUDA events); peak memory {peak_gib:.3f} GiB "
          f"({peak_over_gib:.4f} GiB over the weights); tokens across frames differ by >= "
          f"{spread:.4g} relative L2")
    print(f"[image prompt] bf16 vs f32 tokens (same weights, widened): rel L2 {bf16_rel:.4g} "
          f"(bound {IP_BF16_REL_L2}); release_image_encoder(): allocated {before / 2**30:.3f} -> "
          f"{after / 2**30:.3f} GiB (freed {freed / 2**30:.3f} GiB; the towers' bf16 bytes "
          f"{tower_bytes / 2**30:.3f} GiB)")
    check(bf16_rel <= IP_BF16_REL_L2, f"ip tokens bf16 vs f32: rel L2 {bf16_rel:.4g}")
    return g, ip_table, {
        "clip_params": n_clip, "resampler_params": n_res, "ms_per_frame": frame_ms,
        "peak_memory_gib": peak_gib, "peak_over_weights_gib": peak_over_gib,
        "frame_spread_rel_l2": spread, "bf16_vs_f32_rel_l2": bf16_rel,
        "allocated_before_release": before, "allocated_after_release": after,
        "tower_bytes": tower_bytes,
    }


# The guided step: the full-shape ImageDream UNet (ipmv) and the SD VAE
# encoder, by their checkpoints' key manifests.
UNET_PARAMS_IPMV = 893_131_204
VAE_PARAMS = 34_163_664
# The guided step's loss terms, kernel composite against plain: the SDS loss
# sees the renders through the VAE encoder and the UNet's target, so a pixel
# whose stop slot flips moves it more than the explicit losses (1e-4).
GUIDED_LOSS_RTOL = 1e-3
# The bf16 guidance against the float32 one with the same weights (the bf16
# values, widened) on the same render, draws and step: the SDS loss and its
# gradient on the render, relative.  About 3x and 2.3x the spread measured on
# an H100 at the full shape (1.62e-4 and 4.27e-2; PERF.md section 6).
GUIDED_BF16_LOSS_RTOL = 5e-4
GUIDED_BF16_GRAD_RTOL = 0.1
# The CLI's first guided step, split SDS against fused: the same renders,
# VAE and target, up to the nondeterministic order of the hash tables'
# gradient scatter in the step before it.
CLI_SPLIT_RTOL = 1e-4
CONTEXT_DIM = 1024  # the UNet's text context width (NetworkShapes.full())
# exp(-3 occ) at occ logits -10 / +10 (occ ~0 / ~1) scales the SDS pull by
# ~1 / ~0.05; the check asks for a 2x shrink, as tests/test_sds_train.py.
OCC_HOOK_SHRINK = 2.0


class module_spans:
    """CUDA events around a module's forward (and backward, ``backward=
    True``) in every call while the ``with`` block runs: ``ms()`` gives the
    device ms of each span, for a step ended by a synchronize."""

    def __init__(self, module, backward=False):
        self.module, self.backward, self.events = module, backward, {"forward": []}
        if backward:
            self.events["backward"] = []

    def _pair(self, name):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        self.events[name].append(ev)
        return ev

    def __enter__(self):
        m = self.module

        def pre(mod, args):
            self._pair("forward")[0].record()

        def post(mod, args, out):
            self.events["forward"][-1][1].record()

        self.handles = [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
        if self.backward:
            def bpre(mod, gout):
                self._pair("backward")[0].record()

            def bpost(mod, gin, gout):
                self.events["backward"][-1][1].record()

            self.handles += [m.register_full_backward_pre_hook(bpre),
                             m.register_full_backward_hook(bpost)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def ms(self):
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v) for k, v in self.events.items()}


def run_guided_training(ds, params, model, device, g, ip_table, lpips_path):
    """The full-width training step with SDS guidance: the scene, batches,
    views and raster of :func:`train_setup` with its normal-LPIPS terms,
    stage 1 (the RGB composite guides) with ``sds_start`` 0, and the
    guidance ``g`` of :func:`run_image_prompt` (full shape, bf16) with each
    frame's ip tokens from ``ip_table`` in its batch.  2 warm-up steps and 5
    timed, counted; a profiled step, the UNet's and the VAE's device ms
    inside a synced step, the host-op check, the SDS term's reach (colours'
    gradient with and without it, and the occ hook), the kernel step
    against the plain one with float32 networks and LPIPS, and one stage-0
    step."""
    import dataclasses

    from soar_tpu_torch.guidance.build import build_guidance
    from soar_tpu_torch.render import block_composite
    from soar_tpu_torch.train.config import LossWeights, StageConfig, stage1_config
    from soar_tpu_torch.train.lpips import make_lpips_fn
    from soar_tpu_torch.train.trainer import make_train_step, sample_step_draws

    bc = block_composite.composite_block
    lpips16 = make_lpips_fn(lpips_path, dtype=torch.bfloat16, device=device)
    ts = train_setup(ds, params, model, device, lpips16)
    cfg, raster, sizes, opt = ts.cfg, ts.raster, ts.sizes, ts.opt
    state = ts.state
    stage = stage1_config()
    check(stage.sds_start == 0, "stage 1 guides from its first step")
    n_unet = sum(p.numel() for p in g.unet.parameters())
    n_vae = sum(p.numel() for p in g.vae.parameters())
    check((n_unet, n_vae) == (UNET_PARAMS_IPMV, VAE_PARAMS),
          f"guidance parameters {n_unet}, {n_vae}, want {UNET_PARAMS_IPMV}, {VAE_PARAMS}")
    check(all(p.dtype == torch.bfloat16 and p.device.type == "cuda" and not p.requires_grad
              for m in (g.unet, g.vae) for p in m.parameters()),
          "guidance weights not frozen bf16 on the card")
    batches = [dict(b, ref_ip=ip_table[f]) for f, b in zip(ds.train_idx, ts.batches)]
    state.step = 1
    step = make_train_step(model, cfg, stage, opt, raster=raster, use_explicit=False,
                           has_normals=True, guidance_fn=g, lpips_fn=lpips16, **sizes)
    draw_gen = torch.Generator(device=device).manual_seed(1)
    frames = np.random.RandomState(2)

    def one_step(fn=step):
        draws = sample_step_draws(draw_gen, cfg, latent_size=g.latent_size)
        return fn(state, batches[frames.randint(len(batches))], draws)

    with timed("guided: 2 warm-up steps"):
        for _ in range(WARMUP_STEPS):
            one_step()
        torch.cuda.synchronize()

    # ---- the main path, counted: launch counters 0 just before, read after
    bc.launches = 0
    bc.bwd_launches = 0
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_STEPS + 1)]
    ev[0].record()
    metrics = []
    with timed("guided: 5 timed steps"):
        for i in range(TRAIN_STEPS):
            metrics.append(one_step()[1])
            ev[i + 1].record()
        torch.cuda.synchronize()
    fwd, bwd = bc.launches, bc.bwd_launches
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(TRAIN_STEPS)]
    ms = sum(step_ms) / TRAIN_STEPS
    check(fwd == FWD_PER_STEP * TRAIN_STEPS,
          f"guided: composite_fwd launched {fwd} times, want {FWD_PER_STEP * TRAIN_STEPS}")
    check(bwd == BWD_PER_STEP * TRAIN_STEPS,
          f"guided: composite_bwd launched {bwd} times, want {BWD_PER_STEP * TRAIN_STEPS}")
    rows = [{k: float(v) for k, v in m.items()} for m in metrics]
    for r in rows:
        check("loss_sds" in r and "sds_grad_norm" in r and r["loss_normal_F"] > 0,
              f"guided: no SDS metrics or normal-LPIPS terms in {r}")
        check(all(np.isfinite(v) for v in r.values()), f"guided: a loss is not finite: {r}")
    check(all(p.grad is None for m in (g.unet, g.vae) for p in m.parameters()),
          "guided: a guidance weight got a gradient")
    lat = g.latent_size
    print(f"[guided train] imagedream (mock, bf16; UNet {n_unet:,} parameters, VAE encoder "
          f"{n_vae:,}; each frame's ip tokens from [image prompt]), stage 1, 4 gen views "
          f"256x256 -> 4x{lat}x{lat} latents, GT + normal F/B 512x512 with the normal-LPIPS "
          f"terms (bf16), K={TRAIN_K}: {ms:.3f} ms/step over {TRAIN_STEPS} steps "
          f"({[round(x, 3) for x in step_ms]} ms) after {WARMUP_STEPS} warm-up; launches fwd "
          f"{fwd} ({fwd // TRAIN_STEPS}/step), bwd {bwd} ({bwd // TRAIN_STEPS}/step)")
    print("[guided train] last step's losses " + json.dumps(
        {k: round(v, 6) for k, v in rows[-1].items()}))

    with timed("guided: profiled step"):
        torch.cuda.reset_peak_memory_stats()
        prof = profile_view(one_step)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
    busy = prof["device_busy_ms"]
    check(busy > 0 and prof["composite_fwd_ms"] > 0 and prof["composite_bwd_ms"] > 0,
          "guided: the profiler saw no device time in a kernel")
    prof["idle_share"] = 1.0 - busy / ms
    with timed("guided: host-op step"):
        cpu_compute, cpu_moves, n_ops, n_syncs = host_ops(one_step)
    check(not cpu_compute, f"guided: an op of the step computed on the CPU: {cpu_compute}")
    check(n_syncs == 0, f"guided: {n_syncs} host syncs in a step")

    # ---- the UNet's forward and the VAE's forward + backward inside a
    # synced step (CUDA events from module hooks); their inputs are kept
    # and each is profiled alone below
    spans, inputs = [], {}
    def keep(name):
        def hook(mod, args):
            inputs.setdefault(name, args)  # returns None: the inputs stay as they are
        return hook

    hooks = [m.register_forward_pre_hook(keep(name))
             for name, m in (("unet", g.unet), ("vae", g.vae))]
    with timed("guided: 3 synced steps"):
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with module_spans(g.unet) as su, module_spans(g.vae, backward=True) as sv:
                one_step()
                torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
            u, v = su.ms(), sv.ms()
            spans.append({"step_wall_ms": wall, "unet_ms": u["forward"],
                          "vae_fwd_ms": v["forward"], "vae_bwd_ms": v["backward"]})
    for h in hooks:
        h.remove()
    span = {k: float(np.median([s[k] for s in spans])) for k in spans[0]}
    check(span["unet_ms"] > 0 and span["vae_fwd_ms"] > 0 and span["vae_bwd_ms"] > 0,
          f"guided: module spans {span}")
    x_vae, eps_vae = (a.detach() for a in inputs["vae"])

    def vae_fwd_bwd():
        x = x_vae.clone().requires_grad_(True)
        g.vae(x, eps_vae).float().sum().backward()

    with timed("guided: UNet and VAE profiled alone"), torch.no_grad():
        prof_unet = profile_view(lambda: g.unet(*inputs["unet"]))
    with timed("guided: UNet and VAE profiled alone"):
        prof_vae = profile_view(vae_fwd_bwd)
    del inputs, x_vae, eps_vae
    print(f"[guided train] profile of one step: device busy {busy:.3f} ms in "
          f"{prof['device_kernels']} device ops (composite_fwd {prof['composite_fwd_ms']:.3f} "
          f"ms, composite_bwd {prof['composite_bwd_ms']:.3f} ms), idle share "
          f"{prof['idle_share']:.4f} of {ms:.3f} ms; peak memory {peak_gib:.3f} GiB; {n_ops} "
          f"aten ops, {n_syncs} host syncs, none computed on the CPU; ops with a CPU result "
          f"(transfers) {cpu_moves}")
    print(f"[guided train] synced step (median of 3): wall {span['step_wall_ms']:.3f} ms, UNet "
          f"forward (2 x 4 views, CFG) {span['unet_ms']:.3f} ms, VAE encoder forward "
          f"{span['vae_fwd_ms']:.3f} ms + backward {span['vae_bwd_ms']:.3f} ms (device ms "
          f"between CUDA events from module hooks)")
    for name, pr in (("UNet forward", prof_unet), ("VAE encoder forward + backward", prof_vae)):
        print(f"[guided train] {name} alone on the step's inputs: device busy "
              f"{pr['device_busy_ms']:.3f} ms in {pr['device_kernels']} device ops, wall "
              f"{pr['profiled_wall_ms']:.3f} ms")
    for row in prof["top"]:
        print(f"    {row['ms']:9.4f} ms  x{row['calls']:<5d} {row['name']}")

    # ---- the SDS term reaches the colours, and exp(-3 occ) scales it.  The
    # explicit avatar (colours as parameters; the field-driven step gives
    # them no gradient), one draw for every pass.
    def colors_grad(stage_c):
        fn = make_train_step(model, cfg, stage_c, opt, raster=raster, use_explicit=True,
                             has_normals=True, guidance_fn=g.for_stage(stage_c),
                             lpips_fn=lpips16, **sizes)
        opt.zero_grad()
        loss, _, _ = fn.loss_fn(state.params, state.bg_params, batches[0], draws_c, state.step)
        loss.backward()
        out = state.params.colors.grad.detach().clone()
        opt.zero_grad()
        return out

    draws_c = sample_step_draws(draw_gen, cfg, latent_size=g.latent_size)
    with timed("guided: SDS and occ-hook checks"):
        g_sds = colors_grad(stage)
        g_nosds = colors_grad(dataclasses.replace(
            stage, loss=dataclasses.replace(stage.loss, sds=0.0)))
        sds_share = float((g_sds - g_nosds).norm() / g_nosds.norm().clamp_min(1e-30))
        check(not torch.equal(g_sds, g_nosds) and sds_share > 0,
              "guided: the SDS term does not reach the colours")
        only_sds = dataclasses.replace(stage, loss=LossWeights(
            sds=1.0, recon=0.0, mask=0.0, normal_F=0.0, normal_B=0.0, normal_mask=0.0,
            normal_consistency=0.0, curv=0.0, scales=0.0, delta=0.0, occ=1.0))
        occ0 = state.params.occ.detach().clone()
        pull = {}
        try:
            for name, val in (("low", -10.0), ("high", 10.0)):
                with torch.no_grad():
                    state.params.occ.fill_(val)
                pull[name] = float(colors_grad(only_sds).norm())
        finally:
            with torch.no_grad():
                state.params.occ.copy_(occ0)
    check(pull["low"] > 0 and pull["high"] * OCC_HOOK_SHRINK <= pull["low"],
          f"guided: occ hook: SDS pull on the colours {pull} (occ high / low)")
    print(f"[guided train] the SDS term's share of the colours' gradient (explicit avatar, "
          f"stage-1 weights): {sds_share:.4g} relative L2; occ hook: SDS-only pull on the "
          f"colours {pull['high']:.6g} at occ logit +10 against {pull['low']:.6g} at -10 "
          f"({pull['low'] / max(pull['high'], 1e-30):.2f}x)")

    # ---- kernel against plain composite, float32 networks (the bf16
    # networks' weights and text embeddings, widened) and LPIPS, same draws
    with timed("guided: kernel vs plain step (f32 networks)"):
        lpips32 = make_lpips_fn(lpips_path, dtype=torch.float32, device=device)
        g32 = build_guidance("imagedream", stage,
                             generator=torch.Generator(device=device).manual_seed(100),
                             text_embeddings=g.guidance.text_embeddings,
                             mock=True, dtype=torch.float32, device=device)
        g32.release_image_encoder()  # the batches carry the tokens
        g32.unet.load_state_dict(g.unet.state_dict())
        g32.vae.load_state_dict(g.vae.state_dict())
        seen = {}

        def g32_seen(inp, c2w, step_, draws_, **kw):
            seen.update(args=(inp.detach(), c2w, step_, draws_), kw={
                k: v.detach() if torch.is_tensor(v) else v for k, v in kw.items()})
            return g32(inp, c2w, step_, draws_, **kw)

        kern = make_train_step(model, cfg, stage, opt, raster=raster, use_explicit=False,
                               has_normals=True, guidance_fn=g32_seen, lpips_fn=lpips32,
                               **sizes)
        plain = make_train_step(model, cfg, stage, opt, use_explicit=False, has_normals=True,
                                raster=dataclasses.replace(raster, composite="plain",
                                                           composite_dtype="f32"),
                                guidance_fn=g32, lpips_fn=lpips32, **sizes)
        draws = sample_step_draws(draw_gen, cfg, latent_size=g.latent_size)

        def grads_of(fn):
            opt.zero_grad()
            counts = (bc.launches, bc.bwd_launches)
            loss, m, _ = fn.loss_fn(state.params, state.bg_params, batches[0], draws,
                                    state.step)
            loss.backward()
            torch.cuda.synchronize()
            grads = {k: p.grad.detach().clone() for k, p in state.params.named_parameters()
                     if p.grad is not None}
            return ({k: float(v.detach()) for k, v in m.items()}, grads,
                    (bc.launches - counts[0], bc.bwd_launches - counts[1]))

        mk, gk, launched_k = grads_of(kern)
        mp, gp, launched_p = grads_of(plain)
        opt.zero_grad()

    # ---- the bf16 guidance against the float32 one on the kernel step's
    # render, draws and step: what bf16 computing costs the SDS signal
    def sds_of(gfn):
        inp, c2w, step_, draws_ = seen["args"]
        x = inp.clone().requires_grad_(True)
        out = gfn(x, c2w, step_, draws_, **seen["kw"])
        out["loss_sds"].backward()
        return float(out["loss_sds"].detach()), x.grad

    with timed("guided: bf16 vs f32 guidance"):
        l16, d16 = sds_of(g)
        l32, d32 = sds_of(g32)
        bf16_spread = {"loss_sds": abs(l16 - l32) / max(abs(l32), 1e-30),
                       "input_grad": float((d16 - d32).norm() / d32.norm().clamp_min(1e-30))}
        check(all(p.grad is None for m in (g.unet, g.vae, g32.unet, g32.vae)
                  for p in m.parameters()), "guided bf16 vs f32: a guidance weight got a gradient")
        del g32, g32_seen, kern, plain, seen, d16, d32, lpips32
        torch.cuda.empty_cache()
    print(f"[guided train] bf16 vs f32 guidance (same weights, render, draws and step): "
          f"loss_sds {l16:.6g} vs {l32:.6g}, rel diff {bf16_spread['loss_sds']:.4g} (bound "
          f"{GUIDED_BF16_LOSS_RTOL}); gradient on the render rel L2 diff "
          f"{bf16_spread['input_grad']:.4g} (bound {GUIDED_BF16_GRAD_RTOL})")
    check(np.isfinite(l16) and np.isfinite(l32) and l32 > 0,
          f"guided bf16 vs f32: loss_sds {l16}, {l32}")
    check(bf16_spread["loss_sds"] <= GUIDED_BF16_LOSS_RTOL,
          f"guided bf16 vs f32: loss_sds differs by {bf16_spread['loss_sds']:.4g}")
    check(bf16_spread["input_grad"] <= GUIDED_BF16_GRAD_RTOL,
          f"guided bf16 vs f32: the render's gradient differs by {bf16_spread['input_grad']:.4g}")
    check(launched_k == (FWD_PER_STEP, BWD_PER_STEP) and launched_p == (0, 0),
          f"guided kernel vs plain: launches {launched_k} and {launched_p}")
    check(set(gk) == set(gp) and "loss_sds" in mk,
          f"guided kernel vs plain: grads of {sorted(gk)} vs {sorted(gp)}")
    loss_rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp}
    grad_rel = {k: float((gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30)) for k in gp}
    print("[guided train] kernel vs plain step (f32 networks and LPIPS, same state and draws): loss "
          "terms rel diff " + json.dumps({k: float(f"{v:.3g}") for k, v in loss_rel.items()}))
    print("[guided train] gradient rel L2 diff per leaf " + json.dumps(
        {k: float(f"{v:.3g}") for k, v in grad_rel.items()}))
    for k, v in loss_rel.items():
        if not k.startswith("raster_"):
            check(v <= GUIDED_LOSS_RTOL, f"guided kernel vs plain: {k} differs by {v:.3g}")
    for k, v in grad_rel.items():
        tol = STEP_GRAD_TOL_BF16 if k.endswith("encoding") else STEP_GRAD_TOL
        check(v <= tol, f"guided kernel vs plain: grad of {k} differs by {v:.3g} "
              f"(tolerance {tol})")

    # ---- one stage-0 step: the rendered normals guide, normal_F the reference
    stage0 = StageConfig(sds_start=0)
    step0 = make_train_step(model, cfg, stage0, opt, raster=raster, use_explicit=False,
                            has_normals=True, guidance_fn=g.for_stage(stage0),
                            lpips_fn=lpips16, **sizes)
    counts = (bc.launches, bc.bwd_launches)
    with timed("guided: stage-0 step"):
        m0 = {k: float(v) for k, v in one_step(step0)[1].items()}
        torch.cuda.synchronize()
    launched0 = (bc.launches - counts[0], bc.bwd_launches - counts[1])
    check(launched0 == (FWD_PER_STEP, BWD_PER_STEP), f"guided stage 0: launches {launched0}")
    check("loss_sds" in m0 and all(np.isfinite(v) for v in m0.values()),
          f"guided stage 0: losses {m0}")
    print(f"[guided train] stage-0 step (normals guide): loss_sds {m0['loss_sds']:.6g}, "
          f"sds_grad_norm {m0['sds_grad_norm']:.6g}, loss {m0['loss']:.6g}; launches {launched0}")
    return {
        "ms_per_step": ms, "step_ms": step_ms, "launches_fwd": fwd, "launches_bwd": bwd,
        "losses": rows, "peak_memory_gib": peak_gib, "profile": prof,
        "aten_ops_per_step": n_ops, "host_syncs_per_step": n_syncs,
        "cpu_transfers_per_step": cpu_moves, "synced_step_spans_ms": span,
        "profile_unet_alone": prof_unet, "profile_vae_fwd_bwd_alone": prof_vae,
        "unet_params": n_unet, "vae_params": n_vae, "sds_share_colors_grad": sds_share,
        "occ_hook_pull": pull, "kernel_vs_plain": {"loss_rel": loss_rel,
                                                   "grad_rel_l2": grad_rel},
        "bf16_vs_f32": bf16_spread,
        "stage0_losses": m0,
    }


def read_obj_counts(path):
    """(vertices, faces) of an OBJ, through the port's loader."""
    from soar_tpu_torch.io.objmesh import load_obj_mesh

    if os.path.getsize(path) == 0:
        return 0, 0
    verts, faces = load_obj_mesh(path)
    check(len(faces) == 0 or int(faces.max()) < len(verts), f"{path}: a face indexes no vertex")
    check(bool(np.isfinite(verts).all()), f"{path}: a vertex is not finite")
    return len(verts), len(faces)


def run_export_full(params, model, resolution):
    """The export's device part at full width: ``io.meshing.extract_mesh``,
    the function the CLI calls, on the 125,664-surfel bench scene with the
    attribute field's scales and opacities (what ``--field-attrs`` passes).
    At this N the density field's point chunk is capped from N, which the
    CLI's 400-surfel fixture never reaches.  Only the grid resolution is cut
    (``resolution`` against the CLI's default of 128); the field's cost is
    linear in the number of grid points.  Every aten op of one more call at
    resolution 32 (the same chunk size, fewer chunks) is recorded."""
    from soar_tpu_torch.avatar.renderer import query_attributes
    from soar_tpu_torch.io import meshing

    N = params.xyz.shape[0]
    step = meshing.points_per_chunk(N)
    check(step < 65536, f"export full: the chunk cap does not bite at N={N} (step {step})")
    with torch.no_grad():
        attrs = query_attributes(params, model)
    kw = dict(scales=attrs["scales"], opacities=attrs["opacities"][:, 0])
    timings = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    verts, faces = meshing.extract_mesh(params, resolution=resolution, timings=timings, **kw)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(len(verts) > 100 and len(faces) > 100,
          f"export full: mesh of {len(verts)} vertices, {len(faces)} faces")
    check(bool(np.isfinite(verts).all()) and int(faces.max()) < len(verts),
          "export full: a vertex is not finite or a face indexes no vertex")
    cpu_compute, cpu_moves, n_ops, n_syncs = host_ops(
        lambda: meshing.extract_mesh(params, resolution=32, **kw))
    check(not cpu_compute, f"export full: the density field computed on the CPU: {cpu_compute}")
    chunks = -(-resolution ** 3 // step)
    print(f"[export full] extract_mesh, {N} Gaussians (field scales and opacities), resolution "
          f"{resolution} (CLI default 128): {step} grid points per chunk, {chunks} chunks; "
          f"density field {timings['density_field_s']:.3f} s, host part "
          f"{timings['host_s']:.3f} s, peak memory {peak_gib:.3f} GiB; {len(verts)} vertices, "
          f"{len(faces)} faces; at resolution 32: {n_ops} aten ops, {n_syncs} host syncs, none "
          f"computed on the CPU; ops with a CPU result (transfers) {cpu_moves}")
    return {"gaussians": N, "resolution": resolution, "points_per_chunk": step,
            "chunks": chunks, "verts": len(verts), "faces": len(faces),
            "peak_memory_gib": peak_gib, "aten_ops_at_resolution_32": n_ops, **timings}


def run_export(ckpt, out_dir, device):
    """cli.export_mesh --synthetic on the trained checkpoint at its default
    flags (resolution 128, level 0.8), from the explicit logits and with
    --field-attrs.  The explicit opacity logits stay at their initial 0.1
    in the field-driven training (as in the JAX package, whose CLI documents
    it), so their density may peak below the default level and leave that
    mesh empty: it is printed and must read back, the --field-attrs mesh
    must not be empty.  Then the density field alone, with every aten op
    recorded.  This is the CLI's round trip on its 400-surfel fixture; the
    export's time at full width is run_export_full's."""
    from soar_tpu_torch.avatar import state as S
    from soar_tpu_torch.cli import export_mesh
    from soar_tpu_torch.cli.common import synthetic_setup
    from soar_tpu_torch.io.checkpoint import load_avatar
    from soar_tpu_torch.io.meshing import extract_density_field

    runs = {"explicit": [], "field_attrs": ["--field-attrs"]}
    reports = {}
    for name, flags in runs.items():
        path = os.path.join(out_dir, f"{name}.obj")
        t0 = time.perf_counter()
        stats = export_mesh.main(["--synthetic", "--ckpt", ckpt, "--out", path,
                                  "--device", device, *flags])
        stats["cli_s"] = time.perf_counter() - t0
        check(read_obj_counts(path) == (stats["verts"], stats["faces"]),
              f"export {name}: the OBJ does not read back as written")
        reports[name] = stats
    check(reports["field_attrs"]["verts"] > 100 and reports["field_attrs"]["faces"] > 100,
          f"export field_attrs: mesh {reports['field_attrs']}")

    _, params, _ = synthetic_setup(distill_steps=0, device=device)
    params, _ = load_avatar(ckpt, params)
    with torch.no_grad():
        field_args = (params.xyz, S.get_scaling(params).expand(-1, 3), S.get_rotation(params),
                      S.get_opacity(params)[:, 0])
        cpu_compute, cpu_moves, n_ops, n_syncs = host_ops(
            lambda: extract_density_field(*field_args, resolution=128, device=device))
    check(not cpu_compute, f"export: the density field computed on the CPU: {cpu_compute}")
    for name, r in reports.items():
        print(f"[export {name}] {r['verts']} vertices, {r['faces']} faces; density field "
              f"{r['density_field_s']:.3f} s, host part {r['host_s']:.3f} s, CLI {r['cli_s']:.3f} s")
    print(f"[export] density field at resolution 128, {params.xyz.shape[0]} Gaussians: {n_ops} "
          f"aten ops, {n_syncs} host syncs, none computed on the CPU; ops with a CPU result "
          f"(transfers) {cpu_moves}")
    reports["density_field_aten_ops"] = n_ops
    return reports


class _Tee:
    """A stdout that also keeps what is written."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, s):
        self.text.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_train_cli(argv):
    """cli.train.main(argv), its stdout kept; returns (seconds, stdout,
    metrics rows, the --out directory)."""
    import contextlib

    from soar_tpu_torch.cli import train

    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        train.main(argv)
    out = argv[argv.index("--out") + 1]
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    return time.perf_counter() - t0, "".join(tee.text), rows, out


def run_cli(device, lpips_path):
    """cli.train --synthetic --stage both --steps 3, then cli.render_rot and
    cli.export_mesh on its stage-1 checkpoint, in a temporary directory;
    then the guided CLI runs: mvdream (mock networks, both stages), ImageDream
    with LPIPS (``lpips_path``) and --eval in fused and split SDS, and
    mvdream with prompt embeddings from a seeded .npz."""
    from soar_tpu_torch.cli import render_rot, train

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        train.main(["--synthetic", "--stage", "both", "--steps", "3", "--out", d,
                    "--log-every", "1", "--device", device])
        train_s = time.perf_counter() - t0
        rot = os.path.join(d, "rot")
        render_rot.main(["--synthetic", "--ckpt", os.path.join(d, "stage1"), "--num-views", "2",
                         "--out", rot, "--device", device])
        for st in (0, 1):
            check(os.path.exists(os.path.join(d, f"stage{st}", "avatar.pt")),
                  f"cli: no stage{st} checkpoint")
        rows = [json.loads(line) for line in open(os.path.join(d, "metrics.jsonl"))]
        check(len(rows) == 6 and all(np.isfinite(r["loss"]) for r in rows),
              f"cli: metrics rows {rows}")
        pngs = sorted(f for f in os.listdir(rot) if f.endswith(".png"))
        check(len(pngs) == 8, f"cli: render_rot wrote {pngs}")
        total_s = time.perf_counter() - t0
        print(f"[cli] train --synthetic --stage both --steps 3: {train_s:.2f} s; render_rot "
              f"--ckpt stage1 --num-views 2: {total_s - train_s:.2f} s; checkpoints, 6 metrics "
              f"rows and {len(pngs)} pngs written")
        with timed("export"):
            export = run_export(os.path.join(d, "stage1"), d, device)
        # SDS guidance from the CLI: mvdream with full-shape random networks.
        gd = os.path.join(d, "guided")
        t0 = time.perf_counter()
        train.main(["--synthetic", "--guidance", "mvdream", "--mock-guidance", "--stage", "both",
                    "--steps", "3", "--sds-start", "0", "--out", gd, "--log-every", "1",
                    "--device", device])
        guided_s = time.perf_counter() - t0
        rows = [json.loads(line) for line in open(os.path.join(gd, "metrics.jsonl"))]
        guided_rows = [r for r in rows if "loss_sds" in r]
        check(len(rows) == 6 and len(guided_rows) == 4
              and all(np.isfinite(r["loss"]) and np.isfinite(r["loss_sds"]) for r in guided_rows),
              f"cli guided: metrics rows {rows}")
        print(f"[cli] train --synthetic --guidance mvdream --mock-guidance --stage both --steps 3 "
              f"--sds-start 0: {guided_s:.2f} s; 6 metrics rows, 4 with loss_sds "
              f"{[round(r['loss_sds'], 5) for r in guided_rows]}")

        # ImageDream from the CLI: the image prompt embedded once per frame,
        # LPIPS (the synthetic data has no normals: the VGG RGB term) and
        # the LPIPS eval; the same run in fused and in split SDS.
        idream = {}
        for mode in ("fused", "split"):
            argv = ["--synthetic", "--guidance", "imagedream", "--mock-guidance", "--stage", "1",
                    "--steps", "3", "--sds-start", "0", "--lpips-weights", lpips_path,
                    "--lambda-vgg", "0.1", "--eval", "--sds-mode", mode, "--log-every", "1",
                    "--dump-every", "0", "--val-every", "0", "--device", device,
                    "--out", os.path.join(d, f"imagedream_{mode}")]
            with timed(f"cli imagedream {mode}"):
                secs, text, rows, out = run_train_cli(argv)
            check("precomputed ip tokens for 8 frames (stage 1" in text,
                  f"cli imagedream {mode}: no precomputed-ip-tokens line")
            check(len(rows) == 3 and [("loss_sds" in r) for r in rows] == [False, True, True]
                  and all(np.isfinite(r["loss_vgg"]) for r in rows)
                  and all(np.isfinite(r["loss_sds"]) for r in rows[1:]),
                  f"cli imagedream {mode}: metrics rows {rows}")
            avg = open(os.path.join(out, "test", "average.txt")).read().split()
            check(len(avg) == 3 and np.isfinite(float(avg[2]))
                  and os.path.exists(os.path.join(out, "test", "lpips.txt")),
                  f"cli imagedream {mode}: average.txt {avg}")
            idream[mode] = {"s": secs, "rows": rows, "average": [float(x) for x in avg]}
        l_f, l_s = idream["fused"]["rows"][1]["loss_sds"], idream["split"]["rows"][1]["loss_sds"]
        split_rel = abs(l_s - l_f) / max(abs(l_f), 1e-30)
        print(f"[cli] train --synthetic --guidance imagedream --mock-guidance --stage 1 --steps 3 "
              f"--sds-start 0 --lpips-weights <pickle> --lambda-vgg 0.1 --eval: "
              f"{idream['fused']['s']:.2f} s fused, {idream['split']['s']:.2f} s with --sds-mode "
              f"split; first guided step's loss_sds {l_f:.6g} fused, {l_s:.6g} split (rel diff "
              f"{split_rel:.3g}); loss_vgg {[r['loss_vgg'] for r in idream['fused']['rows']]}; "
              f"average.txt {idream['fused']['average']}")
        check(split_rel <= CLI_SPLIT_RTOL, f"cli: split loss_sds differs by {split_rel:.3g}")

        # Text embeddings from a .npz (seeded) instead of the mock ones.
        emb = os.path.join(d, "prompt.npz")
        rng = np.random.RandomState(3)
        np.savez(emb, cond=rng.randn(77, CONTEXT_DIM).astype(np.float32),
                 uncond=rng.randn(77, CONTEXT_DIM).astype(np.float32))
        with timed("cli mvdream prompt embeddings"):
            secs_emb, _, rows_emb, _ = run_train_cli(
                ["--synthetic", "--guidance", "mvdream", "--mock-guidance", "--prompt-embeddings",
                 emb, "--stage", "1", "--steps", "2", "--sds-start", "0", "--log-every", "1",
                 "--dump-every", "0", "--val-every", "0", "--device", device,
                 "--out", os.path.join(d, "mvdream_emb")])
        check(len(rows_emb) == 2 and "loss_sds" in rows_emb[1]
              and np.isfinite(rows_emb[1]["loss_sds"]), f"cli prompt embeddings: {rows_emb}")
        print(f"[cli] train --synthetic --guidance mvdream --mock-guidance --prompt-embeddings "
              f"<npz> --stage 1 --steps 2 --sds-start 0: {secs_emb:.2f} s; loss_sds "
              f"{rows_emb[1]['loss_sds']:.6g}")
    return {"train_s": train_s, "render_rot_s": total_s - train_s, "export": export,
            "guided_train_s": guided_s, "guided_rows": rows, "imagedream": idream,
            "split_vs_fused_loss_sds_rel": split_rel, "prompt_embeddings_s": secs_emb,
            "prompt_embeddings_rows": rows_emb}


# The real-capture phase: the round-5 evidence capture (20 frames of 512x512,
# the procedural body test:10,7,28, GT avatar subdivided once), trained at the
# full width of the production step (3 subdivisions: 125,664 surfels).
REAL_FRAMES, REAL_SIZE, REAL_BODY_DIMS, REAL_SUBDIV = 20, 512, (10, 7, 28), 3
REAL_STEPS = 8  # per stage; cut here first if the script outgrows its time
# The GT renders' per-tile capacity: the evidence capture's one-off K=1024
# (outputs/evidence_r5/README.md).  At mock_capture's default of 512 its
# frame 0 drops 2,376 splats, in the JAX package's script as in the port.
REAL_GT_K = 1024
# Calls of a stage-1 step (counted from 0) run under host_ops and the
# profiler; they are left out of the ms/step median.
REAL_HOST_OPS_CALL, REAL_PROFILE_CALL = 3, 4


def instrument_train_steps(record):
    """Wraps ``trainer.make_train_step`` (cli.train looks it up at each
    call) so that every step it makes records, per call, the composite
    launches it made and its synced wall ms; a stage-1 step's call
    ``REAL_HOST_OPS_CALL`` runs under :func:`host_ops` and call
    ``REAL_PROFILE_CALL`` under :func:`profile_view`.  Returns the undo."""
    from soar_tpu_torch.render.block_composite import composite_block as bc
    from soar_tpu_torch.train import trainer

    make = trainer.make_train_step

    def make_counted(*args, **kwargs):
        step_fn = make(*args, **kwargs)
        calls = []
        record["stages"].append(calls)

        def step(state, batch, draws):
            f0, b0 = bc.launches, bc.bwd_launches
            n, stage1 = len(calls), len(record["stages"]) == 2
            out = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if stage1 and n == REAL_HOST_OPS_CALL:
                record["host_ops"] = host_ops(lambda: out.append(step_fn(state, batch, draws)))
            elif stage1 and n == REAL_PROFILE_CALL:
                record["profile"] = profile_view(
                    lambda: out.append(step_fn(state, batch, draws)))
            else:
                out.append(step_fn(state, batch, draws))
            torch.cuda.synchronize()
            calls.append({"ms": 1e3 * (time.perf_counter() - t0),
                          "fwd": bc.launches - f0, "bwd": bc.bwd_launches - b0})
            return out[0]

        step.loss_fn, step.sds_prelude = step_fn.loss_fn, step_fn.sds_prelude
        return step

    trainer.make_train_step = make_counted

    def undo():
        trainer.make_train_step = make
    return undo


def time_calls(module, name, record):
    """Wraps ``module.name`` so that each call's synced wall seconds are
    appended to ``record[name]``; returns the undo."""
    fn = getattr(module, name)

    def timed_call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    setattr(module, name, timed_call)
    return lambda: setattr(module, name, fn)


def run_real_capture(device, lpips_path, d):
    """The real-capture path in the directory ``d``: (a) the capture
    written on the card by ``data.mock_capture``; (b) loaded by
    ``data.dataset.load_sequence``, every PNG decoded equal to the uint8
    image ``save_png`` was given; (c) ``cli.train --dataroot`` through
    both stages at full width with mock ImageDream guidance and LPIPS,
    counted (13 forward and 8 backward composite launches a step), one step
    under host_ops and one profiled; (d) ``cli.render_rot`` and
    ``cli.export_mesh`` on its checkpoint with the same capture flags."""
    from soar_tpu_torch.avatar import state as avatar_state
    from soar_tpu_torch.cli import common, export_mesh, render_rot
    from soar_tpu_torch.data import dataset, mock_capture
    from soar_tpu_torch.io.png import read_png
    from soar_tpu_torch.render.block_composite import composite_block as bc

    rep = {}
    cap = os.path.join(d, "capture")
    # ---- (a) the capture, written on the card
    written = {}
    with timed("real capture: write"):
        t0 = time.perf_counter()
        info = mock_capture.make_capture(cap, REAL_FRAMES, REAL_SIZE, *REAL_BODY_DIMS,
                                         subdiv=1, gt_k=REAL_GT_K, device=device,
                                         written=written)
        write_s = time.perf_counter() - t0
    cov = info["coverage"]
    check(len(written) == 4 * REAL_FRAMES and min(cov) >= 0.01,
          f"real capture: {len(written)} PNGs written, coverage {cov}")
    body = "test:" + ",".join(str(x) for x in REAL_BODY_DIMS)
    print(f"[real capture] mock_capture --frames {REAL_FRAMES} --size {REAL_SIZE} "
          f"--joints {REAL_BODY_DIMS[0]} --segments {REAL_BODY_DIMS[1]} --ring "
          f"{REAL_BODY_DIMS[2]} --subdiv 1 --gt-k {REAL_GT_K} on the card: {write_s:.3f} s; "
          f"GT without truncation (overflow 0 on every frame, K={REAL_GT_K}), coverage "
          f"{min(cov):.4f}-{max(cov):.4f} (probe {max(info['probe_coverage'].values()):.4f}), "
          f"transl z {info['transl_z']:+.3f}, GT avatar {info['surfels']} surfels")

    # ---- (b) loaded back
    with timed("real capture: load"):
        t0 = time.perf_counter()
        ds = dataset.load_sequence(cap)
        load_s = time.perf_counter() - t0
    n_png = sum(len([f for f in os.listdir(os.path.join(cap, sub)) if f.endswith(".png")])
                for sub in ("images", "masks", "normal_F", "normal_B"))
    S, F = REAL_SIZE, REAL_FRAMES
    shapes = {k: getattr(ds, k).shape for k in ("images", "masks", "normal_F", "normal_B",
                                                 "normal_mask", "images_crop", "masks_crop")}
    check(shapes == {"images": (F, S, S, 3), "masks": (F, S, S), "normal_F": (F, S, S, 3),
                     "normal_B": (F, S, S, 3), "normal_mask": (F, S, S),
                     "images_crop": (F, 512, 512, 3), "masks_crop": (F, 512, 512)},
          f"real capture: loaded shapes {shapes}")
    check(n_png == 4 * F and np.array_equal(ds.w2c, np.diag([1, -1, -1, 1]).astype(np.float32)),
          f"real capture: {n_png} PNGs, w2c {ds.w2c.tolist()} (want the row 1:3 flip)")
    with timed("real capture: decode check"):
        bad = [p for p, u8 in written.items() if not np.array_equal(read_png(p), u8)]
    check(not bad, f"real capture: decoded PNGs differ from what was written: {bad[:4]}")
    print(f"[real capture] load_sequence: {n_png} PNGs in {load_s:.3f} s (crops included); "
          f"shapes {json.dumps({k: list(v) for k, v in shapes.items()})}; w2c rows 1:3 "
          f"flipped; all {len(written)} decoded PNGs equal the uint8 images written, bit "
          "for bit")
    rep.update(write_s=write_s, load_s=load_s, pngs=n_png, coverage=cov)
    del ds, written

    # ---- (c) the training CLI through both stages
    out = os.path.join(d, "run")
    argv = ["--dataroot", cap, "--smpl-model", body, "--num-subdiv", str(REAL_SUBDIV),
            "--gen-res", "256", "--guidance", "imagedream", "--mock-guidance",
            "--lpips-weights", lpips_path, "--stage", "both", "--steps", str(REAL_STEPS),
            "--sds-start", "0", "--eval", "--log-every", "1", "--device", device,
            "--out", out]
    record = {"stages": []}
    undo = [instrument_train_steps(record), time_calls(common, "real_setup", record),
            time_calls(avatar_state, "reset_field", record)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bc.launches = 0
    bc.bwd_launches = 0
    try:
        with timed("real capture: cli.train"):
            secs, text, rows, _ = run_train_cli(argv)
    finally:
        for u in undo:
            u()
    fwd, bwd = bc.launches, bc.bwd_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    calls = record["stages"]
    check(len(calls) == 2 and all(len(c) == REAL_STEPS for c in calls),
          f"real capture: step calls per stage {[len(c) for c in calls]}")
    per_step = {(c["fwd"], c["bwd"]) for st in calls for c in st}
    check(per_step == {(FWD_PER_STEP, BWD_PER_STEP)},
          f"real capture: composite launches per step {per_step}, want "
          f"{(FWD_PER_STEP, BWD_PER_STEP)}")
    n_steps = 2 * REAL_STEPS
    check(bwd == BWD_PER_STEP * n_steps and fwd >= FWD_PER_STEP * n_steps,
          f"real capture: {fwd} forward, {bwd} backward launches in the CLI run")
    check(len(rows) == n_steps, f"real capture: {len(rows)} metrics rows")
    for r in rows:
        check(all(np.isfinite(r[k]) for k in ("loss", "loss_normal_F", "loss_normal_B")),
              f"real capture: a loss is not finite: {r}")
        check("loss_sds" not in r or np.isfinite(r["loss_sds"]),
              f"real capture: loss_sds not finite: {r}")
    guided = [[("loss_sds" in r) for r in rows if r["stage"] == st] for st in (0, 1)]
    check(guided == [[False] + [True] * (REAL_STEPS - 1)] * 2,
          f"real capture: guided rows {guided} (sds-start 0: from each stage's step 1)")
    cpu_compute, cpu_moves, n_ops, n_syncs = record["host_ops"]
    check(not cpu_compute, f"real capture: an op of a step computed on the CPU: {cpu_compute}")
    prof = record["profile"]
    check(prof["device_busy_ms"] > 0 and prof["composite_fwd_ms"] > 0
          and prof["composite_bwd_ms"] > 0, "real capture: the profiler saw no kernel")
    skip = {REAL_HOST_OPS_CALL, REAL_PROFILE_CALL}
    ms = [float(np.median([c["ms"] for i, c in enumerate(st) if i > 0
                           and not (s == 1 and i in skip)])) for s, st in enumerate(calls)]
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["profiled_wall_ms"]
    check(f"precomputed ip tokens for {F} frames (stage 0" in text
          and f"precomputed ip tokens for {F} frames (stage 1" in text,
          "real capture: no precomputed-ip-tokens lines for both stages")
    avg = [float(x) for x in open(os.path.join(out, "test", "average.txt")).read().split()]
    check(len(avg) == 3 and all(np.isfinite(avg)), f"real capture: average.txt {avg}")
    setup_s, distill_s = record["real_setup"][0], record["reset_field"][0]
    dropped = [r["raster_dropped"] for r in rows]
    capped = [r["raster_capped"] for r in rows]
    print(f"[real capture] cli.train {' '.join(a if a != lpips_path else '<pickle>' for a in argv[:-4])}"
          f": {secs:.2f} s; real_setup {setup_s:.3f} s (field distillation, 1000 steps, "
          f"{distill_s:.3f} s); ms/step (synced, median after the first) stage 0 "
          f"{ms[0]:.3f}, stage 1 {ms[1]:.3f}; per step {[round(c['ms'], 3) for c in calls[0]]}"
          f" and {[round(c['ms'], 3) for c in calls[1]]}; launches fwd {fwd}, bwd {bwd} "
          f"({FWD_PER_STEP} and {BWD_PER_STEP} in every step; the rest the eval's renders); "
          f"raster_dropped {min(dropped):.0f}-{max(dropped):.0f}, raster_capped "
          f"{min(capped):.0f}-{max(capped):.0f}; peak memory {peak_gib:.3f} GiB")
    print(f"[real capture] stage-1 step: {n_ops} aten ops, {n_syncs} host syncs, none "
          f"computed on the CPU (transfers {cpu_moves}); profiled: device busy "
          f"{prof['device_busy_ms']:.3f} ms in {prof['device_kernels']} device ops, wall "
          f"{prof['profiled_wall_ms']:.3f} ms, idle share {prof['idle_share']:.4f}")
    print(f"[real capture] eval after {REAL_STEPS} + {REAL_STEPS} steps (test frames, "
          f"reported, not gated): PSNR {avg[0]:.4f}, SSIM {avg[1]:.4f}, LPIPS {avg[2]:.4f}")
    print("[real capture] last step's metrics " + json.dumps(rows[-1]))
    rep.update(cli_s=secs, real_setup_s=setup_s, distill_s=distill_s, ms_per_step=ms,
               step_ms=[[c["ms"] for c in st] for st in calls], launches_fwd=fwd,
               launches_bwd=bwd, rows=rows, peak_memory_gib=peak_gib, profile=prof,
               aten_ops=n_ops, host_syncs=n_syncs, average=avg)

    # ---- (d) the turntable and the mesh from its checkpoint
    flags = ["--dataroot", cap, "--smpl-model", body, "--num-subdiv", str(REAL_SUBDIV),
             "--device", device]
    ckpt = os.path.join(out, "stage1")
    rot = os.path.join(d, "rot")
    with timed("real capture: render_rot"):
        t0 = time.perf_counter()
        render_rot.main(flags + ["--ckpt", ckpt, "--num-views", "2", "--out", rot])
        rot_s = time.perf_counter() - t0
    pngs = sorted(f for f in os.listdir(rot) if f.endswith(".png"))
    shapes = {read_png(os.path.join(rot, f)).shape for f in pngs}
    check(len(pngs) == 8 and shapes == {(S, S, 3)}, f"real capture: render_rot {pngs} {shapes}")
    obj = os.path.join(d, "mesh.obj")
    with timed("real capture: export_mesh"):
        t0 = time.perf_counter()
        stats = export_mesh.main(flags + ["--ckpt", ckpt, "--field-attrs", "--resolution",
                                          str(EXPORT_RESOLUTION), "--out", obj])
        export_s = time.perf_counter() - t0
    check(read_obj_counts(obj) == (stats["verts"], stats["faces"]) and stats["faces"] > 100,
          f"real capture: export {stats}")
    print(f"[real capture] render_rot --ckpt stage1 --num-views 2: {rot_s:.3f} s, {len(pngs)} "
          f"PNGs of {S}x{S}; export_mesh --ckpt stage1 --field-attrs --resolution "
          f"{EXPORT_RESOLUTION}: {export_s:.3f} s, {stats['verts']} vertices, "
          f"{stats['faces']} faces read back")
    rep.update(render_rot_s=rot_s, export_s=export_s, export=stats)
    return rep


def hold_launches_against_plain(label, fwd, bwd):
    """Every recorded launch (:func:`record_launches`) run again through its
    kernel and held against its plain version on the same inputs, with the
    gates of the synthetic checks (:func:`gate_fwd`, :func:`gate_bwd`).
    Returns the worst share and error over the launches."""
    from soar_tpu_torch.render import block_composite as bc
    from soar_tpu_torch.render.composite import composite_block_bwd_plain, composite_block_plain

    worst = {"fwd_max_abs_err": 0.0, "fwd_share": 0.0, "bwd_max_abs_err": 0.0,
             "bwd_share": 0.0, "bwd_col_rel": 0.0, "channels": sorted(
                 {r[0].shape[-1] - 9 for r in fwd} | {r[0].shape[-1] - 9 for r in bwd})}
    with torch.no_grad():
        for i, (feat, pixf, *consts) in enumerate(fwd):
            args = unpack_feat(feat, pixf)
            errs, share = gate_fwd(f"{label} forward launch {i}",
                                   bc.composite_block(*args, *consts),
                                   composite_block_plain(*args, *consts))
            worst["fwd_max_abs_err"] = max(worst["fwd_max_abs_err"], max(errs.values()))
            worst["fwd_share"] = max(worst["fwd_share"], share)
        for i, (feat, pixf, gacc, gcorr, gT, *consts) in enumerate(bwd):
            got = bc._launch_bwd(feat, pixf, gacc, gcorr, gT, *consts)
            want = composite_block_bwd_plain(*unpack_feat(feat, pixf), gacc, gcorr, gT, *consts)
            rel, share, err = gate_bwd(f"{label} backward launch {i}", got, want)
            worst["bwd_max_abs_err"] = max(worst["bwd_max_abs_err"], err)
            worst["bwd_share"] = max(worst["bwd_share"], share)
            worst["bwd_col_rel"] = max(worst["bwd_col_rel"], max(rel))
    print(f"[main path {label}] {len(fwd)} forward and {len(bwd)} backward launches (C "
          f"{worst['channels']}) held against their plain versions: forward max|kernel-plain| "
          f"{worst['fwd_max_abs_err']:.3g}, pixels beyond {KERNEL_TOL} {worst['fwd_share']:.4%}; "
          f"backward max|kernel-plain|/column max {worst['bwd_col_rel']:.3g}, entries beyond "
          f"{KERNEL_TOL} x column max {worst['bwd_share']:.4%}")
    return worst


# The YAML configs, read on the card by the port's own reader (no PyYAML
# there): (stage, max_steps, loss.mask, max_step_percent) of each.
YAML_CONFIGS = {"configs/surfel_stage0.yaml": (0, 1000, 1.0, (0, 0.75, 0.25, 2000)),
                "configs/surfel_stage1.yaml": (1, 1000, 10.0, (0, 0.75, 0.25, 1000))}


def run_yaml_config():
    import importlib.util

    from soar_tpu_torch.train.yaml_config import load_yaml_config

    root = os.path.dirname(os.path.abspath(__file__))
    out = {}
    for rel, want in YAML_CONFIGS.items():
        t0 = time.perf_counter()
        cfg = load_yaml_config(os.path.join(root, rel))
        secs = time.perf_counter() - t0
        st = cfg["stage"]
        got = (st.training_stage, st.max_steps, st.loss.mask, st.max_step_percent)
        check(got == want, f"yaml config {rel}: {got}, want {want}")
        out[rel] = {"stage": got[0], "max_steps": got[1], "loss_mask": got[2],
                    "max_step_percent": list(got[3]), "s": secs}
        print(f"[yaml config] {rel}: stage {got[0]}, max_steps {got[1]}, loss.mask {got[2]}, "
              f"max_step_percent {list(got[3])}, sds_start {st.sds_start}; read in "
              f"{secs * 1e3:.3f} ms by soar_tpu_torch.io.yaml_subset (PyYAML here: "
              f"{'yes' if importlib.util.find_spec('yaml') else 'no'})")
    return out


# The reference's attribute field at its own widths (SURVEY section 1,
# geometry/sdf_fields.py:68-83): 16 levels from 16 to 2048, 2^18-row tables,
# 2 features a level, 64-wide 2-layer heads.
REF_LEVELS, REF_BASE_RES, REF_MAX_RES, REF_LOG2_ROWS, REF_HIDDEN = 16, 16, 2048, 18, 64
REF_SUBSET = 4096  # points held against the CPU
REF_FIELD_TOL = 1e-5
REF_STEPS = 4


def reference_state_dict(params, model, layout, seed):
    """A Lightning-layout state_dict at the reference's widths: the explicit
    surfel tensors of ``params`` (colours, opacity and occ logits drawn from
    ``seed``) and the attribute field, random from ``seed``, in the tcnn
    layout (packed fp16 grid and MLP buffers; the offsets head is a torch
    Linear stack there, as in the reference) or the torch layout (hash
    tables and Linear stacks); all on the CPU, as a file holds them."""
    from soar_tpu_torch.field.reference_import import tcnn_grid_layout

    g = torch.Generator().manual_seed(seed)
    N = params.xyz.shape[0]

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=g)

    pre = "geometry.attribute_field."
    sd = {
        "geometry._xyz": params.xyz.detach().cpu().clone(),
        "geometry._rotation": params.rotation.detach().cpu().clone(),
        "geometry._scaling": params.scaling.detach().cpu().clone(),
        "geometry._opacity": randn(N, 1),
        "geometry._colors": randn(N, 3),
        "geometry._occ": randn(N, 1),
        "geometry.latent_pose": torch.zeros_like(params.latent_pose.detach().cpu()),
        pre + "aabb": model.aabb.detach().cpu().clone(),
        pre + "num_levels": torch.tensor(REF_LEVELS),
        pre + "max_res": torch.tensor(REF_MAX_RES),
        pre + "log2_hashmap_size": torch.tensor(REF_LOG2_ROWS),
    }
    enc = 2 * REF_LEVELS
    heads = {"mlp_base_shs": 3, "mlp_base_scales": 1, "mlp_base_quats": 4,
             "mlp_base_offsets": 3, "mlp_base_opacities": 1}

    def linear_head(name, out):
        ind = enc + 2 if name == "mlp_base_offsets" else enc
        sd[f"{pre}{name}.layers.0.weight"] = randn(REF_HIDDEN, ind, scale=0.1)
        sd[f"{pre}{name}.layers.0.bias"] = randn(REF_HIDDEN, scale=0.1)
        sd[f"{pre}{name}.layers.1.weight"] = randn(out, REF_HIDDEN, scale=0.1)
        sd[f"{pre}{name}.layers.1.bias"] = randn(out, scale=0.1)

    if layout == "tcnn":
        rows = tcnn_grid_layout(REF_LEVELS, REF_BASE_RES, REF_MAX_RES,
                                REF_LOG2_ROWS).row_offsets[-1]
        for e in ("encoding", "quat_encoding"):
            sd[f"{pre}{e}.tcnn_encoding.params"] = randn(rows * 2, scale=0.01).half()
        for name, out in heads.items():
            if name == "mlp_base_offsets":
                linear_head(name, out)
            else:
                size = REF_HIDDEN * (-(-enc // 16) * 16) + (-(-out // 16) * 16) * REF_HIDDEN
                sd[f"{pre}{name}.tcnn_encoding.params"] = randn(size, scale=0.1).half()
    else:
        for e in ("encoding", "quat_encoding"):
            sd[f"{pre}{e}.hash_table"] = randn(REF_LEVELS << REF_LOG2_ROWS, 2, scale=0.01)
        for name, out in heads.items():
            linear_head(name, out)
    return sd


def run_reference_import(device, d):
    """The reference-checkpoint path at full width, on the capture that
    :func:`run_real_capture` left in ``d/capture``: (a) the avatar
    ``real_setup`` builds there (``test:10,7,28``, 3 subdivisions; its
    surfel count read from it); (b) a Lightning ``.ckpt`` of that many
    surfels with the reference-width field, written in the tcnn and in the
    torch layout (``torch.save``, no file fetched); (c) per layout,
    ``reference_field_apply`` at every surfel on the card, timed, against
    the CPU on a 4,096-point subset; (d) ``cli.train --config
    configs/surfel_stage0.yaml --import-ckpt <tcnn file>`` on the capture,
    4 steps (guided from step 1), counted (13 + 8 launches a step), with ``--trace-steps
    1``; (e) ``cli.render_rot --ckpt <tcnn file>``, counted."""
    import glob

    from soar_tpu_torch.cli import common, render_rot
    from soar_tpu_torch.cli import train as train_cli
    from soar_tpu_torch.field.reference_import import reference_field_apply
    from soar_tpu_torch.io.checkpoint import (
        import_reference_field_from_ckpt,
        load_reference_state_dict,
    )
    from soar_tpu_torch.render.block_composite import composite_block as bc

    rep = {}
    cap = os.path.join(d, "capture")
    body = "test:" + ",".join(str(x) for x in REAL_BODY_DIMS)
    flags = ["--dataroot", cap, "--smpl-model", body, "--num-subdiv", str(REAL_SUBDIV),
             "--device", device]
    with timed("reference import: avatar"):
        _, params, model = common.real_setup(cap, body, num_subdiv=REAL_SUBDIV,
                                             distill_steps=0, device=device)
    N = params.xyz.shape[0]
    check(N == 125_664, f"reference import: the capture's avatar has {N} surfels")
    paths = {}
    for layout, seed in (("tcnn", 21), ("torch", 22)):
        paths[layout] = os.path.join(d, f"reference_{layout}.ckpt")
        with timed("reference import: write"):
            torch.save({"state_dict": reference_state_dict(params, model, layout, seed),
                        "global_step": 0}, paths[layout])
    del params, model
    torch.cuda.empty_cache()

    # ---- (c) the field at every surfel, card against CPU
    fields = {}
    for layout, path in paths.items():
        t0 = time.perf_counter()
        sd = load_reference_state_dict(path)
        load_s = time.perf_counter() - t0
        xyz = sd["geometry._xyz"].to(device)
        rf = import_reference_field_from_ckpt(path, state_dict=sd, device=device)
        rf_cpu = import_reference_field_from_ckpt(path, state_dict=sd, device="cpu")
        check(rf.tcnn == (layout == "tcnn"), f"reference import: {layout} read as another layout")
        with torch.no_grad():
            out = reference_field_apply(rf, xyz)
            torch.cuda.synchronize()
            ms = cuda_ms(lambda: reference_field_apply(rf, xyz), 10)
            sub = torch.randperm(N, generator=torch.Generator().manual_seed(5))[:REF_SUBSET]
            want = reference_field_apply(rf_cpu, xyz.cpu()[sub])
        err = max(float((out[k][sub.to(device)].cpu() - want[k]).abs().max()) for k in want)
        check(all(bool(torch.isfinite(v).all()) for v in out.values()),
              f"reference import: {layout} field output not finite")
        check(err <= REF_FIELD_TOL, f"reference import: {layout} field, card vs CPU {err:.3g}")
        fields[layout] = {"load_s": load_s, "apply_ms": ms, "max_abs_err_vs_cpu": err,
                          "file_mb": os.path.getsize(path) / 2**20}
        print(f"[reference import] {layout} layout ({fields[layout]['file_mb']:.1f} MiB): "
              f"torch.load {load_s:.3f} s; reference_field_apply at {N} points {ms:.3f} ms "
              f"(CUDA events, 10 calls); card vs CPU on {REF_SUBSET} points max|diff| "
              f"{err:.3g} (bound {REF_FIELD_TOL})")
        del sd, xyz, rf, rf_cpu, out
    rep["fields"] = fields

    # ---- (d) the training CLI with --config and --import-ckpt
    out_dir = os.path.join(d, "import_run")
    root = os.path.dirname(os.path.abspath(__file__))
    argv = flags + ["--config", os.path.join(root, "configs/surfel_stage0.yaml"),
                    "--import-ckpt", paths["tcnn"], "--steps", str(REF_STEPS), "--guidance",
                    "imagedream", "--mock-guidance", "--sds-start", "0", "--trace-steps", "1",
                    "--log-every", "1", "--dump-every", "0", "--val-every", "0", "--out",
                    out_dir]
    record = {"stages": []}
    undo = [instrument_train_steps(record), time_calls(common, "real_setup", record),
            time_calls(train_cli, "import_reference_warm_start", record)]
    torch.cuda.synchronize()
    bc.launches = 0
    bc.bwd_launches = 0
    try:
        with timed("reference import: cli.train"):
            secs, text, rows, _ = run_train_cli(argv)
    finally:
        for u in undo:
            u()
    fwd, bwd = bc.launches, bc.bwd_launches
    calls = record["stages"]
    check(len(calls) == 1 and len(calls[0]) == REF_STEPS,
          f"reference import: step calls per stage {[len(c) for c in calls]} (--config: stage 0)")
    per_step = {(c["fwd"], c["bwd"]) for c in calls[0]}
    check(per_step == {(FWD_PER_STEP, BWD_PER_STEP)},
          f"reference import: composite launches per step {per_step}")
    check((fwd, bwd) == (FWD_PER_STEP * REF_STEPS, BWD_PER_STEP * REF_STEPS),
          f"reference import: {fwd} forward, {bwd} backward launches in the CLI run")
    check("--config defines stage 0" in text and "distilled reference attribute field" in text
          and "imported reference ckpt" in text, "reference import: the CLI's import lines")
    check(len(rows) == REF_STEPS and all(np.isfinite(r["loss"]) for r in rows)
          and all(np.isfinite(r["loss_sds"]) for r in rows[1:]) and "loss_sds" not in rows[0],
          f"reference import: metrics rows {rows}")
    traces = glob.glob(os.path.join(out_dir, "trace", "*.json"))
    check(len(traces) == 1 and os.path.getsize(traces[0]) > 0,
          f"reference import: --trace-steps 1 wrote {traces}")
    # Step 0 runs under the trace and step 1 is the first guided step (its
    # networks' first calls): the median is over the steps after them.
    ms = float(np.median([c["ms"] for c in calls[0][2:]]))
    import_s = record["import_reference_warm_start"][0]
    print(f"[reference import] cli.train --dataroot <capture> --smpl-model {body} --num-subdiv "
          f"{REAL_SUBDIV} --config configs/surfel_stage0.yaml --import-ckpt <tcnn file> --steps "
          f"{REF_STEPS} --guidance imagedream --mock-guidance --sds-start 0 --trace-steps 1: "
          f"{secs:.2f} s; real_setup {record['real_setup'][0]:.3f} s; import and distillation "
          f"(1000 steps, minibatch 65,536) {import_s:.3f} s; ms/step (synced, median of steps 2-"
          f"{REF_STEPS - 1}: the trace wraps step 0, step 1 is the first guided) {ms:.3f}, per "
          f"step "
          f"{[round(c['ms'], 3) for c in calls[0]]}; launches fwd {fwd}, bwd {bwd} "
          f"({FWD_PER_STEP} and {BWD_PER_STEP} a step); trace {os.path.basename(traces[0])} "
          f"({os.path.getsize(traces[0]) / 2**20:.2f} MiB); losses {[r['loss'] for r in rows]}")
    rep.update(cli_s=secs, real_setup_s=record["real_setup"][0], import_s=import_s,
               ms_per_step=ms, step_ms=[c["ms"] for c in calls[0]], launches_fwd=fwd,
               launches_bwd=bwd, rows=rows, trace_mib=os.path.getsize(traces[0]) / 2**20)

    # ---- (e) the turntable from the reference .ckpt
    rot = os.path.join(d, "import_rot")
    bc.launches = 0
    tee = _Tee(sys.stdout)
    import contextlib

    with timed("reference import: render_rot"), contextlib.redirect_stdout(tee):
        t0 = time.perf_counter()
        render_rot.main(flags + ["--ckpt", paths["tcnn"], "--num-views", "2", "--out", rot])
        rot_s = time.perf_counter() - t0
    rot_fwd = bc.launches
    pngs = sorted(f for f in os.listdir(rot) if f.endswith(".png"))
    check(len(pngs) == 8 and rot_fwd == 2 * NUM_VIEWS,
          f"reference import: render_rot wrote {pngs}, {rot_fwd} launches")
    check("imported reference attribute field (tcnn layout)" in "".join(tee.text),
          "reference import: render_rot did not render the reference field")
    print(f"[reference import] render_rot --ckpt <tcnn file> --num-views 2: {rot_s:.3f} s "
          f"(the .ckpt read, the field evaluated once at every surfel), {len(pngs)} PNGs, "
          f"{rot_fwd} forward launches")
    rep.update(render_rot_s=rot_s, render_rot_launches=rot_fwd)
    return rep


# The GaussianDreamer step at full width: the bench scene padded to twice its
# surfels, DreamerConfig's defaults (4 views at 256x256, K=96, dup_side 5,
# surface off, sigmoid opacities) and full-shape bf16 mock MVDream guidance.
# Only the cadence is cut, to fit 6 steps: densify at steps 2 and 4; prune at
# step 5, apart from a densify (a densify resets the visibility counts that
# prune reads, so a step that runs both prunes every surfel; ROADMAP Queue 3).
DREAMER_STEPS = 6
DREAMER_CADENCE = dict(densify_from=2, densify_interval=2, prune_from=5, prune_interval=5)
DREAMER_FWD_PER_STEP = 8  # 4 views x (main pass at C=4 + occ pass at C=3)
DREAMER_BWD_PER_STEP = 4  # the 4 main passes (the occ image is not in the loss)
# The first densify's threshold: this quantile of the mean position-gradient
# norm over the surfels a densify could take, so it fills some dead slots.
DREAMER_THRESHOLD_QUANTILE = 0.5
DREAMER_LOSS_RTOL = 1e-3
# The text-only 4-view UNet (sd-v2.1-base-4view): the ImageDream UNet
# without its image-prompt branch.
UNET_PARAMS_MV = 867_572_164
DREAMER_HOST_OPS_STEP, DREAMER_PROFILE_STEP = 1, 3


def run_dreamer(params, model, device):
    """The GaussianDreamer system (``train.systems.make_gaussiandreamer_step``)
    at full width: 6 steps with densify and prune, counted (8 forward and 4
    backward launches a step), one loss step under host_ops (no host sync,
    no op on the CPU) and one profiled; the alive count after each
    ``maintain``; a step's launches recorded, replayed and held against
    their plain versions at C = 4; the kernel step against the plain one
    with float32 networks; a gradient on the opacity logits; dead slots
    never counted visible; parameters and Adam moments finite."""
    import dataclasses

    from soar_tpu_torch.avatar.densify import DensifyState, pad_to_capacity
    from soar_tpu_torch.avatar.optim import make_optimizer
    from soar_tpu_torch.body.skinning import knn_idw_weights
    from soar_tpu_torch.guidance.build import build_guidance
    from soar_tpu_torch.render.block_composite import composite_block as bc
    from soar_tpu_torch.train import systems
    from soar_tpu_torch.train.config import OptimConfig, StageConfig

    N = params.xyz.shape[0]
    cap = 2 * N
    cfg = systems.DreamerConfig(**DREAMER_CADENCE)
    check(cfg.n_views == 4 and cfg.image_size == (256, 256) and cfg.raster.max_per_tile == 96
          and cfg.raster.dup_side == 5 and not cfg.raster.surface
          and not cfg.raster.perpix_depth, f"dreamer: config {cfg}")
    with timed("dreamer: set-up"):
        dp = pad_to_capacity(params, cap)
        with torch.no_grad():
            pw = knn_idw_weights(dp.xyz, model.skin.cano_vertices, model.body.lbs_weights)
        dstate = DensifyState.create(cap, N, device=device)
        opt = make_optimizer(dp, OptimConfig())
        g = build_guidance("mvdream", StageConfig(),
                           generator=torch.Generator(device=device).manual_seed(200), mock=True,
                           image_size=256, n_view=cfg.n_views, dtype=torch.bfloat16,
                           device=device)
        torch.cuda.synchronize()
    n_unet = sum(p.numel() for p in g.unet.parameters())
    check(g.embed_ref is None and n_unet == UNET_PARAMS_MV
          and all(p.dtype == torch.bfloat16 for p in g.unet.parameters()),
          f"dreamer: guidance not the text-only bf16 UNet ({n_unet} parameters, want "
          f"{UNET_PARAMS_MV})")
    loss_step, maintain = systems.make_gaussiandreamer_step(model, cfg, opt, g)
    gen = torch.Generator(device=device).manual_seed(3)
    alive_counts, threshold, eligible, dead_denom = [], None, None, 0.0

    # ---- the main path, counted: launch counters 0 just before, read after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bc.launches = 0
    bc.bwd_launches = 0
    step_ms, metrics, host, prof = [], [], None, None
    with timed("dreamer: 6 steps"):
        for it in range(DREAMER_STEPS):
            draws = systems.sample_dreamer_draws(gen, cfg, latent_size=g.latent_size)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
            if it == DREAMER_HOST_OPS_STEP:
                out = []
                host = host_ops(lambda: out.append(loss_step(dp, dstate, pw, draws, it)))
                dp, dstate, m = out[0]
            elif it == DREAMER_PROFILE_STEP:
                out = []
                prof = profile_view(lambda: out.append(loss_step(dp, dstate, pw, draws, it)))
                dp, dstate, m = out[0]
            else:
                dp, dstate, m = loss_step(dp, dstate, pw, draws, it)
            ev[1].record()
            torch.cuda.synchronize()
            step_ms.append(ev[0].elapsed_time(ev[1]))
            metrics.append({k: float(v) for k, v in m.items()})
            with torch.no_grad():  # slots dead during the step were never counted
                dead_denom = max(dead_denom,
                                 float(torch.where(dstate.alive, 0.0, dstate.denom).max()))
            if it == cfg.densify_from:
                # The threshold, from this run's statistics (read on the host
                # outside the step): the surfels a densify could take are the
                # alive, seen ones that would clone (small, scale gradient
                # <= 1e-7, mean opacity logit <= 2) or split (large).
                den = dstate.denom.clamp_min(1.0)
                small = torch.exp(dp.scaling[:, 0]) <= 0.01 * cfg.extent
                clone_ok = (dstate.scale_grad_accum / den <= 1e-7) & (
                    dstate.opac_accum / den <= 2.0)
                ok = dstate.alive & (dstate.denom > 0) & ((small & clone_ok) | ~small)
                eligible = {"seen": int((dstate.alive & (dstate.denom > 0)).sum()),
                            "small": int((small & dstate.alive).sum()),
                            "clone_ok": int((clone_ok & dstate.alive & small).sum()),
                            "eligible": int(ok.sum())}
                check(eligible["eligible"] > 0, f"dreamer: no surfel can densify: {eligible}")
                gp = (dstate.xyz_grad_accum / den)[ok]
                threshold = float(torch.quantile(gp, DREAMER_THRESHOLD_QUANTILE))
                _, maintain = systems.make_gaussiandreamer_step(
                    model, dataclasses.replace(cfg, densify_grad_threshold=threshold), opt, g)
            dp, dstate, pw = maintain(dp, dstate, pw, it, generator=gen)
            alive_counts.append(int(dstate.alive.sum()))
        torch.cuda.synchronize()
    fwd, bwd = bc.launches, bc.bwd_launches
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check((fwd, bwd) == (DREAMER_FWD_PER_STEP * DREAMER_STEPS,
                         DREAMER_BWD_PER_STEP * DREAMER_STEPS),
          f"dreamer: {fwd} forward, {bwd} backward launches in {DREAMER_STEPS} steps")
    check(all(np.isfinite(v) for r in metrics for v in r.values()),
          f"dreamer: a loss is not finite: {metrics}")
    first = cfg.densify_from
    check(alive_counts[first] > alive_counts[first - 1] == N and max(alive_counts) <= cap,
          f"dreamer: alive counts {alive_counts} (from {N}, capacity {cap})")
    check(alive_counts[first] < cap, f"dreamer: the first densify filled every dead slot")
    cpu_compute, cpu_moves, n_ops, n_syncs = host
    check(not cpu_compute, f"dreamer: an op of the loss step computed on the CPU: {cpu_compute}")
    check(n_syncs == 0, f"dreamer: {n_syncs} host syncs inside loss_step")
    busy = prof["device_busy_ms"]
    check(busy > 0 and prof["composite_fwd_ms"] > 0 and prof["composite_bwd_ms"] > 0,
          "dreamer: the profiler saw no kernel")
    timed_ms = [x for i, x in enumerate(step_ms)
                if i not in (0, DREAMER_HOST_OPS_STEP, DREAMER_PROFILE_STEP)]
    ms = float(np.median(timed_ms))
    prof["idle_share"] = 1.0 - busy / prof["profiled_wall_ms"]
    check(dead_denom == 0.0, f"dreamer: a dead slot was counted visible ({dead_denom})")
    finite = all(bool(torch.isfinite(p).all()) for p in dp.parameters()) and all(
        bool(torch.isfinite(v).all()) for st in opt.adam.state.values()
        for v in st.values() if torch.is_tensor(v))
    check(finite, "dreamer: a parameter or an Adam moment is not finite")
    print(f"[dreamer] {N} surfels at capacity {cap}, 4 views 256x256, K=96, surface off, "
          f"sigmoid opacities, bf16 mock MVDream (UNet {n_unet} parameters, text only): "
          f"{ms:.3f} ms/step (CUDA events, synced; median of steps {[i for i in range(DREAMER_STEPS) if i not in (0, DREAMER_HOST_OPS_STEP, DREAMER_PROFILE_STEP)]}), "
          f"per step {[round(x, 3) for x in step_ms]}; launches fwd {fwd}, bwd {bwd} "
          f"({DREAMER_FWD_PER_STEP} and {DREAMER_BWD_PER_STEP} a step); peak memory "
          f"{peak_gib:.3f} GiB")
    print(f"[dreamer] first densify at step {first}: {eligible}, threshold {threshold:.4g} "
          f"(quantile {DREAMER_THRESHOLD_QUANTILE}); alive after each maintain {alive_counts}; "
          f"losses {[round(r['loss'], 6) for r in metrics]}")
    print(f"[dreamer] loss step: {n_ops} aten ops, {n_syncs} host syncs, none on the CPU "
          f"(transfers {cpu_moves}); profiled: device busy {busy:.3f} ms in "
          f"{prof['device_kernels']} device ops (composite_fwd {prof['composite_fwd_ms']:.3f} ms, "
          f"composite_bwd {prof['composite_bwd_ms']:.3f} ms), wall "
          f"{prof['profiled_wall_ms']:.3f} ms, idle share {prof['idle_share']:.4f}")
    for row in prof["top"][:8]:
        print(f"    {row['ms']:9.4f} ms  x{row['calls']:<5d} {row['name']}")

    # ---- a step's launches, recorded, replayed and held against plain
    draws = systems.sample_dreamer_draws(gen, cfg, latent_size=g.latent_size)

    def loss_and_backward(step_fn):
        opt.zero_grad()
        loss, m, _ = step_fn.loss_fn(dp, pw, draws, DREAMER_STEPS)
        loss.backward()
        return m

    with timed("dreamer: main-path launches replayed"):
        rec_fwd, rec_bwd = record_launches(lambda: loss_and_backward(loss_step))
        check((len(rec_fwd), len(rec_bwd)) == (DREAMER_FWD_PER_STEP, DREAMER_BWD_PER_STEP),
              f"dreamer: recorded {len(rec_fwd)} forward, {len(rec_bwd)} backward launches")
        check({r[0].shape[-1] - 9 for r in rec_fwd} == {3, 4}
              and {r[0].shape[-1] - 9 for r in rec_bwd} == {4},
              "dreamer: the main passes composite other than C=4")
        main_path = replay_launches("dreamer step", rec_fwd, rec_bwd)
        vs_plain = hold_launches_against_plain("dreamer step", rec_fwd, rec_bwd)
        del rec_fwd, rec_bwd

    # ---- the kernel step against the plain one: f32 networks (the bf16
    # weights widened), same state and draws
    with timed("dreamer: kernel vs plain step"):
        g32 = build_guidance("mvdream", StageConfig(),
                             generator=torch.Generator(device=device).manual_seed(200),
                             text_embeddings=g.guidance.text_embeddings, mock=True,
                             image_size=256, n_view=cfg.n_views, dtype=torch.float32,
                             device=device)
        g32.unet.load_state_dict(g.unet.state_dict())
        g32.vae.load_state_dict(g.vae.state_dict())
        kern, _ = systems.make_gaussiandreamer_step(model, cfg, opt, g32)
        plain_cfg = dataclasses.replace(cfg, raster=dataclasses.replace(cfg.raster,
                                                                        composite="plain"))
        plain, _ = systems.make_gaussiandreamer_step(model, plain_cfg, opt, g32)

        def grads_of(step_fn):
            counts = (bc.launches, bc.bwd_launches)
            m = loss_and_backward(step_fn)
            torch.cuda.synchronize()
            grads = {k: p.grad.detach().clone() for k, p in dp.named_parameters()
                     if p.grad is not None and not k.startswith("field.")}
            return ({k: float(v.detach()) for k, v in m.items()}, grads,
                    (bc.launches - counts[0], bc.bwd_launches - counts[1]))

        mk, gk, launched_k = grads_of(kern)
        mp, gp, launched_p = grads_of(plain)
        opt.zero_grad()
        del g32, kern, plain
    check(launched_k == (DREAMER_FWD_PER_STEP, DREAMER_BWD_PER_STEP) and launched_p == (0, 0),
          f"dreamer kernel vs plain: launches {launched_k} and {launched_p}")
    check(set(gk) == set(gp), f"dreamer kernel vs plain: grads of {sorted(gk)} vs {sorted(gp)}")
    loss_rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp}
    grad_rel = {k: float((gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30)) for k in gp}
    opac_max = float(gk["opacity"].abs().max())
    print("[dreamer] kernel vs plain step (f32 networks, same state and draws): loss rel diff "
          + json.dumps({k: float(f"{v:.3g}") for k, v in loss_rel.items()})
          + "; gradient rel L2 diff " + json.dumps({k: float(f"{v:.3g}")
                                                    for k, v in grad_rel.items()})
          + f"; max |dL/d opacity logit| {opac_max:.4g}")
    for k, v in loss_rel.items():
        check(v <= DREAMER_LOSS_RTOL, f"dreamer kernel vs plain: {k} differs by {v:.3g}")
    for k, v in grad_rel.items():
        check(v <= STEP_GRAD_TOL, f"dreamer kernel vs plain: grad of {k} differs by {v:.3g}")
    check(opac_max > 0.0, "dreamer: no render gradient on the opacity logits")
    del g, dp, opt, loss_step, maintain
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "step_ms": step_ms, "launches_fwd": fwd, "launches_bwd": bwd,
            "alive": alive_counts, "capacity": cap, "threshold": threshold,
            "densify_eligible": eligible, "losses": metrics, "peak_memory_gib": peak_gib,
            "profile": prof, "aten_ops": n_ops, "host_syncs": n_syncs,
            "main_path": main_path, "vs_plain": vs_plain,
            "kernel_vs_plain": {"loss_rel": loss_rel, "grad_rel_l2": grad_rel},
            "max_abs_opacity_grad": opac_max, "unet_params": n_unet}


# ------------------------------------------------------------ preprocessing

PREP_FRAMES, PREP_SIZE, PREP_BODY_DIMS = 20, 512, (55, 4, 48)
PREP_GT_K = 1024  # the capture's mesh GT renders without truncation
PREP_TRAIN_STEPS, PREP_SUBDIV = 2, 2  # the training run on the result (cli.train's default)
TEMPLATE_IOU_MIN = 0.7
RASTER_AGREE_MIN = 0.999  # render_mesh on the card against its CPU run


def _patched(owner, name, make):
    """``owner.name`` replaced by ``make(owner.name)`` inside a ``with``."""
    return mock.patch.object(owner, name, make(getattr(owner, name)))


def _synced_ms(fn, record, key):
    def call(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        record.setdefault(key, []).append(1e3 * (time.perf_counter() - t0))
        return out
    return call


def run_preprocess(device, d):
    """The preprocessing path (``soar_tpu_torch.preproc``) at full width in the
    directory ``d``: (1) the mock SMPL-X body (``make_test_body(55, 4, 48)``
    dressed with landmark tables, 10,608 vertices) written as an ``.npz`` and
    read back equal; (2) a 20-frame 512x512 capture of it from its mesh
    (``data.mock_capture`` with ``mesh=True``, K = 1024, exact); (3) the
    external tools' outputs made from the capture's own parameters
    (OpenPose JSON, SMPLer-X results perturbed 0.1 rad, meta JSON), the
    capture's params, masks and normal maps moved aside; (4)
    ``compute_kp_and_mask --mask-backend sam`` with a mock full ViT-H
    checkpoint (keys held to the manifest, written in bf16, read in f32)
    over the 20 frames, then the capture's masks back; (5)
    ``preprocess_custom`` with a mock full-shape ECON checkpoint: SMPLify
    and the NormalNet normal maps, gated (keys, reprojection error under
    half the initialisation's, the body pose nearer the truth, RGBA 512²
    with the cropped mask in alpha, no CPU op in one ``render_mesh`` and
    one NormalNet call, ``render_mesh`` card = CPU); (6) the template
    fallback on a copy, its IoU against the capture's cropped mask; (7)
    ``cli.train --dataroot`` on the result, 2 steps a stage, counted."""
    import shutil

    from soar_tpu_torch.body.model import load_smplx_npz, save_smplx_npz, smplx_forward_full
    from soar_tpu_torch.data import mock_capture
    from soar_tpu_torch.data.dataset import _load_params_pth, _mask_channel
    from soar_tpu_torch.guidance.manifest import sam_vit_h_key_manifest
    from soar_tpu_torch.io.png import read_png
    from soar_tpu_torch.preproc import (compute_kp_and_mask, compute_normal, compute_smplx,
                                        normal_net, preprocess_custom, smplify)
    from soar_tpu_torch.preproc import sam as sam_mod
    from soar_tpu_torch.preproc.keypoints import load_keypoints
    from soar_tpu_torch.render import mesh_raster
    from soar_tpu_torch.render.block_composite import composite_block as bc

    rep = {}
    root = os.path.join(d, "prep")
    cap = os.path.join(root, "seq")
    aside = os.path.join(d, "aside")
    F, S = PREP_FRAMES, PREP_SIZE
    # ---- (1) the body, (2) the capture, (3) the external tools' outputs
    with timed("preprocess: body, capture, tool outputs"):
        body = mock_capture.mock_smplx_body(*PREP_BODY_DIMS, device=device)
        npz = os.path.join(d, "mock_smplx.npz")
        save_smplx_npz(npz, body)
        back = load_smplx_npz(npz, device=device)
        same = all(torch.equal(getattr(body, k).to(getattr(back, k).dtype), getattr(back, k))
                   if torch.is_tensor(getattr(body, k)) else getattr(body, k) == getattr(back, k)
                   for k in body._fields)
        check(same and body.num_verts == 10_608 and body.num_joints == 55,
              f"preprocess: the npz body does not read back equal (V {body.num_verts})")
        t0 = time.perf_counter()
        info = mock_capture.make_capture(cap, F, S, subdiv=0, gt_k=PREP_GT_K, device=device,
                                         body=body, mesh=True)
        cap_s = time.perf_counter() - t0
        check(min(info["coverage"]) > 0.05, f"preprocess: capture coverage {info['coverage']}")
        truth_pth = _load_params_pth(os.path.join(cap, "smplx", "params.pth"))
        Ks = truth_pth["Ks"]
        truth = mock_capture.smplx_segments(truth_pth)
        init = mock_capture.write_tool_outputs(cap, body, truth, Ks, seed=11)
        os.makedirs(aside)
        for sub in ("masks", "normal_F", "normal_B", os.path.join("smplx", "params.pth")):
            shutil.move(os.path.join(cap, sub), os.path.join(aside, os.path.basename(sub)))
    print(f"[preprocess] mock SMPL-X body: make_test_body{PREP_BODY_DIMS} dressed with "
          f"landmark tables, {body.num_verts} vertices, {body.faces.shape[0]} faces, written "
          f"as an npz and read back equal; capture {F} frames of {S}x{S} from its mesh "
          f"(K={PREP_GT_K}, no truncation) in {cap_s:.3f} s, coverage "
          f"{min(info['coverage']):.4f}-{max(info['coverage']):.4f}; OpenPose/SMPLer-X outputs "
          f"from its parameters (body pose +{mock_capture.TOOL_POSE_NOISE} rad, transl "
          f"+{mock_capture.TOOL_TRANSL_NOISE})")
    rep.update(capture_s=cap_s, coverage=info["coverage"])

    # ---- (4) SAM ViT-H masks
    sam_rec = {}
    with timed("preprocess: SAM"):
        ckpt = os.path.join(d, "sam_vit_h_mock.pth")
        torch.manual_seed(13)
        with torch.device(device):
            model = sam_mod.SAM()
        sd = model.state_dict()
        check({k: tuple(v.shape) for k, v in sd.items()} == sam_vit_h_key_manifest(),
              "preprocess: the SAM state_dict's keys differ from sam_vit_h_key_manifest")
        sam_params = sum(v.numel() for v in sd.values())
        torch.save({k: v.to(torch.bfloat16).cpu() for k, v in sd.items()}, ckpt)
        ckpt_mb = os.path.getsize(ckpt) / 2**20
        del model, sd
        torch.cuda.empty_cache()

        def timed_call(call):
            def wrapped(self, img, pts):
                sam_rec["predictor"] = self
                return _synced_ms(call, sam_rec, "ms")(self, img, pts)
            return wrapped

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _patched(sam_mod.SamPredictor, "__call__", timed_call):
            compute_kp_and_mask.main(["--data-dir", cap, "--mask-backend", "sam",
                                      "--sam-checkpoint-path", ckpt, "--device", device])
        sam_s = time.perf_counter() - t0
        sam_peak = torch.cuda.max_memory_allocated() / 2**30
        pred = sam_rec.pop("predictor")
        check(all(p.dtype == torch.float32 and p.device.type == "cuda"
                  for p in pred.sam.parameters()), "preprocess: SAM not float32 on the card")
        side = pred.sam.cfg.img_size
        x = torch.randn(1, 3, side, side, device=device)
        with torch.no_grad():
            enc_ms = cuda_ms(lambda: pred.sam.image_encoder(x), iters=3, warmup=1)
        del pred, x
        os.remove(ckpt)
        torch.cuda.empty_cache()
        masks = [read_png(os.path.join(cap, "masks", f"{i:05d}.png")) for i in range(F)]
        check(len(os.listdir(os.path.join(cap, "masks"))) == F
              and all(m.shape == (S, S) and set(np.unique(m)) <= {0, 255} for m in masks),
              "preprocess: SAM masks are not binary 512x512 PNGs, one a frame")
        sam_cover = float(np.mean([(m > 0).mean() for m in masks]))
        shutil.rmtree(os.path.join(cap, "masks"))
        shutil.move(os.path.join(aside, "masks"), os.path.join(cap, "masks"))
    ms = sam_rec["ms"]
    print(f"[preprocess] compute_kp_and_mask --mask-backend sam: SAM ViT-H {sam_params} "
          f"parameters (keys = sam_vit_h_key_manifest), mock checkpoint {ckpt_mb:.1f} MiB in "
          f"bf16, read as float32; {F} frames in {sam_s:.3f} s (load included), ms/frame "
          f"median {np.median(ms):.3f} (first {ms[0]:.3f}), image encoder {enc_ms:.3f} ms at "
          f"1024x1024 (CUDA events); peak memory {sam_peak:.3f} GiB; masks binary {S}x{S} (mean "
          f"cover {sam_cover:.4f}: mock weights, not gated); the capture's masks put back")
    rep.update(sam_params=sam_params, sam_s=sam_s, sam_ms_per_frame=ms, sam_encoder_ms=enc_ms,
               sam_peak_gib=sam_peak)

    # ---- (5) SMPLify and the NormalNet normal maps through preprocess_custom
    rec = {}
    with timed("preprocess: preprocess_custom"):
        econ = os.path.join(d, "econ_normal_mock.ckpt")
        torch.manual_seed(17)
        with torch.device(device):
            net = normal_net.NormalNet()
        nn_params = sum(p.numel() for p in net.parameters())
        torch.save({"state_dict": {k: v.to(torch.bfloat16).cpu()
                                   for k, v in net.state_dict().items()}}, econ)
        del net
        torch.cuda.empty_cache()

        def fit(orig):
            def wrapped(self, *a, **kw):
                out = orig(self, *a, **kw)
                rec["smplify"] = self.history
                return out
            return wrapped

        def raster(orig):
            def wrapped(*args, **kwargs):
                rec.setdefault("raster_args", args)
                out = _synced_ms(orig, rec, "raster_ms")(*args, **kwargs)
                rec.setdefault("overflow", []).append(out["overflow"].tolist())
                return out
            return wrapped

        def normal_model(orig):
            def wrapped(*a):
                net = orig(*a)
                rec["net"] = net
                fwd = net.forward

                def forward(*x):
                    rec.setdefault("net_args", x)
                    return _synced_ms(fwd, rec, "net_ms")(*x)
                net.forward = forward
                return net
            return wrapped

        stage = {}
        t0 = time.perf_counter()
        with _patched(smplify.SMPLify, "fit", fit), \
                _patched(compute_normal, "render_mesh", raster), \
                _patched(compute_normal, "_normal_model", normal_model), \
                _patched(compute_smplx, "main", lambda f: _wall(f, stage, "compute_smplx")), \
                _patched(compute_normal, "main", lambda f: _wall(f, stage, "compute_normal")):
            preprocess_custom.main(["--video-path", os.path.join(root, "seq.mp4"),
                                    "--data-root", root, "--smpl-model", npz,
                                    "--econ-ckpt", econ, "--device", device])
        prep_s = time.perf_counter() - t0
        os.remove(econ)

        fitted = _load_params_pth(os.path.join(cap, "smplx", "params.pth"))
        want_keys = set(compute_smplx.SMPLERX_KEYS) | {"Ks", "w2c", "img_wh", "normal_Ks"}
        check(want_keys <= set(fitted) and fitted["body_pose"].shape == (F, 21, 3)
              and fitted["normal_Ks"].shape == (F, 3, 3),
              f"preprocess: params.pth keys {sorted(fitted)}")
        kps = load_keypoints(os.path.join(cap, "keypoints"))
        src, dst, _ = smplify.smplx_to_openpose137()
        conf = kps[..., 2] > 0

        def reproj(p):
            p = {k: torch.as_tensor(np.asarray(p[k], np.float32)).reshape(F, -1).to(device)
                 for k in compute_smplx.SMPLERX_KEYS}
            with torch.no_grad():
                _, j144 = smplx_forward_full(body, p)
                k3 = smplify.convert_kps_137(j144, torch.as_tensor(src), torch.as_tensor(dst))
            px = np.einsum("fij,fkj->fki", Ks, k3.cpu().numpy())
            px = px[..., :2] / np.maximum(px[..., 2:], 1e-5)
            return float(np.abs(px - kps[..., :2])[conf].mean())

        err0, err1 = reproj(init), reproj(fitted)
        check(err1 < 0.5 * err0, f"preprocess: reprojection error {err1:.4f} px not under half "
              f"the initialisation's {err0:.4f}")
        pose0 = float(np.abs(init["body_pose"] - truth["body_pose"]).mean())
        pose1 = float(np.abs(fitted["body_pose"].reshape(F, -1) - truth["body_pose"]).mean())
        check(pose1 < pose0, f"preprocess: fitted body pose {pose1:.4f} rad from the truth, "
              f"the initialisation {pose0:.4f}")
        check(len(rec["net_ms"]) == F and len(rec["raster_ms"]) == 2 * F,
              f"preprocess: NormalNet ran {len(rec.get('net_ms', []))} times, render_mesh "
              f"{len(rec.get('raster_ms', []))} (want {F} and {2 * F}: no template fallback)")
        crops = []  # each frame's mask cropped as compute_normal crops it
        for i in range(F):
            m = _mask_channel(read_png(os.path.join(cap, "masks", f"{i:05d}.png"))) > 0
            mx, my = (torch.from_numpy(g).to(device) for g in
                      compute_normal.crop_grid(compute_normal.mask_bbox(m), (512, 512)))
            crops.append(compute_normal.remap_bilinear(
                torch.from_numpy(m.astype(np.float32)).to(device)[..., None], mx, my)[..., 0])
        alpha_ok = []
        for i, crop in enumerate(crops):
            want = (np.clip(crop.cpu().numpy(), 0, 1) * 255).astype(np.uint8)
            for sub in ("normal_F", "normal_B"):
                png = read_png(os.path.join(cap, sub, f"{i:05d}.png"))
                alpha_ok.append(png.shape == (512, 512, 4) and np.array_equal(png[..., 3], want))
        check(all(alpha_ok), f"preprocess: {alpha_ok.count(False)} normal PNGs are not RGBA "
              "512x512 with the cropped mask in alpha")

        net_in = rec.pop("net_args")
        net = rec.pop("net")
        cpu_raster = host_ops(lambda: mesh_raster.render_mesh(*rec["raster_args"]))[0]
        with torch.no_grad():
            cpu_net = host_ops(lambda: net(*net_in))[0]
        check(not cpu_raster and not cpu_net, f"preprocess: ops computed on the CPU: "
              f"render_mesh {cpu_raster}, NormalNet {cpu_net}")
        del net, net_in
        agree = {}
        args = rec.pop("raster_args")
        for side in ("front", "back"):
            a = list(args)
            if side == "back":
                a[3] = a[3].clone()
                a[3][2] *= -1.0
            on_card = mesh_raster.render_mesh(*a)
            on_cpu = mesh_raster.render_mesh(*(x.cpu() if torch.is_tensor(x) else x for x in a))
            same_px = ((on_card["mask"].cpu() == on_cpu["mask"])[..., 0]
                       & ((on_card["normal"].cpu() - on_cpu["normal"]).abs().amax(-1) <= 1e-4)
                       & ((on_card["depth"].cpu() - on_cpu["depth"]).abs()
                          <= 1e-4 * (1 + on_cpu["depth"].abs())))
            agree[side] = float(same_px.float().mean())
            check(agree[side] >= RASTER_AGREE_MIN and torch.equal(
                on_card["overflow"].cpu(), on_cpu["overflow"]),
                f"preprocess: render_mesh {side} on the card agrees with the CPU on "
                f"{agree[side]:.5f} of pixels (overflow {on_card['overflow'].tolist()} vs "
                f"{on_cpu['overflow'].tolist()})")
        del args
        torch.cuda.empty_cache()
    hist = rec["smplify"]
    ov = np.asarray(rec["overflow"])
    rm = np.asarray(rec["raster_ms"]).reshape(F, 2)
    print(f"[preprocess] preprocess_custom --smpl-model <npz> --econ-ckpt <mock ECON, "
          f"{nn_params} parameters, bf16 file> --device {device}: {prep_s:.3f} s "
          f"(compute_smplx {stage['compute_smplx']:.3f} s, compute_normal "
          f"{stage['compute_normal']:.3f} s; frames, keypoints and masks present)")
    print("[preprocess] SMPLify over " + str(F) + " frames jointly: " + "; ".join(
        f"{name} {len(h['values'])} steps in {h['seconds']:.3f} s, function evaluations per "
        f"step mean {np.mean(h['evaluations']):.2f} max {max(h['evaluations'])}, loss "
        f"{h['values'][0]:.6g} -> {h['values'][-1]:.6g}"
        for name, h in zip(("body", "body+hands"), hist))
        + f"; reprojection error over the confident columns {err0:.4f} -> {err1:.4f} px; body "
        f"pose from the truth {pose0:.5f} -> {pose1:.5f} rad (mean |.|)")
    print(f"[preprocess] render_mesh at the 512x512 crop, K=64: front median "
          f"{np.median(rm[:, 0]):.3f} ms, back {np.median(rm[:, 1]):.3f} ms (synced, per pass); "
          f"overflow [dropped, capped] max {ov.max(0).tolist()}, capped total "
          f"{int(ov[:, 1].sum())}; card = CPU on {agree['front']:.5f} / {agree['back']:.5f} of "
          f"pixels; NormalNet median {np.median(rec['net_ms']):.3f} ms/frame (first "
          f"{rec['net_ms'][0]:.3f}); no op on the CPU in either; normal PNGs RGBA 512x512 with "
          f"the cropped mask in alpha")
    rep.update(preprocess_s=prep_s, stage_s=stage, smplify=hist, reproj_px=[err0, err1],
               pose_err=[pose0, pose1], raster_ms=rm.tolist(), overflow=ov.tolist(),
               raster_card_cpu_agree=agree, normalnet_params=nn_params,
               normalnet_ms=rec["net_ms"])

    # ---- (6) the template fallback on a copy
    with timed("preprocess: template fallback"):
        copy = os.path.join(d, "template", "seq")
        shutil.copytree(cap, copy, ignore=shutil.ignore_patterns("normal_F", "normal_B"))
        frec = {}

        def front_masks(orig):
            def wrapped(*args, **kwargs):
                out = orig(*args, **kwargs)
                frec.setdefault("masks", []).append(out["mask"][..., 0] > 0.5)
                return out
            return wrapped

        with _patched(compute_normal, "render_mesh", front_masks):
            compute_normal.main(["--data-dir", copy, "--smpl-model", npz, "--fallback",
                                 "template", "--device", device])
        ious = []
        for i, crop in enumerate(crops):
            tmpl, crop = frec["masks"][2 * i], crop > 0.5
            ious.append(float((tmpl & crop).sum() / (tmpl | crop).sum()))
        shutil.rmtree(os.path.dirname(copy))
    check(min(ious) >= TEMPLATE_IOU_MIN, f"preprocess: template IoU {min(ious):.4f} < "
          f"{TEMPLATE_IOU_MIN}")
    print(f"[preprocess] compute_normal --fallback template on a copy: IoU of the template's "
          f"front mask against the capture's cropped mask min {min(ious):.4f}, median "
          f"{np.median(ious):.4f} (gate {TEMPLATE_IOU_MIN})")
    rep.update(template_iou=ious)

    # ---- (7) training on the result
    out = os.path.join(d, "prep_run")
    argv = ["--dataroot", cap, "--smpl-model", npz, "--num-subdiv", str(PREP_SUBDIV), "--stage",
            "both", "--steps", str(PREP_TRAIN_STEPS), "--log-every", "1", "--device", device,
            "--out", out]
    record = {"stages": []}
    undo = instrument_train_steps(record)
    bc.launches = 0
    bc.bwd_launches = 0
    try:
        with timed("preprocess: cli.train"):
            secs, _, rows, _ = run_train_cli(argv)
    finally:
        undo()
    fwd, bwd = bc.launches, bc.bwd_launches
    calls = record["stages"]
    per_step = {(c["fwd"], c["bwd"]) for st in calls for c in st}
    check(len(calls) == 2 and all(len(c) == PREP_TRAIN_STEPS for c in calls)
          and per_step == {(FWD_PER_STEP, BWD_PER_STEP)},
          f"preprocess: training step calls {[len(c) for c in calls]}, launches per step "
          f"{per_step}, want {(FWD_PER_STEP, BWD_PER_STEP)}")
    check(len(rows) == 2 * PREP_TRAIN_STEPS and all(
        np.isfinite(r[k]) for r in rows for k in ("loss", "loss_normal_F", "loss_normal_B")),
        f"preprocess: training rows {rows}")
    print(f"[preprocess] cli.train --dataroot <the preprocessed capture> --smpl-model <npz> "
          f"--stage both --steps {PREP_TRAIN_STEPS}: {secs:.3f} s; launches fwd {fwd}, bwd "
          f"{bwd} ({FWD_PER_STEP} and {BWD_PER_STEP} in every step); ms/step "
          f"{[round(c['ms'], 3) for st in calls for c in st]}; losses "
          f"{[round(r['loss'], 5) for r in rows]}")
    rep.update(train_s=secs, launches_fwd=fwd, launches_bwd=bwd, rows=rows)
    return rep


def _wall(fn, record, key):
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        record[key] = time.perf_counter() - t0
        return out
    return call


def ptxas_summary(log):
    """Registers and spill bytes per kernel instance from an ``-Xptxas -v``
    log, keyed by the instance's template arguments (C=7 for
    ``composite_fwd_kernel<7>``; ``<true>``/``<false>`` for the tile
    composite's depth flag)."""
    import re

    out, key = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)", line)
        if m:
            args = re.search(r"I(L[ib]\d+E)+E", m.group(1))
            key = (re.sub(r"Li(\d+)E", r"C=\1 ", args.group(0)).replace("Lb1E", "true ")
                   .replace("Lb0E", "false ")[1:-1].strip() if args else m.group(1))
            out.setdefault(key, {"registers": None, "spill_stores": 0, "spill_loads": 0})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and key:
            out[key]["spill_stores"], out[key]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            out[key]["registers"] = int(m.group(1))
    return out


def main_path_keys(name, paths, counted):
    """The kernels line's main_path_* keys of kernel ``name``: per path (a
    training step, a bench-camera view), the summed device ms and bound of
    its recorded launches, and ``counted``, the path's launches per step or
    view in its counted run, which the recorded launches must match."""
    for path, rep in paths.items():
        check(rep[name]["launches"] == counted[path],
              f"{name}: {rep[name]['launches']} launches recorded in a {path}, "
              f"{counted[path]} counted")
    return {"main_path_ms": {path: rep[name]["ms"] for path, rep in paths.items()},
            "main_path_bound_ms": {path: rep[name]["bound_ms"] for path, rep in paths.items()},
            "main_path_launches": dict(counted)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--export-resolution", type=int, default=EXPORT_RESOLUTION,
                    help="grid resolution of the full-width export (the export CLI's "
                    "default is 128)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    import soar_tpu_torch  # noqa: F401  (fails outside the repository)
    from soar_tpu_torch import kernels

    info = card_info()
    print(f"[card] {info['kind']} x{info['count']}; torch {info['torch']} "
          f"(CUDA {info['torch_cuda']}), python {info['python']}, {info['nvcc']}, "
          f"triton {info['triton']}, CUTLASS headers {info['cutlass_headers']}")

    t0 = time.perf_counter()
    with timed("build"):
        built = kernels.build()
        print(f"[build] {sorted(built)} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
        ptxas = {}
        for name in kernels.SOURCES:
            kernels.load(name)
            ptxas[name] = ptxas_summary(kernels.ptxas_report(name))
            print(f"[build] {name}: registers and spill stores/loads (bytes) per kernel "
                  "instance: " + "; ".join(f"{k} {v['registers']} regs, {v['spill_stores']}/"
                                          f"{v['spill_loads']}" for k, v in ptxas[name].items()))
            check(all(v["spill_stores"] == v["spill_loads"] == 0
                      for v in ptxas[name].values()), f"{name}: ptxas reports spills")

    with timed("yaml config"):
        yaml_cfg = run_yaml_config()

    with timed("kernel checks"):
        comp = [check_composite_kernel(7, seed=0), check_composite_kernel(3, seed=1)]
        comp_bwd = [check_composite_bwd_kernel(1024, 7, seed=2),
                    check_composite_bwd_kernel(1024, 3, seed=3),
                    check_composite_bwd_kernel(256, 7, seed=4)]

    t0 = time.perf_counter()
    with timed("scene"):
        ds, params, model = slice_scene("cuda")
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    N = params.xyz.shape[0]
    check(N == 125_664, f"surfel count {N} != 125664")
    print(f"[slice] scene: {N} surfels, field 16 levels x 2^18 rows, 512x512, "
          f"set-up {setup_s:.2f} s")
    views, ov = slice_views(ds, params, model, "cuda")
    with timed("turntable and views"):
        sl = run_slice(ds, params, model, views, ov, "cuda")
    sl["setup_s"] = setup_s
    with timed("view: main-path launches replayed"), torch.no_grad():
        rec_fwd, rec_bwd = record_launches(view_fn(params, model, views["bench"], ov))
        check((len(rec_fwd), len(rec_bwd)) == (2, 0),
              f"bench view: recorded {len(rec_fwd)} forward, {len(rec_bwd)} backward launches")
        sl["main_path"] = replay_launches("bench view", rec_fwd, rec_bwd)
        del rec_fwd, rec_bwd
    # The tile composite's checks use the profiler, so they come after the
    # views' timings: the earlier paths are timed as they were before.
    with timed("tile lists"):
        tl = run_tile_lists(params, model, views, ov)
        with torch.no_grad():
            comp_tiles = check_composite_tiles("synthetic", tiles_scene(seed=5))
    with timed("oracle probe"):
        probe = run_oracle_probe(params, model, views, ov)
    with timed("export at full width"):
        export_full = run_export_full(params, model, args.export_resolution)
    with timed("train: dataset"):
        ds_train = train_dataset(ds)
    tmp = tempfile.TemporaryDirectory()
    lpips_path = os.path.join(tmp.name, "lpips_vgg16.pkl")
    with timed("LPIPS weights"):
        import pickle

        from soar_tpu_torch.train.lpips import mock_lpips_variables

        with open(lpips_path, "wb") as f:  # drawn on the card from seed 7
            pickle.dump(mock_lpips_variables(seed=7, device="cuda"), f)
    tr = run_training(ds_train, params, model, "cuda", lpips_path)
    g, ip_table, image_prompt = run_image_prompt(ds_train, "cuda")
    guided = run_guided_training(ds_train, params, model, "cuda", g, ip_table, lpips_path)
    del g, ip_table
    torch.cuda.empty_cache()
    with timed("cli and export"):
        cli = run_cli("cuda", lpips_path)
    torch.cuda.empty_cache()
    real = run_real_capture("cuda", lpips_path, tmp.name)
    torch.cuda.empty_cache()
    ref_import = run_reference_import("cuda", tmp.name)
    tmp.cleanup()
    torch.cuda.empty_cache()
    dreamer = run_dreamer(params, model, "cuda")
    del params, model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as prep_dir:
        prep = run_preprocess("cuda", prep_dir)
    torch.cuda.empty_cache()

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")
    block_keys = keys + ("device_ms",)
    tiles_keys = ("device_ms", "wrapper_device_ops", "heaviest_tile_slot_bound",
                  "heaviest_tile_walked", "ns_per_slot_heaviest")
    fwd = {
        "name": "composite_fwd",
        "route": "cuda",
        "source": "soar_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "soar_tpu/render/block_composite.py:205",
        "launches": tr["launches_fwd"],
        "launches_turntable": sl["launches"],
        "launches_guided_train": guided["launches_fwd"],
        "launches_real_capture_cli": real["launches_fwd"],
        "launches_reference_import_cli": ref_import["launches_fwd"],
        "launches_reference_import_render_rot": ref_import["render_rot_launches"],
        "launches_dreamer": dreamer["launches_fwd"],
        "launches_preprocess_train": prep["launches_fwd"],
        "max_abs_err": max(c["max_abs_err"] for c in comp),
        "ms": comp[0]["ms"],
        "plain_ms": comp[0]["plain_ms"],
        "bound_ms": comp[0]["bound_ms"],
        "bound_by": comp[0]["bound_by"],
        "library_ms": None,
        "device_ms": comp[0]["device_ms"],
        "occ_C3": {k: comp[1][k] for k in block_keys},
        "dreamer_step_vs_plain": {k: dreamer["vs_plain"][k]
                                  for k in ("fwd_max_abs_err", "fwd_share", "channels")},
        **main_path_keys("composite_fwd", {"train_step": tr["main_path"],
                                           "bench_view": sl["main_path"],
                                           "dreamer_step": dreamer["main_path"]},
                         {"train_step": tr["launches_fwd"] // TRAIN_STEPS,
                          "bench_view": sl["launches"] // NUM_VIEWS,
                          "dreamer_step": dreamer["launches_fwd"] // DREAMER_STEPS}),
    }
    bwd = {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "soar_tpu_torch/csrc/composite_bwd.cu",
        "replaces": "soar_tpu/render/block_composite.py:226",
        "launches": tr["launches_bwd"],
        "launches_guided_train": guided["launches_bwd"],
        "launches_real_capture_cli": real["launches_bwd"],
        "launches_reference_import_cli": ref_import["launches_bwd"],
        "launches_dreamer": dreamer["launches_bwd"],
        "launches_preprocess_train": prep["launches_bwd"],
        "max_abs_err": max(c["max_abs_err"] for c in comp_bwd),
        "ms": comp_bwd[0]["ms"],
        "plain_ms": comp_bwd[0]["plain_ms"],
        "bound_ms": comp_bwd[0]["bound_ms"],
        "bound_by": comp_bwd[0]["bound_by"],
        "library_ms": None,
        "device_ms": comp_bwd[0]["device_ms"],
        "occ_C3": {k: comp_bwd[1][k] for k in block_keys},
        "gen_NT256": {k: comp_bwd[2][k] for k in block_keys},
        "dreamer_step_vs_plain": {k: dreamer["vs_plain"][k]
                                  for k in ("bwd_max_abs_err", "bwd_share", "bwd_col_rel")},
        **main_path_keys("composite_bwd", {"train_step": tr["main_path"],
                                           "dreamer_step": dreamer["main_path"]},
                         {"train_step": tr["launches_bwd"] // TRAIN_STEPS,
                          "dreamer_step": dreamer["launches_bwd"] // DREAMER_STEPS}),
    }
    tiles = {
        "name": "composite_tiles",
        "route": "cuda",
        "source": "soar_tpu_torch/csrc/composite_tiles.cu",
        "replaces": "soar_tpu/render/pallas_composite.py:41",
        "launches": tl["launches"],
        "max_abs_err": max([comp_tiles["max_abs_err"]]
                           + [v["max_abs_err"] for v in tl["views"].values()]),
        "ms": comp_tiles["ms"],
        "plain_ms": comp_tiles["plain_ms"],
        "bound_ms": comp_tiles["bound_ms"],
        "bound_by": comp_tiles["bound_by"],
        "library_ms": None,
        "device_ms": comp_tiles["device_ms"],
        **{f"{label}_view": {k: v[k] for k in keys + tiles_keys}
           for label, v in tl["views"].items()},
        **{k: comp_tiles[k] for k in tiles_keys[1:]},
    }
    # The same numbers under shorter names.
    for entry in (fwd, bwd, tiles):
        entry.update(max_err=entry["max_abs_err"], kernel_ms=entry["ms"])
    WALL_S["total after imports"] = time.perf_counter() - T_START
    print("[time] wall s per phase: " + ", ".join(f"{k} {v:.2f}" for k, v in WALL_S.items()))
    new_s = sum(v for k, v in WALL_S.items() if k.startswith("preprocess"))
    print(f"[time] the [preprocess] phase: {new_s:.2f} s")
    report = {"card": info, "ptxas": ptxas, "kernels": comp, "kernels_bwd": comp_bwd,
              "kernels_tiles": comp_tiles, "slice": sl, "tile_lists": tl, "oracle_probe": probe,
              "export_full": export_full, "training": tr, "image_prompt": image_prompt,
              "guided_training": guided, "cli": cli, "real_capture": real,
              "yaml_config": yaml_cfg, "reference_import": ref_import, "dreamer": dreamer,
              "preprocess": prep, "wall_s": WALL_S}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(info["nvidia_smi"])
    print(json.dumps({"kernels": [fwd, bwd, tiles]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))


if __name__ == "__main__":
    main()
