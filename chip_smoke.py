"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card, its power limit and the toolchain.
2. Builds every CUDA kernel of the port from ``soar_tpu_torch/csrc`` with
   nvcc (sm_90a), one process per source, all started together.
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes the turntable gives it, and times both (CUDA events).
4. Drives the port's turntable (``soar_tpu_torch.cli.render_rot.
   run_turntable``) at full width — the 125,664-surfel procedural scene,
   16-level 2^18 hash field, 512x512 renders — with every launch counter
   set to 0 just before and read just after, and checks the outputs.
   Then times one view, and holds it against the same view with the plain
   composite, at bench.py's camera and at one that frames the whole body.
5. Prints a ``{"kernels": [...]}`` line, then as the last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no result
line.  It needs CUDA and the repository's ``soar_tpu_torch`` package beside
it.  A JSON report also goes to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H100_F32_FLOPS = 67e12  # non-tensor-core f32, H100 SXM data sheet (700 W)
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
SLICE_NT, SLICE_P, SLICE_K = 1024, 256, 96  # 512x512 render, 16x16 tiles, K=96
NUM_VIEWS = 4
KERNEL_TOL = 1e-4  # |kernel - plain| per element (accum values are O(1))
KERNEL_FLIP_SHARE = 0.01  # pixels allowed a T-cutoff flip (see composite.py)
# Per pixel-slot operation counts of the composite, for the bound: an
# evaluated slot costs offsets, power, exp, clamp, the skip tests and the
# T update (19); a blended slot adds w = a*T, C channel FMAs and corr (2C+6).
OPS_PER_EVAL = 19


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


def composite_scene(C, seed):
    """The composite's inputs at the slice's shapes: a 32x32 grid of 16x16
    tiles, K=96 slots, ~15% invalid slots plus short tile runs, half the
    tiles saturating (opacity 0.9-1.0, so the T < 1e-4 stop fires)."""
    rng = np.random.RandomState(seed)
    NT, P, K, tile = SLICE_NT, SLICE_P, SLICE_K, 16
    t_ar = np.arange(NT)
    origins = np.stack([(t_ar % 32) * tile, (t_ar // 32) * tile], -1).astype(np.float32)
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


def composite_bound_ms(args, C):
    """Least time for this call: max(bytes / HBM rate, ops / f32 rate) with
    the pixel-slot pairs this data makes the kernel walk."""
    from soar_tpu_torch.render.composite import composite_weights, splat_alpha

    xy, conic, opac, valid, attrs, e, pixf = args
    NT, K = valid.shape
    P = pixf.shape[1]
    d = xy[:, None] - pixf[:, :, None]
    alpha = splat_alpha(d, conic[:, None], opac[:, None], valid[:, None])
    w, _ = composite_weights(alpha)
    # A pixel walks its slots up to and including its early-stop slot.
    one_minus = 1.0 - alpha
    t_excl = torch.cat([torch.ones_like(alpha[..., :1]),
                        torch.cumprod(one_minus[..., :-1], -1)], -1)
    viol = (t_excl * one_minus) < 1e-4
    stop = torch.where(viol.any(-1), viol.float().argmax(-1), torch.full_like(viol[..., 0], K - 1, dtype=torch.long))
    walked = torch.arange(K, device=xy.device)[None, None] <= stop[..., None]
    evals = int((walked & valid[:, None]).sum())
    blends = int((w > 0).sum())
    ops = evals * OPS_PER_EVAL + blends * (2 * C + 6)
    nbytes = 4 * (NT * K * (9 + C) + NT * P * 2 + NT * P * (C + 2))
    t_ops, t_bytes = ops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return {
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "ops": ops, "bytes": nbytes, "pairs_evaluated": evals, "pairs_blended": blends,
    }


def check_composite_kernel(C, seed):
    from soar_tpu_torch.render.block_composite import composite_block
    from soar_tpu_torch.render.composite import composite_block_plain

    args = composite_scene(C, seed)
    with torch.no_grad():
        got = composite_block(*args)
        torch.cuda.synchronize()
        want = composite_block_plain(*args)
    errs, share = {}, 0.0
    for g, w, name in zip(got, want, ("accum", "corr", "T")):
        check(bool(torch.isfinite(g).all()), f"C={C}: kernel {name} not finite")
        diff = (g - w).abs()
        errs[name] = float(diff.max())
        per_pixel = diff.reshape(diff.shape[0], diff.shape[1], -1).amax(-1)
        share = max(share, float((per_pixel > KERNEL_TOL).float().mean()))
    check(share <= KERNEL_FLIP_SHARE,
          f"C={C}: {share:.4%} of pixels differ from the plain version by > {KERNEL_TOL}")
    with torch.no_grad():
        ms = cuda_ms(lambda: composite_block(*args), 200)
        plain_ms = cuda_ms(lambda: composite_block_plain(*args), 10)
    out = {"C": C, "max_abs_err": max(errs.values()), "err": errs,
           "share_beyond_tol": share, "ms": ms, "plain_ms": plain_ms}
    out.update(composite_bound_ms(args, C))
    print(f"[composite_fwd C={C}] max|kernel-plain| accum {errs['accum']:.3g} corr "
          f"{errs['corr']:.3g} T {errs['T']:.3g}; pixels beyond {KERNEL_TOL}: {share:.4%}; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}); library call: none (no single PyTorch op computes it)")
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
    """Device time by kernel over one view (torch.profiler / CUPTI): only
    device-side events are summed, so an aten op and the kernel it launched
    are not counted twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = sorted(
        ((ev.self_device_time_total / 1e3, ev.count, ev.key) for ev in prof.key_averages()
         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
        reverse=True,
    )
    return {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": sum(r[0] for r in rows),
        "device_kernels": sum(r[1] for r in rows),
        "composite_fwd_ms": sum(r[0] for r in rows if "composite_fwd" in r[2]),
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


def run_slice(device):
    from soar_tpu_torch.cli.render_rot import gt_camera, run_turntable
    from soar_tpu_torch.core.transforms import rotmat_to_rotvec
    from soar_tpu_torch.render import block_composite

    t0 = time.perf_counter()
    ds, params, model = slice_scene(device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    N = params.xyz.shape[0]
    check(N == 125_664, f"surfel count {N} != 125664")
    print(f"[slice] scene: {N} surfels, field 16 levels x 2^18 rows, 512x512, "
          f"set-up {setup_s:.2f} s")

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
    ov = {"global_orient": rotmat_to_rotvec(torch.eye(3, device=device))}
    views = {"bench": gt_camera(ds, 0, device),
             "framed": framed_camera(params, model, ov, device)}
    reports = {label: view_report(label, params, model, cam, ov)
               for label, cam in views.items()}
    return {
        "surfels": N, "setup_s": setup_s, "turntable_s": turntable_s, "launches": launches,
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


def view_report(label, params, model, cam, ov):
    """ms per view with the kernel and with the plain composite, the view's
    kernel-vs-plain difference, its device profile, host ops and layers."""
    from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
    from soar_tpu_torch.render.types import RasterConfig

    bg = torch.ones(3, device=cam.w2c.device)

    def view(composite):
        st = RenderSettings(raster=RasterConfig(composite=composite))
        return lambda: render_view(params, model, cam, (512, 512), bg, 0, st, smpl_override=ov)

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


def main():
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
    built = kernels.build()
    print(f"[build] {sorted(built)} in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for name in kernels.SOURCES:
        kernels.load(name)
        report = [ln.strip() for ln in kernels.ptxas_report(name).splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: " + " | ".join(report[:4]))

    comp = [check_composite_kernel(7, seed=0), check_composite_kernel(3, seed=1)]
    sl = run_slice("cuda")

    main_c = comp[0]
    entry = {
        "name": "composite_fwd",
        "route": "cuda",
        "source": "soar_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "soar_tpu/render/block_composite.py:205",
        "launches": sl["launches"],
        "max_abs_err": max(c["max_abs_err"] for c in comp),
        "ms": main_c["ms"],
        "plain_ms": main_c["plain_ms"],
        "bound_ms": main_c["bound_ms"],
        "bound_by": main_c["bound_by"],
        "library_ms": None,
        "occ_C3": {k: comp[1][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")},
    }
    # The same numbers under shorter names.
    entry.update(max_err=entry["max_abs_err"], kernel_ms=entry["ms"])
    report = {"card": info, "kernels": comp, "slice": sl}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(info["nvidia_smi"])
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": info["kind"], "count": info["count"]}}))


if __name__ == "__main__":
    main()
