"""Two-stage training step (port of ``soar_tpu.train.trainer``).

One step renders the gen views (4 random novel views, each a main pass and
an occ pass), the GT RGB pass with its occ pass and the normal front/back
pair (``both_faces``: front, back and occ from one sort), evaluates every
explicit loss of the reference system (``gaussian_surfel_mvdream.py:
259-460``) and, with a ``guidance_fn``, the SDS loss on the gen views,
backpropagates once and takes one per-group Adam step.  On CUDA every
composite, forward and backward, is a hand-written kernel
(:mod:`soar_tpu_torch.render.block_composite`).  Without remat the step runs
every render's front end, then every composite, then every render's finish
and the losses; on CUDA the first and last of those phases replay from CUDA
graphs around the eager composite launches
(:mod:`soar_tpu_torch.render.graphs`).  The loss's step-dependent numbers
(the scheduled weights, the guidance's timestep window) reach it as one
device vector (:func:`step_scalars`), so that a graph reads them.

Random draws are split from the step: :func:`sample_step_draws` takes them
from a ``torch.Generator``, and the step takes them as an argument, so a
test can hand it the JAX package's draws.  The step updates the state in
place (the parameters and Adam moments are the only copies) and returns it.

SDS guidance (:func:`soar_tpu_torch.guidance.build.build_guidance`) joins
the loss after ``stage.sds_start``; a step at or before it never calls the
guidance, as the JAX CLI's guidance-free warm-up program does not.  Its
gradient reaches the renders through ``exp(-3 occ)``
(:func:`scale_gradient`).  ``split_sds`` moves the guidance's no-grad
half out of the step: ``train_step.sds_prelude`` re-renders the gen views
forward-only, the caller computes ``batch["sds_target"]`` with
``guidance_fn.compute_target``, and the step keeps the VAE encode and the
squared distance to the target.  ``lpips_fn`` adds the normal-LPIPS terms
and the VGG RGB term (:mod:`soar_tpu_torch.train.lpips`).

Multi-device (:mod:`soar_tpu_torch.parallel`, one process per device):
``shard_views`` renders this rank's block of the gen views and gathers the
renders before the losses; ``shard_gt`` composites this rank's band of tile
rows in each GT pass and gathers it before the post ops; the gradients are
averaged over the group before Adam, which then equals the unsharded step.
One device: ``gen_chunk`` renders the gen views in chunks of that many
(without ``shard_views``, as in the JAX package), the unit ``remat_gen``
recomputes; ``remat_gen`` / ``remat_gt`` put the gen chunks (each view
without ``gen_chunk``) / each GT pass under ``torch.utils.checkpoint``, so
the backward re-renders them instead of keeping their intermediates.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from ..avatar import state as S
from ..avatar.optim import AvatarOptimizer, make_optimizer
from ..avatar.renderer import (
    RenderSettings,
    _view_outputs,
    _view_passes,
    avatar_key,
    query_attributes,
    render_view,
)
from ..avatar.state import AvatarModel, AvatarParams
from ..core import spans
from ..core.camera import Camera, camera_from_c2w, get_ray_directions, get_rays
from ..data.cameras import (
    CameraSampleConfig,
    sample_head_cameras,
    sample_multiview_cameras,
)
from ..parallel.views import Sharder
from ..render import graphs
from ..render.tiled import composite_passes
from ..render.types import RasterConfig
from . import losses as L
from .background import (
    apply_random_aug,
    background_color,
    init_background,
    sample_random_aug,
)
from .config import StageConfig, TrainConfig, scheduled


@dataclasses.dataclass
class TrainState:
    params: AvatarParams
    bg_params: Dict
    opt: AvatarOptimizer
    step: int


def scale_gradient(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Value-preserving gradient scaling: forward x, backward dL/dx * w, the
    functional form of the reference's ``register_hook`` occ modulation
    (``gaussian_surfel_mvdream.py:26-30, 213-218``)."""
    w = w.detach()
    return x * w + (x * (1.0 - w)).detach()


def init_train_state(
    params: AvatarParams,
    cfg: TrainConfig,
    seed: int = 0,
    stage: Optional[StageConfig] = None,
) -> Tuple[TrainState, AvatarOptimizer]:
    """Optimizer over ``params`` (the stage's optimizer config if it has
    one) and the background MLP drawn from a generator seeded ``seed + 7``
    on the parameters' device."""
    optim_cfg = stage.optim if (stage is not None and stage.optim) else cfg.optim
    opt = make_optimizer(params, optim_cfg)
    gen = torch.Generator(device=params.xyz.device).manual_seed(seed + 7)
    return TrainState(params=params, bg_params=init_background(gen), opt=opt, step=0), opt


def gen_camera_config(cfg: TrainConfig, nv: int) -> CameraSampleConfig:
    """Gen-view camera distribution from the train config."""
    return CameraSampleConfig(
        n_view=nv,
        elevation_range=cfg.elevation_range,
        azimuth_range=cfg.azimuth_range,
        fovy_range=cfg.fovy_range,
        camera_distance_range=cfg.camera_distance_range,
        zoom_range=cfg.zoom_range,
        relative_radius=cfg.relative_radius,
    )


@spans.spanned("soar.draws")
def sample_step_draws(
    generator: torch.Generator, cfg: TrainConfig, n_views: Optional[int] = None,
    latent_size: Optional[int] = None,
) -> Dict:
    """Every random draw of one step, on the generator's device:
    ``c2w`` [V, 4, 4] and ``fovy`` [V] of the gen views (the head cameras
    where ``head``), ``head`` (a bool tensor), ``rand_bg`` [3] (the GT
    pass's background) and ``bg_aug`` (:func:`sample_random_aug`).  With
    ``latent_size`` (the guidance's, ``guidance_fn.latent_size``) also
    ``sds``: the timestep's uniform ``u`` and the latent ``noise`` and
    ``vae_eps`` [V, h, w, 4], drawn after the others."""
    nv = n_views or cfg.n_views
    dev = generator.device
    c2w, fovy = sample_multiview_cameras(generator, gen_camera_config(cfg, nv))
    head = torch.zeros((), dtype=torch.bool, device=dev)
    if cfg.head_prob > 0.0:
        # With probability head_prob the gen batch uses close-up cameras.
        head_c2w, head_fovy = sample_head_cameras(generator, nv)
        head = torch.rand((), generator=generator, device=dev) < cfg.head_prob
        c2w = torch.where(head, head_c2w, c2w)
        fovy = torch.where(head, head_fovy, fovy)
    bg_aug = sample_random_aug(generator, cfg.invert_bg_prob)
    rand_bg = torch.rand(3, generator=generator, device=dev)
    draws = {"c2w": c2w, "fovy": fovy, "head": head, "rand_bg": rand_bg, "bg_aug": bg_aug}
    if latent_size is not None:
        shape = (nv, latent_size, latent_size, 4)
        draws["sds"] = {
            "u": torch.rand((), generator=generator, device=dev),
            "noise": torch.randn(shape, generator=generator, device=dev),
            "vae_eps": torch.randn(shape, generator=generator, device=dev),
        }
    return draws


def _recomputed(fn, *args, **kwargs):
    """``fn`` under ``torch.utils.checkpoint`` (non-reentrant) when autograd
    records: the backward runs it again instead of keeping what it saved.
    The renders draw no random numbers, so no RNG state is kept."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kwargs)


# The loss's step-dependent numbers, in the order of the step's device
# vector of them (:func:`step_scalars`).
STEP_SCALARS = ("recon", "mask", "normal_F", "normal_B", "normal_mask", "vgg", "occ", "curv",
                "scales", "delta", "sds", "normal_consistency", "after_sds", "min_step", "span")


def step_scalars(w, stage: StageConfig, step: int,
                 timestep_window: Optional[Callable] = None) -> np.ndarray:
    """:data:`STEP_SCALARS` at ``step``, evaluated on the host in double
    precision and rounded once to float32, as a Python number is where it
    meets a float32 tensor: each loss weight of ``w`` (:func:`scheduled`),
    the normal-consistency weight with its ramp, ``after_sds`` (1 after
    ``stage.sds_start``) and the guidance's timestep window ``(min_step,
    span)`` from ``timestep_window(step)`` (zeros without one)."""
    def C(v):
        return scheduled(v, step)

    vals = [C(w.recon), C(w.mask), C(w.normal_F), C(w.normal_B), C(w.normal_mask), C(w.vgg),
            C(w.occ), C(w.curv), C(w.scales), C(w.delta), C(w.sds),
            C(w.normal_consistency) + 0.1 * min(2.0 * step / 2000.0, 1.0),
            float(step > stage.sds_start)]
    vals += list(timestep_window(step)) if timestep_window is not None else [0.0, 0.0]
    return np.asarray(vals, np.float64).astype(np.float32)


def _on_device(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """``values`` on ``device``; to a GPU from pinned memory, with no host
    sync."""
    t = torch.from_numpy(values)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _graphed(device: torch.device, x) -> bool:
    """Whether a step on ``device`` with the step inputs ``x`` can replay
    from CUDA graphs: autograd on and
    :func:`soar_tpu_torch.render.graphs.eligible`.  The step adds its
    options and the networks' hooks."""
    return torch.is_grad_enabled() and graphs.eligible(device, graphs.leaves(x))


def make_train_step(
    model: AvatarModel,
    cfg: TrainConfig,
    stage: StageConfig,
    opt: AvatarOptimizer,
    gen_size: Tuple[int, int],
    gt_size: Tuple[int, int],
    normal_size: Tuple[int, int],
    raster: RasterConfig = RasterConfig(),
    guidance_fn: Optional[Callable] = None,
    use_explicit: bool = False,
    n_views: Optional[int] = None,
    has_normals: bool = True,
    has_normal_B: bool = True,
    shard_views: Optional[Sharder] = None,
    shard_gt: Optional[Sharder] = None,
    lpips_fn: Optional[Callable] = None,
    split_sds: bool = False,
    remat_gen: Optional[bool] = None,
    remat_gt: Optional[bool] = None,
    gen_chunk: Optional[int] = None,
):
    """The training step of one stage: ``(state, batch, draws) -> (state,
    metrics)``, with ``batch`` from :func:`make_gt_batch` and ``draws``
    from :func:`sample_step_draws` (with ``latent_size`` when guided);
    ``metrics`` holds detached 0-d tensors on the device.

    ``guidance_fn(inp, c2w, step, draws, ref_rgb, ref_mask, comp_bg,
    ref_ip) -> {"loss_sds", "grad_norm"}`` receives the occ-weighted render
    stack [V, H, W, 3] (stage 1: the neural-background composite; stage 0:
    the rendered normals), the gen views' c2w, ``draws["sds"]``, the stage's
    reference image and mask, the first view's background and
    ``batch["ref_ip"]`` when the batch has it.  A guidance with a
    ``timestep_window(step)`` (:func:`soar_tpu_torch.guidance.build.
    build_guidance`'s) gets that window as tensors too, as ``window``.

    ``lpips_fn(a, b) -> scalar`` takes [H, W, 3] images in [-1, 1]; with
    it the normal terms gain the LPIPS of the masked normals, and the VGG
    RGB term joins when its weight is nonzero.

    ``split_sds``: the step's SDS term is ``0.5 * sum((lat - target)^2) /
    V`` on ``batch["sds_target"]``, which the caller makes with
    ``train_step.sds_prelude(state, batch, draws) -> (latents, c2w,
    draws["sds"])`` and ``guidance_fn.compute_target(latents, c2w,
    state.step, draws["sds"], ref_rgb=..., ref_ip=...)``.

    ``shard_views`` / ``shard_gt``: :func:`soar_tpu_torch.parallel.
    view_sharder` / ``row_sharder`` of one mesh; every rank of its group
    calls the step with the same state, batch and draws (the state
    :func:`soar_tpu_torch.parallel.replicate`-d), computes the same loss and
    metrics, and takes the same Adam step on the gradients averaged over
    the group.  Any split of the views or tile rows over the ranks works,
    uneven too, as long as each rank has one.

    ``gen_chunk``: without ``shard_views``, the gen views render in chunks
    of ``gen_chunk`` (each the unit ``remat_gen`` recomputes).  The port
    renders the views one after another anyway, so a chunk changes neither
    values nor memory without remat.

    ``remat_gen`` / ``remat_gt``: the gen chunks (each view when unchunked)
    / each GT pass run under ``torch.utils.checkpoint`` (non-reentrant):
    the backward re-renders them, relaunching their forward composites,
    instead of keeping their intermediates.  Both None means no remat here,
    where the JAX package remats whenever the step is guided: that default
    was chosen for a TPU's memory beside the diffusion weights, while the
    guided step peaks below 8 GiB of the card's 80 GB and a recompute costs
    a re-render.  ``remat_gt`` None follows ``remat_gen``, and an explicit
    True or False does what the JAX package's does.

    Without remat a step runs in three phases: the field query, the
    regularisers that read the parameters and every render's front end;
    then every composite; then every render's finish and the losses.  On
    CUDA, with the composite kernel, no sharding, remat or ``gen_chunk``,
    autocast and tracing off, and no hook on the guidance's or LPIPS's
    modules, the first and last phase replay from CUDA graphs around the
    eager composite launches (:mod:`soar_tpu_torch.render.graphs`): a
    key's first call runs eagerly, its second captures, later calls
    replay the same computation.  ``train_step.eager``, ``.captures`` and
    ``.replays`` count those calls of each kind.

    ``train_step.loss_fn(params, bg_params, batch, draws, step)`` returns
    ``(loss, metrics, aux)`` without stepping (``aux`` holds the renders and
    the gen views' background composite)."""
    nv = n_views or cfg.n_views
    remat_gen = bool(remat_gen)
    remat_gt = remat_gen if remat_gt is None else bool(remat_gt)
    remat = remat_gen or remat_gt
    if gen_chunk is not None and gen_chunk < 1:
        raise ValueError(f"gen_chunk must be positive, got {gen_chunk}")
    # This rank's gen views, and their render units under remat: the block,
    # else chunks of gen_chunk, else each view.
    gen_block = shard_views.block(nv) if shard_views is not None else (0, nv)
    if shard_views is not None:
        gen_units = [gen_block]
    elif gen_chunk is not None and gen_chunk < nv:
        gen_units = [(i, min(i + gen_chunk, nv)) for i in range(0, nv, gen_chunk)]
    elif remat_gen:
        gen_units = [(v, v + 1) for v in range(nv)]
    else:
        gen_units = [(0, nv)]
    mesh_sharder = shard_views if shard_views is not None else shard_gt
    gen_settings = RenderSettings(use_explicit=use_explicit, gen_view=True, raster=raster)
    gt_settings = RenderSettings(use_explicit=use_explicit, gen_view=False, raster=raster)
    w = stage.loss
    # Back-surface supervision is gated like the reference's
    # ``lambda_normal_B > 0.0 and "gt_normal_B" in batch``.
    nB_w_on = isinstance(w.normal_B, (tuple, list)) or float(w.normal_B) != 0.0
    use_nB = has_normals and has_normal_B and nB_w_on
    # With the back pass: front + back (+ one occ) from one preprocess and sort.
    normal_settings = dataclasses.replace(gt_settings, both_faces=use_nB)
    window_fn = getattr(guidance_fn, "timestep_window", None)
    # The modules of the networks a step runs, whose hooks a replay would
    # skip; None where a callable's modules cannot be seen.
    networks = []
    if guidance_fn is not None:
        networks += [getattr(guidance_fn, "unet", None), getattr(guidance_fn, "vae", None)]
    if lpips_fn is not None:
        networks.append(getattr(lpips_fn, "net", None))
    net_modules = (None if any(n is None for n in networks)
                   else [m for n in networks for m in n.modules()])
    text = getattr(getattr(guidance_fn, "guidance", None), "text_embeddings", None)
    # What the options allow: no remat, sharding or chunks, the composite
    # kernel, networks whose hooks can be seen, and a guidance that takes
    # its step's numbers as tensors (split SDS calls only the VAE).
    graphable = (not remat and shard_views is None and shard_gt is None and gen_chunk is None
                 and raster.composite == "kernel" and net_modules is not None
                 and (guidance_fn is None or split_sds or window_fn is not None))
    policy = graphs.Policy(held=graphs.HELD_STEPS)

    def gen_pass(params, bg_params, frame_idx, draws, attrs, settings=gen_settings):
        """The gen views rendered whole (under remat, and in the split-SDS
        prelude) and their neural-background composite."""
        c2w, fovy = draws["c2w"], draws["fovy"]
        dev = c2w.device
        zeros = torch.zeros(3, device=dev)

        def render_range(lo: int, hi: int) -> List[Dict]:
            outs = []
            for v in range(lo, hi):
                cam = camera_from_c2w(c2w[v], fovy[v], fovy[v], znear=0.1, zfar=100.0)
                outs.append(render_view(params, model, cam, gen_size, zeros, frame_idx,
                                        settings, attrs=attrs))
            return outs

        outs: List[Dict] = []
        for lo, hi in gen_units:
            outs += _recomputed(render_range, lo, hi) if remat_gen else render_range(lo, hi)
        gen = gather_gen(outs)
        return (gen,) + background(bg_params, draws, gen)

    def gather_gen(outs: List[Dict]) -> Dict:
        gen = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        if shard_views is not None:
            gen = {k: shard_views.gather(v, nv) for k, v in gen.items()}
        return gen

    def background(bg_params, draws, gen):
        """Neural-bg composite over the gen renders
        (``renderer/gaussian_batch_renderer.py:262, 330-332``):
        ``(comp_rgb, bg_rgb)``."""
        c2w, fovy = draws["c2w"], draws["fovy"]
        Hg, Wg = gen_size
        focal = 0.5 * Hg / torch.tan(0.5 * fovy)
        rays_d = torch.stack([
            get_rays(get_ray_directions(Hg, Wg, (focal[v], focal[v])), c2w[v])[1]
            for v in range(nv)
        ])
        bg_rgb = apply_random_aug(background_color(bg_params, rays_d), draws["bg_aug"])
        comp_rgb = gen["render"] + (1.0 - gen["mask"][..., None]) * bg_rgb
        return comp_rgb, bg_rgb

    def step_inputs(batch: Dict, draws: Dict, step: int) -> Dict:
        """What a step reads that changes from step to step: the batch's
        tensors, the draws, the frame's SMPL parameters and the loss's step
        scalars (:func:`step_scalars`, a device vector)."""
        return {"batch": {k: v for k, v in batch.items() if k != "frame_idx"},
                "draws": draws,
                "fp": S.frame_params(model, batch["frame_idx"]),
                "sc": _on_device(step_scalars(w, stage, step, window_fn), draws["c2w"].device)}

    def regularisers(params, attrs):
        """The two losses that read the parameters directly, made beside the
        field query so that every path from a parameter to the loss runs
        through the first phase (segment A): ``(scales_mean, loss_delta)``."""
        if use_explicit:
            scales_mean = torch.mean(S.get_scaling(params))
        else:
            scales_mean = torch.mean(attrs["scales"])
        # eps-safe norm: at init xyz == original_pos, where the exact L2
        # norm's gradient is NaN.
        dvec = params.xyz - model.original_pos
        loss_delta = torch.mean(torch.sqrt(torch.sum(dvec * dvec, -1) + 1e-12))
        return scales_mean, loss_delta

    def front(params, x):
        """The first phase (graph A): the field query, the regularisers,
        and every render's front end up to its composites: this rank's gen
        views, the GT pass, the normal pass.  Returns each render's
        ``(settings, size, camera, finish)``, their passes and the
        regularisers (:class:`soar_tpu_torch.render.graphs.Segments`)."""
        b, d, fp = x["batch"], x["draws"], x["fp"]
        dev = d["c2w"].device
        # One field query serves every render of the step.
        attrs = None if use_explicit else query_attributes(params, model)
        regs = regularisers(params, attrs)
        gen_fp = S.root_zeroed(fp)
        zeros, ones = torch.zeros(3, device=dev), torch.ones(3, device=dev)
        renders, passes = [], []

        def add(settings, size, fp, camera, bg):
            p = _view_passes(params, model, settings, size, fp, camera, bg, attrs)
            renders.append((settings, size, camera, p.finish))
            passes.append(p)

        for v in range(*gen_block):
            add(gen_settings, gen_size, gen_fp,
                camera_from_c2w(d["c2w"][v], d["fovy"][v], d["fovy"][v], znear=0.1, zfar=100.0),
                zeros)
        add(gt_settings, gt_size, fp, b["gt_cam"], d["rand_bg"])
        if has_normals:
            add(normal_settings, normal_size, fp, b["normal_cam"], ones)
        return renders, passes, regs

    def back(bg_params, x, renders, results, regs, step: int):
        """The last phase (graph B): every render's finish and post ops,
        from ``renders``' ``(settings, size, camera, finish)`` and each
        render's composite outputs, then the losses."""
        outs = []
        for (settings, size, camera, finish), res in zip(renders, results):
            with spans.span("soar.render"):
                outs.append(_view_outputs(settings, size, finish(res), camera))
        n_gen = gen_block[1] - gen_block[0]
        gen = gather_gen(outs[:n_gen])
        normal = outs[n_gen + 1] if has_normals else None
        return losses(bg_params, x, gen, background(bg_params, x["draws"], gen), outs[n_gen],
                      normal, regs, step)

    def losses(bg_params, x, gen, comp_bg, gt, normal, regs, step: int):
        b, draws = x["batch"], x["draws"]
        comp_rgb, bg_rgb = comp_bg
        sc = dict(zip(STEP_SCALARS, x["sc"].unbind(0)))
        rand_bg = draws["rand_bg"]
        gt_nF, gt_nB = normal if use_nB else (normal, None)
        scales_mean, loss_delta = regs
        metrics = {}

        # ---- explicit losses (``gaussian_surfel_mvdream.py:259-460``)
        with spans.span("soar.losses"):
            m_gt = b["gt_mask"][..., None]
            mask = b["gt_mask"] > 1e-5
            gt_rgb_blended = b["gt_rgb"] * m_gt + rand_bg * (1.0 - m_gt)
            loss_recon = 0.8 * L.masked_l1(gt["render"], b["gt_rgb"], mask) + 0.2 * (
                1.0 - L.ssim(gt["render"], gt_rgb_blended)
            )
            loss = sc["recon"] * loss_recon
            metrics["loss_recon"] = loss_recon

            loss_mask = torch.mean(torch.abs(gt["mask"] - b["gt_mask"]))
            loss = loss + sc["mask"] * loss_mask
            metrics["loss_mask"] = loss_mask

            if has_normals:
                nmask = b["gt_normal_mask"] > 1e-5
                loss_nF = 0.2 * L.cos_loss(gt_nF["normal"], b["gt_normal_F"], nmask, thrsh=0.0)
                if use_nB:
                    loss_nB = 0.2 * L.cos_loss(gt_nB["normal"], b["gt_normal_B"], nmask,
                                               thrsh=0.0)
                if lpips_fn is not None:
                    # LPIPS of the masked normals, shifted to [-1, 1], inside the
                    # normal terms (``gaussian_surfel_mvdream.py:342-393``), with
                    # the reference's quirk: the front pass multiplies by the raw
                    # alpha mask, the back pass by the binarised one.
                    nm_raw = b["gt_normal_mask"][..., None]
                    nm_bin = nmask[..., None].to(nm_raw.dtype)

                    def nlp(pred01, gt01, nm):
                        return lpips_fn((pred01 * nm - 0.5) * 2.0, (gt01 * nm - 0.5) * 2.0)

                    loss_nF = loss_nF + nlp(gt_nF["normal"], b["gt_normal_F"], nm_raw)
                    if use_nB:
                        loss_nB = loss_nB + nlp(gt_nB["normal"], b["gt_normal_B"], nm_bin)
                loss = loss + sc["normal_F"] * loss_nF
                metrics["loss_normal_F"] = loss_nF
                if use_nB:
                    loss = loss + sc["normal_B"] * loss_nB
                    metrics["loss_normal_B"] = loss_nB
                    # Nested in the reference's normal_B branch (``:394-399``).
                    loss_nmask = torch.mean(torch.abs(gt_nF["mask"] - b["gt_normal_mask"]))
                    loss = loss + sc["normal_mask"] * loss_nmask
                    metrics["loss_normal_mask"] = loss_nmask

            # VGG/LPIPS RGB term (``gaussian_surfel_mvdream.py:401-410``), gated
            # on its own weight only: the reference nests it under
            # lambda_normal_B > 0, which the configs that enable it set to 0.
            if lpips_fn is not None and (isinstance(w.vgg, (tuple, list)) or float(w.vgg) != 0.0):
                loss_vgg = lpips_fn((gt["render"] - 0.5) * 2.0, (gt_rgb_blended - 0.5) * 2.0)
                loss = loss + sc["vgg"] * loss_vgg
                metrics["loss_vgg"] = loss_vgg

            # occ supervision: visible (masked) pixels should predict occ -> 1.
            occ_gt = gt["occ"][..., 0]
            m = mask.to(occ_gt.dtype)
            loss_occ = torch.sum((1.0 - occ_gt) * m) / torch.clamp_min(torch.sum(m), 1.0)
            loss = loss + sc["occ"] * loss_occ
            metrics["loss_occ"] = loss_occ

            # Normal consistency: rendered vs depth-derived normals; the gen
            # views' term joins after sds_start.
            loss_nc = L.cos_loss(gt["pred_normal"], gt["normal"], thrsh=np.pi / 10000.0)
            gen_nc = L.cos_loss(gen["pred_normal"], gen["normal"], thrsh=np.pi / 10000.0)
            after_sds = sc["after_sds"]
            loss_nc = (loss_nc + after_sds * gen_nc) / (1.0 + after_sds)
            loss = loss + sc["normal_consistency"] * loss_nc
            metrics["loss_normal_consistency"] = loss_nc

            loss_curv = torch.mean(torch.abs(gen["curv"]))
            loss = loss + sc["curv"] * loss_curv
            metrics["loss_curv"] = loss_curv

            loss = loss + sc["scales"] * scales_mean
            metrics["loss_scales"] = scales_mean

            loss = loss + sc["delta"] * loss_delta
            metrics["loss_delta"] = loss_delta

        # ---- SDS guidance (``gaussian_surfel_mvdream.py:180-254``): the
        # occ-weighted hook exp(-3 occ) on the guidance input, gated on
        # lambda_occ > 0 as in the reference (a schedule counts as on); the
        # RGB composite in stage 1, the rendered normals in stage 0, with
        # that stage's reference image and the first view's background.
        if guidance_fn is not None and step > stage.sds_start:
            with spans.span("soar.guidance"):
                if "sds" not in draws:
                    raise ValueError("a guided step needs the SDS draws: sample_step_draws(..., "
                                     "latent_size=guidance_fn.latent_size)")
                inp = comp_rgb if stage.training_stage == 1 else gen["normal"]
                if isinstance(w.occ, (tuple, list)) or float(w.occ) != 0.0:
                    inp = scale_gradient(inp, torch.exp(-3.0 * gen["occ"].detach()))
                ref = ("gt_rgb_crop", "gt_mask_crop") if stage.training_stage == 1 else (
                    "gt_normal_F", "gt_normal_mask")
                if split_sds:
                    # The gradient half; the no-grad target came from the prelude.
                    if "sds_target" not in b:
                        raise ValueError("a split-SDS step needs batch['sds_target'] "
                                         "(train_step.sds_prelude, then "
                                         "guidance_fn.compute_target)")
                    lat = guidance_fn.encode_latents(inp, draws["sds"]["vae_eps"])
                    diff = lat - b["sds_target"].detach()
                    V = lat.shape[0]
                    # /V: the reference's grad_norm is the autograd of the
                    # /V-scaled recon loss.
                    sds_out = {"loss_sds": 0.5 * torch.sum(diff**2) / V,
                               "grad_norm": torch.linalg.norm(diff.detach()) / V}
                else:
                    kw = {} if window_fn is None else {"window": (sc["min_step"], sc["span"])}
                    sds_out = guidance_fn(inp, draws["c2w"], step, draws["sds"],
                                          ref_rgb=b.get(ref[0]), ref_mask=b.get(ref[1]),
                                          comp_bg=bg_rgb[0], ref_ip=b.get("ref_ip"), **kw)
                loss = loss + sc["sds"] * sds_out["loss_sds"]
                metrics["loss_sds"] = sds_out["loss_sds"]
                if "grad_norm" in sds_out:
                    metrics["sds_grad_norm"] = sds_out["grad_norm"]

        # Capacity-truncation canaries: splats dropped past max_per_tile
        # (the farthest in their tile) and footprint-capped surfels.  The
        # normal pair composites from one binning, so it counts once.
        ov = gen["overflow"].reshape(-1, 2).sum(0) + gt["overflow"]
        if has_normals:
            ov = ov + gt_nF["overflow"]
        metrics["raster_dropped"] = ov[0].to(torch.float32)
        metrics["raster_capped"] = ov[1].to(torch.float32)
        metrics["loss"] = loss
        aux = {"gen": gen, "gen_comp_rgb": comp_rgb, "gt": gt}
        if has_normals:
            aux["gt_normal_F"] = gt_nF
            if use_nB:
                aux["gt_normal_B"] = gt_nB
        return loss, metrics, aux

    def remat_loss(params, bg_params, batch, x, step: int):
        """The step's loss with the renders recomputed in the backward: each
        render whole (:func:`render_view`) under ``torch.utils.checkpoint``."""
        frame_idx = batch["frame_idx"]
        attrs = None if use_explicit else query_attributes(params, model)
        regs = regularisers(params, attrs)
        gen, comp_rgb, bg_rgb = gen_pass(params, bg_params, frame_idx, x["draws"], attrs)

        def gt_render(*args):
            if remat_gt:
                return _recomputed(render_view, params, model, *args, attrs=attrs, rows=shard_gt)
            return render_view(params, model, *args, attrs=attrs, rows=shard_gt)

        rand_bg = x["draws"]["rand_bg"]
        gt = gt_render(batch["gt_cam"], gt_size, rand_bg, frame_idx, gt_settings)
        normal = None
        if has_normals:
            normal = gt_render(batch["normal_cam"], normal_size,
                               torch.ones(3, device=rand_bg.device), frame_idx, normal_settings)
        return losses(bg_params, x, gen, (comp_rgb, bg_rgb), gt, normal, regs, step)

    def loss_fn(params, bg_params, batch, draws, step: int, x: Optional[Dict] = None):
        if x is None:
            x = step_inputs(batch, draws, step)
        if remat:
            return remat_loss(params, bg_params, batch, x, step)
        renders, passes, regs = front(params, x)
        n_gen = gen_block[1] - gen_block[0]
        # Row sharding splits the GT passes only.
        results = [composite_passes(p, raster, shard_gt if i >= n_gen else None)
                   for i, p in enumerate(passes)]
        return back(bg_params, x, renders, results, regs, step)

    def eager_step(state: TrainState, batch: Dict, x: Dict) -> Dict:
        loss, metrics, _ = loss_fn(state.params, state.bg_params, batch, None, state.step, x)
        with spans.span("soar.backward"):
            loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def networks_key():
        """The networks' tensors by address, or None when a hook is on one
        of their modules."""
        return None if graphs.hooked(net_modules) else graphs.addresses(net_modules)

    @spans.spanned("soar.step", unit="step")
    def train_step(state: TrainState, batch: Dict, draws: Dict):
        state.opt.zero_grad()
        x = step_inputs(batch, draws, state.step)
        net_key = networks_key() if graphable else None
        if net_key is not None and _graphed(state.params.xyz.device, x):
            key = (state.step > stage.sds_start, avatar_key(state.params, model),
                   tuple(t.data_ptr() for t in pytree.tree_leaves(state.bg_params)),
                   None if text is None else text.data_ptr(), id(state.opt), net_key)
            seg = graphs.Segments(
                front=lambda xs: front(state.params, xs),
                back=lambda xs, mid, res, regs: back(state.bg_params, xs, mid, res, regs,
                                                     state.step)[:2],
                eager=lambda xs: eager_step(state, batch, xs),
                params=state.params)
            metrics = graphs.run(policy, key, seg, x, train_step)
        else:
            metrics = eager_step(state, batch, x)
        if mesh_sharder is not None:
            mesh_sharder.average_gradients(state.params)
        # The background MLP is not optimised (the reference builds its
        # optimizer but never returns it).
        state.opt.step()
        state.step += 1
        return state, metrics

    @torch.no_grad()
    def sds_prelude(state: TrainState, batch: Dict, draws: Dict):
        """Split SDS's forward-only half: the gen views rendered ``lite``
        (no occ pass or curvature; the same main render) from the step's
        draws, sharded and gathered as in the step, and VAE-encoded.
        Returns (latents [V, 4, h, w], c2w, draws["sds"])."""
        params = state.params
        attrs = None if use_explicit else query_attributes(params, model)
        gen, comp_rgb, _ = gen_pass(params, state.bg_params, batch["frame_idx"], draws, attrs,
                                    settings=dataclasses.replace(gen_settings, lite=True))
        inp = comp_rgb if stage.training_stage == 1 else gen["normal"]
        return guidance_fn.encode_latents(inp, draws["sds"]["vae_eps"]), draws["c2w"], draws["sds"]

    train_step.loss_fn = loss_fn
    train_step.sds_prelude = sds_prelude if (split_sds and guidance_fn is not None) else None
    train_step.eager = train_step.captures = train_step.replays = 0
    return train_step


@spans.spanned("soar.batch")
def make_gt_batch(ds, model: AvatarModel, frame_idx: int, device="cuda") -> Dict:
    """The per-frame GT batch (tensors on ``device`` and ``Camera``s) the
    step consumes; ``frame_idx`` stays a Python int."""
    H, W = ds.image_size
    fov = ds.frame_fovs(frame_idx)
    c2w = torch.as_tensor(np.asarray(ds.gt_c2w(frame_idx), np.float32), device=device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    # GT RGB camera: principal point through prcppoint, projection without
    # cxcy (``gaussian_batch_renderer.py:29-37, 59-83``).
    gt_cam = camera_from_c2w(
        c2w, t(fov["fovx"]), t(fov["fovy"]), znear=0.1, zfar=100.0,
        prcppoint=t([fov["cx"] / W, fov["cy"] / H]),
    )
    # Normal cameras: principal point inside the projection, prcp (.5, .5).
    nres = ds.normal_F.shape[1] if ds.normal_F.size else ds.images_crop.shape[1]
    normal_cam = camera_from_c2w(
        c2w, t(fov["normal_fovx"]), t(fov["normal_fovy"]), znear=0.1, zfar=100.0,
        cxcy=(t(fov["normal_cx"]), t(fov["normal_cy"])), img_wh=(nres, nres),
    )
    batch = {
        "frame_idx": int(frame_idx),
        "gt_rgb": t(ds.images[frame_idx]),
        "gt_mask": t(ds.masks[frame_idx]),
        "gt_cam": gt_cam,
        "normal_cam": normal_cam,
        "gt_rgb_crop": t(ds.images_crop[frame_idx]),
        "gt_mask_crop": t(ds.masks_crop[frame_idx]),
    }
    if ds.normal_F.size:
        batch["gt_normal_F"] = t(ds.normal_F[frame_idx])
        batch["gt_normal_mask"] = t(ds.normal_mask[frame_idx])
        if ds.normal_B.size:
            batch["gt_normal_B"] = t(ds.normal_B[frame_idx])
    return batch


# Image-like batch keys eligible for uint8 pinned storage: 8-bit-sourced
# data round-trips exactly through round(x*255)/255.
_GT_U8_KEYS = (
    "gt_rgb",
    "gt_mask",
    "gt_rgb_crop",
    "gt_mask_crop",
    "gt_normal_F",
    "gt_normal_B",
    "gt_normal_mask",
)


def make_gt_batch_stack(ds, model: AvatarModel, frames, store_u8: bool = False,
                        ip_table=None, device="cuda"):
    """Every per-frame GT batch stacked and kept on ``device``; returns
    ``(stacked, select_fn, pos_of)`` with ``select_fn(stacked, pos)`` the
    batch of frame ``frames[pos]`` and ``pos_of[frame_idx] = pos``.
    ``store_u8`` stores the image-like keys as uint8 (4x smaller; exact for
    8-bit-sourced data) and dequantizes them in ``select_fn``.
    ``ip_table`` ([F_total, Q, D], indexed by frame) rides along as
    ``ref_ip``.  Assembled on the host and moved to the device once."""
    frames = [int(f) for f in frames]
    pos_of = {f: i for i, f in enumerate(frames)}
    per_frame = [make_gt_batch(ds, model, f, device="cpu") for f in frames]
    stacked = {}
    for k, v in per_frame[0].items():
        if k == "frame_idx":
            stacked[k] = frames
        elif isinstance(v, Camera):
            stacked[k] = Camera(*(torch.stack(xs).to(device) for xs in
                                  zip(*(b[k] for b in per_frame))))
        else:
            x = torch.stack([b[k] for b in per_frame])
            if store_u8 and k in _GT_U8_KEYS:
                # Clamp before the cast: 256 would wrap to 0 in uint8.
                x = torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)
            stacked[k] = x.to(device)
    if ip_table is not None:
        stacked["ref_ip"] = torch.stack([torch.as_tensor(ip_table[f]).to(torch.float32).cpu()
                                         for f in frames]).to(device)
    u8_keys = tuple(k for k in _GT_U8_KEYS if store_u8 and k in stacked)

    @spans.spanned("soar.batch")
    def select(stacked, pos: int) -> Dict:
        out = {}
        for k, v in stacked.items():
            if k == "frame_idx":
                out[k] = v[pos]
            elif isinstance(v, Camera):
                out[k] = Camera(*(x[pos] for x in v))
            else:
                out[k] = v[pos].to(torch.float32) / 255.0 if k in u8_keys else v[pos]
        return out

    return stacked, select, pos_of


def gt_stack_nbytes(ds, model: AvatarModel, n_frames: int, store_u8: bool = False,
                    ip_table=None) -> int:
    """Device bytes of :func:`make_gt_batch_stack` for ``n_frames`` frames
    (one host probe batch)."""
    probe = make_gt_batch(ds, model, 0, device="cpu")
    total = 0
    for k, v in probe.items():
        for leaf in (v if isinstance(v, Camera) else (v,)):
            if isinstance(leaf, torch.Tensor):
                n = leaf.numel() * leaf.element_size()
                total += leaf.numel() if (store_u8 and k in _GT_U8_KEYS) else n
    if ip_table is not None:
        total += int(np.prod(tuple(ip_table[0].shape))) * 4
    return total * n_frames
