"""The other training systems: GaussianDreamer and MVDream (port of
``soar_tpu.train.systems``).

- :func:`make_gaussiandreamer_step`: the text-to-3D baseline
  (``system/gaussian_splatting.py:18-224``): random multi-view renders with
  sigmoid opacities, SDS plus the position, opacity, scales and tv
  regularisers, and the densify/prune schedule (``update_states``, the only
  caller of :mod:`soar_tpu_torch.avatar.densify`).
- :func:`make_mvdream_step`: the earlier SOAR variant
  (``system/gaussian_mvdream.py:29-475``), which is the SOAR step with
  text-only guidance: :func:`soar_tpu_torch.train.trainer.make_train_step`
  with a text-only ``guidance_fn`` and 512-px defaults.

Densification is not inside the loss step, which only accumulates its
statistics: it rewrites the surfel set, and runs on its own host-side
cadence (``maintain``) on the static-capacity ``alive`` state.  Random
draws are split from the step as in the trainer (:func:`sample_dreamer_draws`),
so a test can hand it the JAX package's draws.

On CUDA the dreamer's loss step replays from CUDA graphs around its eager
composite launches (:mod:`soar_tpu_torch.render.graphs`), as the SOAR step
does: graph A holds the four views' front ends and the regularisers that
read the parameters, graph B the views' finish, the guidance and the
weighted loss, each with its backward graph.  The step's numbers that
change from step to step (the draws, the scheduled weights, the guidance's
timestep window) reach the graphs as tensors (:func:`dreamer_scalars`);
``maintain`` rewrites the surfels and the skinning weights in place, so a
densify keeps the capture.

With tracing on (:mod:`soar_tpu_torch.core.spans`) a loss step is one
``soar.step`` unit, its views' ``soar.render`` spans nested in it beside
``soar.guidance``, ``soar.losses``, ``soar.backward`` and ``soar.optim``;
a ``maintain`` that changes the surfels is one ``soar.densify`` span (the
re-skinning included) with the ``densify.*`` counters.  A traced step runs
eagerly, so its spans read.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..avatar import state as S
from ..avatar.densify import DensifyState, accumulate_stats, adaptive_densify, adaptive_prune
from ..avatar.optim import AvatarOptimizer
from ..avatar.renderer import (
    RenderSettings,
    _view_outputs,
    _view_passes,
    avatar_key,
    render_view,
)
from ..avatar.state import AvatarModel, AvatarParams
from ..body.skinning import knn_idw_weights
from ..core import spans
from ..core.camera import camera_from_c2w
from ..data.cameras import CameraSampleConfig, sample_multiview_cameras
from ..render import graphs
from ..render.types import RasterConfig
from . import losses as L
from .config import LossWeights, StageConfig, TrainConfig, scheduled
from .trainer import _on_device


@dataclasses.dataclass(frozen=True)
class DreamerConfig:
    n_views: int = 4
    image_size: Tuple[int, int] = (256, 256)
    densify_from: int = 100
    densify_until: int = 2000
    densify_interval: int = 100
    prune_from: int = 300
    prune_interval: int = 100
    densify_grad_threshold: float = 0.0001
    min_opac_prune: float = 0.05
    extent: float = 2.0
    loss: LossWeights = LossWeights(sds=0.1, position=1.0, opacity=1e-3, scales=1e-3, tv=0.0)
    raster: RasterConfig = RasterConfig(surface=False, perpix_depth=False)
    cameras: CameraSampleConfig = CameraSampleConfig()


def sample_dreamer_draws(generator: torch.Generator, cfg: DreamerConfig,
                         latent_size: Optional[int] = None) -> Dict:
    """One step's draws on the generator's device: ``c2w`` [V, 4, 4] and
    ``fovy`` [V] from ``cfg.cameras``; with ``latent_size`` (the
    guidance's) also ``sds``: the timestep's uniform ``u`` and the latent
    ``noise`` and ``vae_eps`` [V, h, w, 4]."""
    dev = generator.device
    c2w, fovy = sample_multiview_cameras(generator, cfg.cameras)
    draws = {"c2w": c2w, "fovy": fovy}
    if latent_size is not None:
        shape = (c2w.shape[0], latent_size, latent_size, 4)
        draws["sds"] = {
            "u": torch.rand((), generator=generator, device=dev),
            "noise": torch.randn(shape, generator=generator, device=dev),
            "vae_eps": torch.randn(shape, generator=generator, device=dev),
        }
    return draws


# The loss's step-dependent numbers, in the order of the step's device
# vector of them (:func:`dreamer_scalars`): the loss weights, then the
# guidance's timestep window.
DREAMER_WEIGHTS = ("sds", "position", "opacity", "scales", "tv")
DREAMER_SCALARS = DREAMER_WEIGHTS + ("min_step", "span")


def dreamer_scalars(w: LossWeights, step: int,
                    timestep_window: Optional[Callable] = None) -> np.ndarray:
    """:data:`DREAMER_SCALARS` at ``step``, evaluated on the host in double
    precision and rounded once to float32, as a Python number is where it
    meets a float32 tensor: each loss weight of ``w`` (:func:`scheduled`)
    and the guidance's timestep window ``(min_step, span)`` from
    ``timestep_window(step)`` (zeros without one)."""
    vals = [scheduled(getattr(w, k), step) for k in DREAMER_WEIGHTS]
    vals += list(timestep_window(step)) if timestep_window is not None else [0.0, 0.0]
    return np.asarray(vals, np.float64).astype(np.float32)


def make_gaussiandreamer_step(
    model: AvatarModel,
    cfg: DreamerConfig,
    opt: AvatarOptimizer,
    guidance_fn: Callable,
):
    """Returns ``(loss_step, maintain)``.

    ``loss_step(params, dstate, point_weights, draws, step) -> (params,
    dstate, metrics)`` renders the views of ``draws``
    (:func:`sample_dreamer_draws`), evaluates SDS and the regularisers,
    backpropagates, accumulates the densification statistics of the alive
    surfels some view saw from the position and scaling gradients, and
    takes ``opt``'s step; ``params`` and ``opt`` update in place, and no
    value is read on the host.  ``guidance_fn(render [V, H, W, 3], c2w,
    step, draws.get("sds"))`` returns the SDS loss or a dict with
    ``"loss_sds"`` (a ``build_guidance`` closure).

    On CUDA, with the composite kernel, autograd on, autocast and tracing
    off, and a ``build_guidance`` closure (its timestep window taken as
    tensors, ``window=``) with no hook on its UNet's or VAE's modules, the
    step before the composites and the step after them replay from CUDA
    graphs (:func:`soar_tpu_torch.render.graphs.run`), keyed by the
    surfels, the model with ``point_weights``, the networks' and the text
    embeddings' tensors and ``opt``: a key's first call runs eagerly, its
    second captures, later calls replay the same computation.
    ``loss_step.eager``, ``.captures`` and ``.replays`` count those calls
    of each kind; every other step runs eagerly, uncounted.

    ``maintain(params, dstate, point_weights, step, generator=None,
    noise=None) -> (params, dstate, point_weights)`` densifies and prunes on
    the configured cadence (``update_states``) and recomputes the skinning
    weights when the surfels changed, into ``point_weights`` in place (so a
    captured step keeps its key); a split's normal draw is ``noise`` or
    comes from ``generator``."""
    # 3DGS blending: sigmoid opacities composite, and take the render
    # gradient the opacity regulariser and the statistics depend on,
    # unlike the SOAR renderer's forced-opaque surfels.
    settings = RenderSettings(use_explicit=True, gen_view=True, force_opaque=False,
                              raster=cfg.raster)
    w = cfg.loss
    tv_on = isinstance(w.tv, (tuple, list)) or w.tv > 0
    window_fn = getattr(guidance_fn, "timestep_window", None)
    # The networks' modules, whose hooks a replay would skip (None where the
    # guidance's cannot be seen), and the text embeddings, read in place.
    networks = [getattr(guidance_fn, "unet", None), getattr(guidance_fn, "vae", None)]
    net_modules = (None if any(n is None for n in networks)
                   else [m for n in networks for m in n.modules()])
    text = getattr(getattr(guidance_fn, "guidance", None), "text_embeddings", None)
    # What the options allow: the composite kernel, networks whose hooks
    # can be seen, and a guidance that takes its timestep window as tensors.
    graphable = (cfg.raster.composite == "kernel" and net_modules is not None
                 and text is not None and window_fn is not None)
    policy = graphs.Policy(held=graphs.HELD_STEPS)

    def skinned(point_weights):
        return dataclasses.replace(model, skin=model.skin._replace(point_weights=point_weights))

    def regularisers(params: AvatarParams):
        """The terms that read the parameters directly: the position
        term's mean distance, the opacity term's and the scales term's
        sums."""
        pos = torch.sqrt(torch.sum(params.xyz**2, -1) + 1e-12)
        scaling = S.get_scaling(params)
        return (torch.mean(pos), torch.sum(scaling[:, 0:1].detach() * S.get_opacity(params)),
                torch.sum(scaling))

    def add_regularisers(loss, render, regs, wt):
        """``loss`` (the weighted SDS term) plus the regularisers ``regs``
        and tv, each weighted by ``wt[name]`` (a Python float or a 0-d
        tensor)."""
        pos, opacity, scales = regs
        loss = loss + wt["position"] * pos
        loss = loss + wt["opacity"] * opacity
        loss = loss + wt["scales"] * scales
        if tv_on:
            loss = loss + wt["tv"] * L.tv_loss(render)
        return loss

    def loss_fn(params: AvatarParams, point_weights, draws, step: int):
        mdl = skinned(point_weights)
        c2w, fovy = draws["c2w"], draws["fovy"]
        bg = torch.zeros(3, device=c2w.device)
        outs = [render_view(params, mdl, camera_from_c2w(c2w[v], fovy[v], fovy[v], znear=0.1,
                                                         zfar=100.0),
                            cfg.image_size, bg, 0, settings)
                for v in range(c2w.shape[0])]
        render = torch.stack([o["render"] for o in outs])

        with spans.span("soar.guidance"):
            sds = guidance_fn(render, c2w, step, draws.get("sds"))
        if isinstance(sds, dict):
            sds = sds["loss_sds"]
        loss = scheduled(w.sds, step) * sds
        metrics = {"loss_sds": sds}

        with spans.span("soar.losses"):
            loss = add_regularisers(loss, render, regularisers(params),
                                    {k: scheduled(getattr(w, k), step) for k in DREAMER_WEIGHTS})
        metrics["loss"] = loss
        # Visibility over the views, the reference's ``radii > 0`` filter:
        # a surfel no view saw keeps denom 0 and is pruned.
        visible = torch.stack([o["visible"] for o in outs]).any(0)
        return loss, metrics, visible

    def eager_step(params, point_weights, draws, step: int) -> Dict:
        loss, metrics, visible = loss_fn(params, point_weights, draws, step)
        with spans.span("soar.backward"):
            loss.backward()
        return {**{k: v.detach() for k, v in metrics.items()}, "visible": visible}

    def front(params, mdl, xs):
        """Graph A: each view's front end up to its composites, and the
        regularisers (:class:`soar_tpu_torch.render.graphs.Segments`)."""
        c2w, fovy = xs["draws"]["c2w"], xs["draws"]["fovy"]
        bg = torch.zeros(3, device=c2w.device)
        fp = S.frame_params(mdl, 0, settings.gen_view)
        mid, passes = [], []
        for v in range(c2w.shape[0]):
            camera = camera_from_c2w(c2w[v], fovy[v], fovy[v], znear=0.1, zfar=100.0)
            p = _view_passes(params, mdl, settings, cfg.image_size, fp, camera, bg, None)
            mid.append((camera, p.finish))
            passes.append(p)
        return mid, passes, regularisers(params)

    def back(xs, mid, results, regs):
        """Graph B: each view's finish and post ops, the SDS loss, the
        weighted total and the views' visibility."""
        draws = xs["draws"]
        sc = dict(zip(DREAMER_SCALARS, xs["sc"].unbind(0)))
        outs = [_view_outputs(settings, cfg.image_size, finish(res), camera)
                for (camera, finish), res in zip(mid, results)]
        render = torch.stack([o["render"] for o in outs])
        # The window stands for the step, which a capture must not read.
        sds = guidance_fn(render, draws["c2w"], None, draws.get("sds"),
                          window=(sc["min_step"], sc["span"]))
        if isinstance(sds, dict):
            sds = sds["loss_sds"]
        loss = add_regularisers(sc["sds"] * sds, render, regs, sc)
        visible = torch.stack([o["visible"] for o in outs]).any(0)
        return loss, {"loss_sds": sds, "loss": loss, "visible": visible}

    def graph_inputs(params: AvatarParams, draws, step: int) -> Optional[Dict]:
        """What a replay copies in (the draws and the step's scalars on the
        device), or None where the step runs eagerly: options that do not
        allow the graphs, autograd off, a hook on a network's module, or
        not :func:`soar_tpu_torch.render.graphs.eligible`."""
        if not graphable or not torch.is_grad_enabled() or graphs.hooked(net_modules):
            return None
        x = {"draws": draws,
             "sc": _on_device(dreamer_scalars(w, step, window_fn), draws["c2w"].device)}
        return x if graphs.eligible(params.xyz.device, graphs.leaves(x)) else None

    @spans.spanned("soar.step", unit="step")
    def loss_step(params: AvatarParams, dstate: DensifyState, point_weights, draws,
                  step: int):
        opt.zero_grad()
        x = graph_inputs(params, draws, step)
        if x is None:
            out = eager_step(params, point_weights, draws, step)
        else:
            mdl = skinned(point_weights)
            key = (avatar_key(params, mdl), graphs.addresses(net_modules), text.data_ptr(),
                   id(opt))
            seg = graphs.Segments(
                front=lambda xs: front(params, mdl, xs), back=back,
                eager=lambda xs: eager_step(params, point_weights, draws, step), params=params)
            out = graphs.run(policy, key, seg, x, loss_step)
        visible = out.pop("visible")
        dstate = accumulate_stats(dstate, params.xyz.grad, params.scaling.grad,
                                  params.opacity.detach(), visible & dstate.alive)
        opt.step()
        return params, dstate, out

    def maintain(params: AvatarParams, dstate: DensifyState, point_weights, step: int,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None):
        """``update_states``' cadence (``surfel_base.py:1197-1230``)."""
        densify = (cfg.densify_from <= step <= cfg.densify_until
                   and step % cfg.densify_interval == 0)
        prune = cfg.prune_from <= step <= cfg.densify_until and step % cfg.prune_interval == 0
        if not (densify or prune):
            return params, dstate, point_weights
        with spans.span("soar.densify"):
            if densify:
                params, dstate = adaptive_densify(
                    params, dstate, generator, grad_threshold=cfg.densify_grad_threshold,
                    extent=cfg.extent, surface=cfg.raster.surface, noise=noise)
            if prune:
                params, dstate = adaptive_prune(params, dstate, min_opacity=cfg.min_opac_prune,
                                                extent=cfg.extent)
            # The reference recomputes the weights every forward
            # (``utils/smpl.py:611``); written in place, as the surfels are.
            with torch.no_grad():
                point_weights.copy_(knn_idw_weights(params.xyz, model.skin.cano_vertices,
                                                    model.body.lbs_weights))
            if spans.on():
                spans.count("densify.alive", dstate.alive.sum())
        return params, dstate, point_weights

    loss_step.loss_fn = loss_fn
    loss_step.eager = loss_step.captures = loss_step.replays = 0
    return loss_step, maintain


def make_mvdream_step(
    model,
    cfg: TrainConfig,
    stage: StageConfig,
    opt,
    guidance_fn,
    gen_size: Tuple[int, int] = (512, 512),
    gt_size: Tuple[int, int] = (512, 512),
    normal_size: Tuple[int, int] = (512, 512),
    **kwargs,
):
    """The MVDream system: the SOAR step with text-only guidance
    (``system/gaussian_mvdream.py:29-475``), the reference's 512-px render
    sizes by default."""
    from .trainer import make_train_step

    return make_train_step(model, cfg, stage, opt, gen_size=gen_size, gt_size=gt_size,
                           normal_size=normal_size, guidance_fn=guidance_fn, **kwargs)
