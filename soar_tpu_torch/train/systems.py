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

With tracing on (:mod:`soar_tpu_torch.core.spans`) a loss step is one
``soar.step`` unit, its views' ``soar.render`` spans nested in it beside
``soar.guidance``, ``soar.losses``, ``soar.backward`` and ``soar.optim``;
a ``maintain`` that changes the surfels is one ``soar.densify`` span (the
re-skinning included) with the ``densify.*`` counters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..avatar import state as S
from ..avatar.densify import DensifyState, accumulate_stats, adaptive_densify, adaptive_prune
from ..avatar.optim import AvatarOptimizer
from ..avatar.renderer import RenderSettings, render_view
from ..avatar.state import AvatarModel, AvatarParams
from ..body.skinning import knn_idw_weights
from ..core import spans
from ..core.camera import camera_from_c2w
from ..data.cameras import CameraSampleConfig, sample_multiview_cameras
from ..render.types import RasterConfig
from . import losses as L
from .config import LossWeights, StageConfig, TrainConfig, scheduled


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

    ``maintain(params, dstate, point_weights, step, generator=None,
    noise=None) -> (params, dstate, point_weights)`` densifies and prunes on
    the configured cadence (``update_states``) and recomputes the skinning
    weights when the surfels changed; a split's normal draw is ``noise`` or
    comes from ``generator``."""
    # 3DGS blending: sigmoid opacities composite, and take the render
    # gradient the opacity regulariser and the statistics depend on,
    # unlike the SOAR renderer's forced-opaque surfels.
    settings = RenderSettings(use_explicit=True, gen_view=True, force_opaque=False,
                              raster=cfg.raster)
    w = cfg.loss

    def loss_fn(params: AvatarParams, point_weights, draws, step: int):
        mdl = dataclasses.replace(model, skin=model.skin._replace(point_weights=point_weights))
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
            pos = torch.sqrt(torch.sum(params.xyz**2, -1) + 1e-12)
            loss = loss + scheduled(w.position, step) * torch.mean(pos)
            scaling = S.get_scaling(params)
            loss = loss + scheduled(w.opacity, step) * torch.sum(
                scaling[:, 0:1].detach() * S.get_opacity(params))
            loss = loss + scheduled(w.scales, step) * torch.sum(scaling)
            if isinstance(w.tv, (tuple, list)) or w.tv > 0:
                loss = loss + scheduled(w.tv, step) * L.tv_loss(render)
        metrics["loss"] = loss
        # Visibility over the views, the reference's ``radii > 0`` filter:
        # a surfel no view saw keeps denom 0 and is pruned.
        visible = torch.stack([o["visible"] for o in outs]).any(0)
        return loss, metrics, visible

    @spans.spanned("soar.step", unit="step")
    def loss_step(params: AvatarParams, dstate: DensifyState, point_weights, draws,
                  step: int):
        opt.zero_grad()
        loss, metrics, visible = loss_fn(params, point_weights, draws, step)
        with spans.span("soar.backward"):
            loss.backward()
        dstate = accumulate_stats(dstate, params.xyz.grad, params.scaling.grad,
                                  params.opacity.detach(), visible & dstate.alive)
        opt.step()
        return params, dstate, {k: v.detach() for k, v in metrics.items()}

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
            # (``utils/smpl.py:611``).
            with torch.no_grad():
                point_weights = knn_idw_weights(params.xyz, model.skin.cano_vertices,
                                                model.body.lbs_weights)
            if spans.on():
                spans.count("densify.alive", dstate.alive.sum())
        return params, dstate, point_weights

    loss_step.loss_fn = loss_fn
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
