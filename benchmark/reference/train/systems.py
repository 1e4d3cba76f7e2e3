"""The GaussianDreamer system (the benchmark's copy of
``soar_tpu_torch.train.systems``, cut to the one path the
``gaussiandreamer_mvdream`` cell's check calls; see ``DREAMER.md``).

The text-to-3D baseline (``system/gaussian_splatting.py:18-224``): random
multi-view renders with sigmoid opacities through the plain composite, SDS
plus the position, opacity and scales regularisers, the densification
statistics, Adam, and the densify/prune cadence (``update_states``).
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
from ..core.camera import camera_from_c2w
from ..data.cameras import CameraSampleConfig, sample_multiview_cameras
from ..render.types import RasterConfig
from .config import LossWeights, scheduled


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
    """One step's draws, in the program's order: the cameras, then the
    timestep's uniform ``u``, the latent ``noise`` and ``vae_eps``."""
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


def make_gaussiandreamer_step(model: AvatarModel, cfg: DreamerConfig, opt: AvatarOptimizer,
                              guidance_fn: Callable):
    """``(loss_step, maintain)`` with the program's signatures; a split's
    normals are always handed in (``noise``)."""
    settings = RenderSettings(use_explicit=True, gen_view=True, force_opaque=False,
                              raster=cfg.raster)
    w = cfg.loss
    if isinstance(w.tv, (tuple, list)) or w.tv > 0:
        raise ValueError("the reference has no tv regulariser (GaussianDreamer's weight is 0)")

    def loss_fn(params: AvatarParams, point_weights, draws, step: int):
        mdl = dataclasses.replace(model, skin=model.skin._replace(point_weights=point_weights))
        c2w, fovy = draws["c2w"], draws["fovy"]
        bg = torch.zeros(3, device=c2w.device)
        outs = [render_view(params, mdl, camera_from_c2w(c2w[v], fovy[v], fovy[v], znear=0.1,
                                                         zfar=100.0),
                            cfg.image_size, bg, 0, settings)
                for v in range(c2w.shape[0])]
        render = torch.stack([o["render"] for o in outs])
        sds = guidance_fn(render, c2w, step, draws.get("sds"))
        if isinstance(sds, dict):
            sds = sds["loss_sds"]
        loss = scheduled(w.sds, step) * sds
        pos = torch.sqrt(torch.sum(params.xyz**2, -1) + 1e-12)
        loss = loss + scheduled(w.position, step) * torch.mean(pos)
        scaling = S.get_scaling(params)
        loss = loss + scheduled(w.opacity, step) * torch.sum(
            scaling[:, 0:1].detach() * S.get_opacity(params))
        loss = loss + scheduled(w.scales, step) * torch.sum(scaling)
        visible = torch.stack([o["visible"] for o in outs]).any(0)
        return loss, {"loss_sds": sds, "loss": loss}, visible

    def loss_step(params: AvatarParams, dstate: DensifyState, point_weights, draws,
                  step: int):
        opt.zero_grad()
        loss, metrics, visible = loss_fn(params, point_weights, draws, step)
        loss.backward()
        dstate = accumulate_stats(dstate, params.xyz.grad, params.scaling.grad,
                                  params.opacity.detach(), visible & dstate.alive)
        opt.step()
        return params, dstate, {k: v.detach() for k, v in metrics.items()}

    def maintain(params: AvatarParams, dstate: DensifyState, point_weights, step: int,
                 noise: Optional[torch.Tensor] = None):
        densify = (cfg.densify_from <= step <= cfg.densify_until
                   and step % cfg.densify_interval == 0)
        prune = cfg.prune_from <= step <= cfg.densify_until and step % cfg.prune_interval == 0
        if densify:
            params, dstate = adaptive_densify(
                params, dstate, noise, grad_threshold=cfg.densify_grad_threshold,
                extent=cfg.extent, surface=cfg.raster.surface)
        if prune:
            params, dstate = adaptive_prune(params, dstate, min_opacity=cfg.min_opac_prune,
                                            extent=cfg.extent)
        if densify or prune:
            with torch.no_grad():
                point_weights = knn_idw_weights(params.xyz, model.skin.cano_vertices,
                                                model.body.lbs_weights)
        return params, dstate, point_weights

    return loss_step, maintain
