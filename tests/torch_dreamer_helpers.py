"""A small GaussianDreamer scene for the dreamer's CPU tests, built by the
port (``soar_tpu_torch``) or by the benchmark's plain reference
(``benchmark/reference``) from the same seed: the benchmark's avatar at a
4-joint body subdivided once, padded to twice its surfels, its kNN skin
weights, Adam, and the tiny text-only MVDream guidance at 32x32 in
float32; ``make_gaussiandreamer_step``'s ``(loss_step, maintain)`` over
4 views at 32x32 with the dreamer's raster (surface off, no per-pixel
depth) at K = 32."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from benchmark import cell as BC
from benchmark import scene

SMALL = {
    "body": {"num_joints": 4, "segments_per_bone": 3, "ring": 8, "num_betas": 4,
             "num_subdiv": 1},
    "field": {"num_levels": 4, "features_per_level": 2, "min_res": 16, "max_res": 128,
              "log2_hashmap_size": 10, "hidden_dim": 16, "num_layers": 2},
    "capture": {"frames": 1, "size": 32, "focal": 40.0, "transl": [0.0, 0.9, -2.8],
                "pose_std": 0.05, "gt_images": False},
}
SEED = 20261018
SIZE = 32


def modules(side: str):
    """The modules of ``side``: "port" or "reference"."""
    if side == "port":
        from soar_tpu_torch.avatar import densify, optim
        from soar_tpu_torch.body import skinning
        from soar_tpu_torch.guidance import build
        from soar_tpu_torch.render import types as rtypes
        from soar_tpu_torch.train import config, systems

        avatar = BC.program_avatar
    else:
        from benchmark.reference.avatar import densify, optim
        from benchmark.reference.body import skinning
        from benchmark.reference.guidance import build
        from benchmark.reference.render import types as rtypes
        from benchmark.reference.train import config, systems

        avatar = BC.reference_avatar
    return types.SimpleNamespace(densify=densify, optim=optim, skinning=skinning, build=build,
                                 rtypes=rtypes, config=config, systems=systems, avatar=avatar)


def dreamer_cfg(m, **kw):
    raster = m.rtypes.RasterConfig(surface=False, perpix_depth=False, max_per_tile=32,
                                   dup_side=3)
    return m.systems.DreamerConfig(image_size=(SIZE, SIZE), raster=raster, **kw)


def build(side: str, device="cpu", **cfg_kw):
    """The scene of ``side`` on ``device`` with its step; ``cfg_kw`` go to
    its ``DreamerConfig``."""
    m = modules(side)
    dev = torch.device(device)
    sp, arrays = BC.inputs(SMALL, SEED, dev)
    _, params, model = m.avatar(SMALL, SEED, sp, arrays, dev)
    n = params.xyz.shape[0]
    params = m.densify.pad_to_capacity(params, 2 * n)
    with torch.no_grad():
        pw = m.skinning.knn_idw_weights(params.xyz, model.skin.cano_vertices,
                                        model.body.lbs_weights)
    dstate = m.densify.DensifyState.create(2 * n, n, device=dev)
    cfg = dreamer_cfg(m, **cfg_kw)
    g = m.build.build_guidance("mvdream", m.config.StageConfig(),
                               generator=scene.generator(SEED, "unet", dev),
                               text_embeddings=scene.text_embeddings(SEED, 16, dev),
                               tiny=True, image_size=SIZE, n_view=cfg.n_views, device=dev)
    opt = m.optim.make_optimizer(params, m.config.OptimConfig())
    loss_step, maintain = m.systems.make_gaussiandreamer_step(model, cfg, opt, g)
    return types.SimpleNamespace(m=m, model=model, params=params, pw=pw, dstate=dstate,
                                 opt=opt, guidance=g, cfg=cfg, n=n, loss_step=loss_step,
                                 maintain=maintain)


def with_threshold(s, threshold: float, **kw):
    """``s``'s ``maintain`` at another densify threshold (and other
    ``DreamerConfig`` fields), over the same optimizer and guidance."""
    s.cfg = dataclasses.replace(s.cfg, densify_grad_threshold=threshold, **kw)
    _, s.maintain = s.m.systems.make_gaussiandreamer_step(s.model, s.cfg, s.opt, s.guidance)
    return s


def gap_threshold(s):
    """A densify threshold in the widest relative gap of ``s``'s seen
    surfels' mean position gradients between their 50th and 90th
    percentiles, and that gap's ratio: no surfel's decision rests on
    round-off."""
    st = s.dstate
    gp = (st.xyz_grad_accum / st.denom.clamp_min(1.0))[st.alive & (st.denom > 0)]
    v = np.unique(gp.double().cpu().numpy())
    lo, hi = int(0.5 * len(v)), int(0.9 * len(v))
    i = lo + int(np.argmax(v[lo + 1:hi + 1] / v[lo:hi]))
    return float(np.sqrt(v[i] * v[i + 1])), float(v[i + 1] / v[i])


def draws(n_steps: int, capacity: int, latent_size: int, side: str = "port", device="cpu"):
    """``n_steps`` steps' draws from ``side``'s ``sample_dreamer_draws`` on a
    seeded generator on ``device``, then a split's normals [capacity, 3]."""
    m = modules(side)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    cfg = dreamer_cfg(m)
    out = [m.systems.sample_dreamer_draws(gen, cfg, latent_size=latent_size)
           for _ in range(n_steps)]
    return out, torch.randn((capacity, 3), generator=gen, device=gen.device)


def leaves(opt):
    return {f"{g}.{i}": p for g, ps in opt.groups.items() for i, p in enumerate(ps)}
