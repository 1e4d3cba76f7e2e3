"""Useful floating-point work of one training step or one view, counted
once from a configuration's shapes: ``torch.utils.flop_counter`` over the
reference's networks and field on the meta device (matrix products and
convolutions, forward and the backward the step needs), plus the skinning
blend by its shape.  Nothing recomputed is counted, so the count is the same
whatever implements the work.  The composites' operations come from their
recorded launches (:mod:`benchmark.counts.composite`)."""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


def _shapes(gd: Dict):
    from ..reference.guidance.build import NetworkShapes

    return NetworkShapes.tiny(gd["image_size"]) if gd["shapes"] == "tiny" else NetworkShapes.full()


def unet_forward(gd: Dict, n_views: int) -> int:
    """The UNet over the CFG batch (2 x views) of noisy latents, with the
    text context, the cameras and the ip tokens."""
    from ..reference.guidance.networks import MultiViewUNet

    sh = _shapes(gd)
    B, h = 2 * n_views, gd["image_size"] // sh.vae_downscale
    with torch.device("meta"):
        unet = MultiViewUNet(sh.unet, ip_dim=sh.ip_shape[1])
        x = torch.empty(B, 4, h, h)
        t = torch.zeros(B, dtype=torch.long)
        ctx = {"context": torch.empty(B, 77, sh.context_dim), "camera": torch.empty(B, 16),
               "num_frames": n_views, "ip": torch.empty((B,) + sh.ip_shape)}
        return _count(lambda: unet(x, t, ctx))


def vae_forward_backward(gd: Dict, n_views: int) -> int:
    """The VAE encoder over the views at the diffusion size, and the
    gradient to its input."""
    from ..reference.guidance.networks import VAEEncoder

    sh = _shapes(gd)
    s, h = gd["image_size"], gd["image_size"] // sh.vae_downscale
    with torch.device("meta"):
        vae = VAEEncoder(sh.vae).requires_grad_(False)
        x = torch.empty(n_views, 3, s, s, requires_grad=True)
        eps = torch.empty(n_views, 4, h, h)
        return _count(lambda: vae(x, eps).sum().backward())


def lpips_forward_backward(size: int, calls: int) -> int:
    """``calls`` LPIPS distances at ``size``^2 (both images through the
    VGG16 as one batch) and the gradient to the rendered image."""
    from ..reference.train.lpips import LPIPS

    with torch.device("meta"):
        net = LPIPS(torch.float32).requires_grad_(False)
        a = torch.empty(1, size, size, 3, requires_grad=True)
        b = torch.empty(1, size, size, 3)
        return calls * _count(lambda: net(a, b).sum().backward())


def field_query(cfg: Dict, n_points: int, backward: bool) -> int:
    """One query of every head of the attribute field at ``n_points``
    points: five two-layer heads on the hash features (the offsets head
    also takes the 2-dim latent); with ``backward`` the gradients to the
    heads' weights and to their inputs (the hash tables train), twice the
    forward's products."""
    f = cfg["field"]
    enc = f["num_levels"] * f["features_per_level"]
    hidden = f["hidden_dim"]
    dims = [(enc, 3), (enc, 1), (enc, 4), (enc + 2, 3), (enc, 1)]
    fwd = sum(2 * n_points * (a * hidden + hidden * b) for a, b in dims)
    return 3 * fwd if backward else fwd


def skinning(n_points: int, n_joints: int) -> int:
    """The per-point blend of the joints' 4x4 transforms: [N, J] @ [J, 16]."""
    return 2 * n_points * n_joints * 16


def train_step(cfg: Dict, n_points: int, n_joints: int) -> Dict[str, int]:
    """One guided training step: bf16 networks (UNet forward, VAE forward
    and input gradient, the two normal-LPIPS distances with their input
    gradient) and float32 work (one field query with its backward, the
    skinning of every render: the gen views, the GT pass, the normal
    pair)."""
    t, gd = cfg["train"], cfg["guidance"]
    V = t["n_views"]
    bf16 = (unet_forward(gd, V) + vae_forward_backward(gd, V)
            + lpips_forward_backward(t["normal_size"], 2))
    renders = V + 2
    f32 = field_query(cfg, n_points, backward=True) + renders * skinning(n_points, n_joints)
    return {"bf16": bf16, "f32": f32}


def view(cfg: Dict, n_points: int, n_joints: int) -> Dict[str, int]:
    """One turntable view: the field query and the skinning, float32."""
    return {"bf16": 0,
            "f32": field_query(cfg, n_points, backward=False) + skinning(n_points, n_joints)}
