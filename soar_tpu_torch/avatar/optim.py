"""Per-group Adam over the avatar's parameters (port of
``soar_tpu.avatar.optim``).

The reference's per-group torch Adam (``geometry/surfel_base.py:596-687``)
as one ``torch.optim.Adam`` with a parameter group per reference group:
betas (0.9, 0.999), eps 1e-15, field scales head x10 and offsets head x0.01
the field LR, and ``xyz`` on the exponential log-lerp schedule, set before
every step from ``schedule(count - 1)``.  The field's ``aabb`` is a buffer
and never updates.

The JAX package's optax Adam updates every leaf every step with one global
count; ``torch.optim.Adam`` skips a parameter whose grad is None and counts
steps per parameter.  So :meth:`AvatarOptimizer.step` first gives every
parameter autograd left without a grad a zero grad, which makes the two
the same function.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch

from ..core import spans
from ..train.config import OptimConfig
from .state import AvatarParams


def expon_lr_schedule(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1000000,
) -> Callable[[int], float]:
    """Log-linear (exponential) decay with an optional sin-eased warm delay
    (the Plenoxels / JaxNeRF schedule the reference uses for xyz)."""

    def schedule(step: int) -> float:
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * math.sin(
                0.5 * math.pi * min(max(step / lr_delay_steps, 0.0), 1.0)
            )
        else:
            delay = 1.0
        t = min(max(step / max_steps, 0.0), 1.0)
        log_lerp = math.exp(
            math.log(max(lr_init, 1e-32)) * (1 - t) + math.log(max(lr_final, 1e-32)) * t
        )
        return delay * log_lerp

    return schedule


def param_groups(params: AvatarParams, cfg: OptimConfig) -> Dict[str, List[torch.nn.Parameter]]:
    """Group name -> parameters, the reference's groups."""
    f = params.field
    field = [f.encoding, f.quat_encoding]
    for head in (f.mlp_shs, f.mlp_quats, f.mlp_opacities):
        field += list(head.parameters())
    return {
        "xyz": [params.xyz],
        "color": [params.colors],
        "opacity": [params.opacity],
        "scaling": [params.scaling],
        "rotation": [params.rotation],
        "occ": [params.occ],
        "field": field,
        "field_scales": list(f.mlp_scales.parameters()),
        "field_offsets": list(f.mlp_offsets.parameters()),
        "latent_pose": [params.latent_pose],
    }


class AvatarOptimizer:
    """``torch.optim.Adam`` over :func:`param_groups` plus the xyz schedule."""

    def __init__(self, params: AvatarParams, cfg: OptimConfig):
        self.xyz_schedule = expon_lr_schedule(
            lr_init=cfg.position_lr_init * cfg.spatial_lr_scale,
            lr_final=cfg.position_lr_final * cfg.spatial_lr_scale,
            lr_delay_mult=cfg.position_lr_delay_mult,
            max_steps=cfg.position_lr_max_steps,
        )
        lrs = {
            "xyz": self.xyz_schedule(0),
            "color": cfg.feature_lr,
            "opacity": cfg.opacity_lr,
            "scaling": cfg.scaling_lr,
            "rotation": cfg.rotation_lr,
            "occ": cfg.occ_lr,
            "field": cfg.field_lr,
            "field_scales": cfg.field_lr * 10.0,
            "field_offsets": cfg.field_lr * 0.01,
            "latent_pose": cfg.latent_pose_lr,
        }
        self.groups = param_groups(params, cfg)
        self.adam = torch.optim.Adam(
            [{"params": ps, "lr": lrs[name], "name": name} for name, ps in self.groups.items()],
            betas=(0.9, 0.999),
            eps=cfg.eps,
            # On the card the step counters and bias corrections stay on the
            # device (no host op or sync in the step).
            capturable=params.xyz.device.type == "cuda",
        )
        self.count = 0

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    @spans.spanned("soar.optim")
    @torch.no_grad()
    def step(self):
        for ps in self.groups.values():
            for p in ps:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.count += 1
        for group in self.adam.param_groups:
            if group["name"] == "xyz":
                group["lr"] = self.xyz_schedule(self.count - 1)
        self.adam.step()

    def state_dict(self) -> Dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, sd: Dict):
        self.adam.load_state_dict(sd["adam"])
        self.count = int(sd["count"])


def make_optimizer(params: AvatarParams, cfg: OptimConfig) -> AvatarOptimizer:
    return AvatarOptimizer(params, cfg)
