"""Neural environment-map background (port of ``soar_tpu.train.background``).

Degree-3 spherical-harmonics direction encoding (tcnn convention, applied
to directions remapped to [0, 1]) -> bias-free 9 -> 16 -> 16 -> 3 MLP ->
sigmoid, and the random solid-background augmentation (probability 0.5,
one colour shared across views, zeroed half the time).  The background is
never optimised (the reference builds its optimizer and drops it), so its
parameters are plain tensors in the JAX package's layout:
``{"layers": [{"w": [in, out]}, ...]}``.
"""

from __future__ import annotations

from typing import Dict

import torch


def _sh_encoding_deg3(d: torch.Tensor) -> torch.Tensor:
    """tcnn SphericalHarmonics degree 3 of directions in [0, 1]^3, which it
    first maps back to [-1, 1]."""
    d = d * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * x * y,
            -1.0925484305920792 * y * z,
            0.94617469575755997 * z * z - 0.31539156525251999,
            -1.0925484305920792 * x * z,
            0.54627421529603959 * (x * x - y * y),
        ],
        dim=-1,
    )


def init_background(generator: torch.Generator, hidden: int = 16) -> Dict:
    """Bias-free layers (threestudio's VanillaMLP), each weight
    U(-1/sqrt(in), 1/sqrt(in)) from ``generator``, on its device."""
    layers = []
    for a, b in ((9, hidden), (hidden, hidden), (hidden, 3)):
        u = torch.rand((a, b), generator=generator, device=generator.device)
        layers.append({"w": (2.0 * u - 1.0) / a**0.5})
    return {"layers": layers}


def background_color(params: Dict, dirs: torch.Tensor) -> torch.Tensor:
    """dirs [..., 3] unit vectors -> colour [..., 3] in (0, 1)."""
    x = _sh_encoding_deg3((dirs + 1.0) / 2.0)
    layers = params["layers"]
    for i, layer in enumerate(layers):
        x = x @ layer["w"]
        if "b" in layer:
            x = x + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return torch.sigmoid(x)


def sample_random_aug(generator: torch.Generator, aug_prob: float = 0.5) -> Dict:
    """The augmentation's draws, on the generator's device: ``use_aug``
    (a bool tensor, u < aug_prob) and ``solid`` [3] (a normal colour, zeroed
    when a second coin says so)."""
    dev = generator.device
    u = torch.rand(2, generator=generator, device=dev)
    solid = torch.randn(3, generator=generator, device=dev)
    return {"use_aug": u[0] < aug_prob, "solid": solid * (u[1] < 0.5)}


def apply_random_aug(color: torch.Tensor, aug: Dict) -> torch.Tensor:
    """The solid colour, shared across views, replaces ``color`` [V, H, W, 3]
    where ``aug["use_aug"]``; no gradient reaches the MLP through that
    branch, as in the JAX package's ``where``."""
    solid = aug["solid"].to(color.dtype).expand(color.shape)
    return torch.where(aug["use_aug"], solid, color)
