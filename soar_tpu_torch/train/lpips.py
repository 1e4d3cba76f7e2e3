"""LPIPS with a VGG16 backbone (port of ``soar_tpu.train.lpips``).

The reference computes its LPIPS-VGG losses and eval metric with the
``lpips`` package (``system/gaussian_surfel_mvdream.py:342-358, 561-567``).
This is LPIPS v0.1 with the JAX package's arithmetic, not the package's:

    (x - shift) / scale -> VGG16 features after relu1_2, relu2_2, relu3_3,
    relu4_3, relu5_3 -> a * rsqrt(sum(a^2) + 1e-10) over channels ->
    squared difference -> per-channel max(w, 0) weights -> sum over
    channels, mean over pixels, sum over the five layers.

``LPIPS(dtype=torch.bfloat16)`` runs the convolutions, forward and
backward, in bf16 and keeps the unit normalisation, the differences and
the means in float32: the loss path's default, as in the JAX package.  The
eval path (:func:`load_lpips`) is always float32.

Weights: :func:`convert_lpips_params` maps torchvision's VGG16 ``features``
and the ``lpips`` package's ``lin{i}`` weights onto the module; the JAX
CLI's ``--lpips-weights`` pickle (``docs/REAL_WEIGHTS.md`` section 1: flax
variables whose leaves are numpy arrays) loads through
:func:`soar_tpu_torch.io.from_jax.lpips_from_flax`.  A missing file gives
``None`` and LPIPS stays off.  The convolutions are PyTorch's own: the JAX
package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..core import spans

_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512)
_SLICE_AFTER = (1, 3, 6, 9, 12)  # convs whose ReLU output is tapped
# torchvision's ``vgg16().features`` index of each of the 13 convolutions.
VGG16_CONV_LAYERS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """torchvision's VGG16 ``features`` up to relu5_3 (the same indices, so
    its state_dict loads as ``features.*``); returns the five tapped ReLU
    outputs, NCHW."""

    def __init__(self):
        super().__init__()
        layers, cin, self.taps, conv_i = [], 3, set(), 0
        for c in _VGG16_CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
            if conv_i in _SLICE_AFTER:
                self.taps.add(len(layers) - 1)
            cin, conv_i = c, conv_i + 1
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                feats.append(x)
        return tuple(feats)


class LPIPS(nn.Module):
    """``forward(img0, img1)``: [B, H, W, 3] in [-1, 1] -> [B] distances.
    The VGG runs in ``dtype``; both images go through it as one batch."""

    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.vgg = VGG16Features().to(dtype)
        self.compute_dtype = dtype
        for i, c in enumerate((64, 128, 256, 512, 512)):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(c)))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        x = (torch.cat([img0, img1]) - self.shift) / self.scale
        feats = self.vgg(x.permute(0, 3, 1, 2).to(self.compute_dtype))
        B = img0.shape[0]
        total = 0.0
        for i, f in enumerate(feats):
            f = f.to(torch.float32)
            f = f * torch.rsqrt(torch.sum(f * f, dim=1, keepdim=True) + 1e-10)
            d = (f[:B] - f[B:]) ** 2
            w = torch.clamp_min(getattr(self, f"lin{i}"), 0.0)
            total = total + torch.mean(torch.sum(d * w[:, None, None], dim=1), dim=(1, 2))
        return total


def convert_lpips_params(vgg_sd: Dict, lpips_sd: Dict) -> Dict[str, torch.Tensor]:
    """torchvision VGG16 (``features.{0,2,...,28}.weight/bias``) and the
    ``lpips`` package's ``lin{i}.model.1.weight`` [1, C, 1, 1] -> an
    :class:`LPIPS` state_dict (CPU float32 tensors)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    sd = {}
    for layer in VGG16_CONV_LAYERS:
        for k in ("weight", "bias"):
            sd[f"vgg.features.{layer}.{k}"] = f32(vgg_sd[f"features.{layer}.{k}"])
    for i in range(5):
        sd[f"lin{i}"] = f32(lpips_sd[f"lin{i}.model.1.weight"])[0, :, 0, 0]
    return sd


def lpips_module(path: Optional[str], dtype=torch.float32, device="cuda") -> Optional[LPIPS]:
    """A frozen :class:`LPIPS` on ``device`` from the JAX CLI's pickle, or
    None if ``path`` is None or absent."""
    from ..io.from_jax import lpips_from_flax

    if path is None or not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        sd = lpips_from_flax(pickle.load(f))
    net = LPIPS(dtype)
    with torch.no_grad():
        for k, v in net.state_dict().items():
            v.copy_(sd.pop(k))
    if sd:
        raise ValueError(f"LPIPS weights: unexpected keys {sorted(sd)[:8]}")
    return net.to(resolve_device(device)).eval().requires_grad_(False)


def make_lpips_fn(path: Optional[str] = None, dtype=torch.bfloat16,
                  device="cuda") -> Optional[Callable]:
    """The loss path: ``fn(a, b) -> scalar`` over [H, W, 3] images in
    [-1, 1], differentiable in both, or None if the weights file is absent.
    The trainer's ``lpips_fn`` (normal-LPIPS and VGG RGB terms)."""
    net = lpips_module(path, dtype, device)
    if net is None:
        return None

    @spans.spanned("soar.lpips")
    def fn(a, b):
        return net(a[None], b[None])[0]

    fn.net = net
    return fn


def load_lpips(path: Optional[str] = None, device="cuda") -> Optional[Callable]:
    """The eval path, always float32: ``fn(a01, b01) -> float`` over
    [H, W, 3] images in [0, 1] (numpy or tensors), or None if the weights
    are absent."""
    net = lpips_module(path, torch.float32, device)
    if net is None:
        return None
    dev = resolve_device(device)

    def to_pm1(x):
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float32))
        return x.to(dev, torch.float32) * 2.0 - 1.0

    @torch.no_grad()
    def fn(a01, b01):
        return float(net(to_pm1(a01)[None], to_pm1(b01)[None])[0])

    fn.net = net
    return fn


def mock_lpips_variables(seed: int = 0, device="cpu") -> Dict:
    """Random LPIPS-VGG16 weights in the ``--lpips-weights`` pickle's layout
    (flax variables, numpy leaves), drawn on ``device`` from a generator
    seeded ``seed``: He-normal HWIO kernels, zero biases, ``lin`` weights
    uniform in [0, 1).  They exercise the cost and the plumbing of the LPIPS
    terms where no VGG16 file can be downloaded; the values mean nothing."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vgg, cin, i = {}, 3, 0
    for c in _VGG16_CFG:
        if c == "M":
            continue
        k = torch.randn((3, 3, cin, c), generator=gen, device=dev) * (2.0 / (9 * cin)) ** 0.5
        vgg[f"conv_{i}"] = {"kernel": k.cpu().numpy(), "bias": np.zeros(c, np.float32)}
        cin, i = c, i + 1
    params = {"vgg": vgg}
    for j, c in enumerate((64, 128, 256, 512, 512)):
        params[f"lin_{j}"] = torch.rand(c, generator=gen, device=dev).cpu().numpy()
    return {"params": params}
