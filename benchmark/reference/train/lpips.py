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
the means in float32: the loss path's default, as in the JAX package.

Weights: the benchmark's seeded state dict (``benchmark.scene.lpips_state``),
the same values the program reads from the CLI's ``--lpips-weights``
pickle.  The convolutions are PyTorch's own.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


_VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512)
_SLICE_AFTER = (1, 3, 6, 9, 12)  # convs whose ReLU output is tapped

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
