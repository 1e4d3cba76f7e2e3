"""Training losses, channel-last (port of ``soar_tpu.train.losses``):
L1 / L2, masked L1, windowed SSIM, cosine normal loss, total variation and
PSNR."""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..core.constants import constant


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


def masked_l1(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """L1 over masked pixels only (mean over the selected elements)."""
    m = mask.to(a.dtype)
    if m.ndim == a.ndim - 1:
        m = m[..., None]
    denom = torch.clamp_min(torch.sum(m) * a.shape[-1] / max(m.shape[-1], 1), 1.0)
    return torch.sum(torch.abs(a - b) * m) / denom


@lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.array(
        [math.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2))
         for x in range(window_size)]
    )
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


@lru_cache(maxsize=8)
def _window_values(window_size: int, sigma: float):
    """:func:`_gaussian_window` as nested tuples of its float32 values, the
    key of its device constant."""
    return tuple(map(tuple, _gaussian_window(window_size, sigma).tolist()))


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Windowed SSIM: 11x11 sigma-1.5 Gaussian window applied per channel
    (a depthwise ``conv2d`` with ``groups=C`` and same padding), C1 = 0.01²,
    C2 = 0.03².  Inputs [..., H, W, C] in [0, 1]."""
    C = img1.shape[-1]
    # A device constant: a host copy per call would be a host sync.
    w = constant(_window_values(window_size, 1.5), torch.float32, img1.device)
    kernel = w[None, None].expand(C, 1, window_size, window_size)
    pad = window_size // 2

    def blur(x):
        x4 = x.reshape((-1,) + x.shape[-3:]).permute(0, 3, 1, 2)  # [B, C, H, W]
        out = F.conv2d(x4, kernel, padding=pad, groups=C)
        return out.permute(0, 2, 3, 1).reshape(x.shape)

    mu1, mu2 = blur(img1), blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))
    return torch.mean(ssim_map)


def cos_loss(output01, gt01, mask=None, thrsh: float = 0.0, weight: float = 1.0):
    """1 - cosine similarity of [0, 1]-encoded normals, averaged over the
    pixels whose cosine is below cos(thrsh) (a masked mean)."""
    o = output01 * 2.0 - 1.0
    g = gt01 * 2.0 - 1.0
    cos = torch.sum(o * g * weight, dim=-1)
    sel = cos < np.cos(thrsh)
    if mask is not None:
        sel = sel & mask.bool()
    sel = sel.to(cos.dtype)
    return torch.sum((1.0 - cos) * sel) / torch.clamp_min(torch.sum(sel), 1.0)


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Total variation on [..., H, W, C]."""
    dh = torch.mean((img[..., 1:, :, :] - img[..., :-1, :, :]) ** 2)
    dw = torch.mean((img[..., :, 1:, :] - img[..., :, :-1, :]) ** 2)
    return dh + dw


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp_min(mse, 1e-12))
