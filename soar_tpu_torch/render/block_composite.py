"""Per-tile alpha composite: the CUDA kernel's wrapper (port of
``soar_tpu.render.block_composite``).

:func:`composite_block` has the signature and outputs of the JAX
``composite_block``.  A CPU tensor goes to the plain PyTorch version
(:func:`soar_tpu_torch.render.composite.composite_block_plain`); a CUDA
tensor launches ``csrc/composite_fwd.cu`` or raises — there is no
fallback.  Only the forward exists: an input that requires grad on CUDA
raises until the backward kernel is ported with the training slice.

Feature packing handed to the kernel (one [NT, K, F] array, F = 9 + C),
as in the JAX package:

    0:2  xy        splat mean (pixels)
    2:5  conic     inverse 2D covariance (a, b, c)
    5    opacity
    6    valid     1.0 / 0.0 slot mask
    7:9  e         depth-correction coefficients: dif_z = dx*e0 + dy*e1
    9:9+C attrs    channels composited linearly (colors, normals, depth)
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .composite import composite_block_plain

MAX_CHANNELS = 16  # the kernel is instantiated for C = 1..16
MAX_PIXELS = 256  # one thread per pixel: 16x16 tiles
_SMEM_LIMIT = 48 * 1024  # static-launch shared memory per block


def composite_block(
    xy: torch.Tensor,  # [NT, K, 2]
    conic: torch.Tensor,  # [NT, K, 3]
    opac: torch.Tensor,  # [NT, K]
    valid: torch.Tensor,  # [NT, K] bool
    attrs: torch.Tensor,  # [NT, K, C] linear channels
    e: torch.Tensor,  # [NT, K, 2] depth-correction coeffs (zeros -> corr 0)
    pixf: torch.Tensor,  # [NT, P, 2]
    alpha_clamp: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    t_min: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(accum [NT, P, C], corr [NT, P], T [NT, P])``; the depth
    channel's plane correction ``corr`` must be SUBTRACTED by the caller."""
    args = (xy, conic, opac, valid, attrs, e, pixf)
    if xy.device.type == "cpu":
        return composite_block_plain(*args, alpha_clamp, alpha_min, t_min)
    if xy.device.type != "cuda" or any(t.device != xy.device for t in args):
        raise ValueError(
            f"composite_block takes CPU or CUDA tensors on one device, got "
            f"{sorted({str(t.device) for t in args})}"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise NotImplementedError(
            "composite_block on CUDA is forward-only: its backward kernel "
            "arrives with the training slice of the port"
        )
    NT, K = xy.shape[:2]
    C = attrs.shape[-1]
    P = pixf.shape[1]
    feat = torch.cat(
        [xy, conic, opac[..., None], valid.to(xy.dtype)[..., None], e, attrs],
        dim=-1,
    ).contiguous()
    pixf = pixf.contiguous()
    F = feat.shape[-1]
    if feat.dtype != torch.float32 or pixf.dtype != torch.float32:
        raise TypeError("composite_block's kernel takes float32 inputs")
    if not (1 <= C <= MAX_CHANNELS) or not (1 <= P <= MAX_PIXELS):
        raise ValueError(f"kernel takes 1..{MAX_CHANNELS} channels and "
                         f"1..{MAX_PIXELS} pixels per tile, got C={C}, P={P}")
    if K * F * 4 > _SMEM_LIMIT:
        raise ValueError(f"K={K} slots x {F} features exceed the kernel's "
                         f"{_SMEM_LIMIT} B of shared memory")
    if tuple(pixf.shape) != (NT, P, 2) or feat.shape[:2] != (NT, K):
        raise ValueError("composite_block: inconsistent tile/slot shapes")

    accum = torch.empty((NT, C, P), dtype=torch.float32, device=xy.device)
    corr = torch.empty((NT, P), dtype=torch.float32, device=xy.device)
    T = torch.empty((NT, P), dtype=torch.float32, device=xy.device)
    lib = kernels.load("composite_fwd")
    stream = torch.cuda.current_stream(xy.device).cuda_stream
    err = lib.composite_fwd(
        feat.data_ptr(), pixf.data_ptr(), accum.data_ptr(), corr.data_ptr(),
        T.data_ptr(), NT, K, P, C,
        float(alpha_clamp), float(alpha_min), float(t_min), stream,
    )
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error {err}")
    composite_block.launches += 1
    return accum.transpose(1, 2), corr, T


# Kernel launches since the last reset; chip_smoke.py reads it to show the
# render path went through the kernel.
composite_block.launches = 0
