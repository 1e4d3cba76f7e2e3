"""Order-dependent alpha compositing, plain PyTorch (port of
``soar_tpu.render.composite``).

The reference's per-pixel front-to-back loop (``forward.cu:497-633``: 0.99
alpha clamp, 1/255 alpha skip, sticky T < 1e-4 early stop) written as an
exclusive cumulative product along the depth-sorted axis.  These functions
are the CPU path of the renderer and the plain version the CUDA composite
kernels (:mod:`soar_tpu_torch.render.block_composite`,
:mod:`soar_tpu_torch.render.tiles_composite`) are held against.
"""

from __future__ import annotations

from typing import Tuple

import torch


def splat_alpha(
    d: torch.Tensor,  # [..., 2] pixel offset (mean_xy - pixf)
    conic: torch.Tensor,  # [..., 3] (a, b, c)
    opacity: torch.Tensor,  # [...]
    valid: torch.Tensor,  # [...] bool
    alpha_clamp: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
) -> torch.Tensor:
    """Gaussian falloff alpha with the skip rules applied as a hard zero:
    power>0 and alpha<1/255 contribute nothing and do not advance T."""
    dx, dy = d[..., 0], d[..., 1]
    power = (
        -0.5 * (conic[..., 0] * dx * dx + conic[..., 2] * dy * dy)
        - conic[..., 1] * dx * dy
    )
    alpha = torch.clamp_max(opacity * torch.exp(torch.clamp_max(power, 0.0)), alpha_clamp)
    keep = (power <= 0.0) & (alpha >= alpha_min) & valid
    # where(), not alpha*keep: a NaN alpha must mask to 0, not NaN*0 = NaN.
    return torch.where(keep, alpha, 0.0)


def composite_weights(
    alpha: torch.Tensor, t_min: float = 1e-4
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend weights w_i = alpha_i * prod_{j<i}(1 - alpha_j) along the last
    axis with the early-stop rule: the first splat that would push T below
    ``t_min`` — and everything behind it — is excluded.

    Returns (weights [..., K], final transmittance [...])."""
    one_minus = 1.0 - alpha
    ones = torch.ones_like(alpha[..., :1])
    t_excl = torch.cat([ones, torch.cumprod(one_minus[..., :-1], dim=-1)], dim=-1)
    violates = t_excl * one_minus < t_min
    excluded = torch.cumsum(violates.to(torch.int32), dim=-1) >= 1
    alpha_eff = torch.where(excluded, 0.0, alpha)

    one_minus_eff = 1.0 - alpha_eff
    t_excl_eff = torch.cat(
        [ones, torch.cumprod(one_minus_eff[..., :-1], dim=-1)], dim=-1
    )
    weights = alpha_eff * t_excl_eff
    t_final = torch.prod(one_minus_eff, dim=-1)
    return weights, t_final


def finalize_accum(
    accum_color: torch.Tensor,  # [..., C] pre-background weighted sum
    accum_normal: torch.Tensor,  # [..., 3]
    accum_depth: torch.Tensor,  # [...] plane-corrected weighted depth sum
    t_final: torch.Tensor,  # [...]
    bg_color: torch.Tensor,  # [C]
    normalize_depth: bool,
):
    """Output assembly from pre-accumulated channel sums (the composite
    kernel's outputs): T clamped to <= 1-1e-6, color over bg, depth
    normalized by accumulated alpha (or the reference's ``D + T*10``)."""
    T = torch.clamp_max(t_final, 1.0 - 1e-6)
    color = accum_color + T[..., None] * bg_color
    depth = accum_depth / (1.0 - T) if normalize_depth else accum_depth + T * 10.0
    return color, accum_normal, depth, 1.0 - T, T


def composite_block_plain(
    xy: torch.Tensor,  # [NT, K, 2]
    conic: torch.Tensor,  # [NT, K, 3]
    opac: torch.Tensor,  # [NT, K]
    valid: torch.Tensor,  # [NT, K] bool
    attrs: torch.Tensor,  # [NT, K, C]
    e: torch.Tensor,  # [NT, K, 2] depth-correction coeffs
    pixf: torch.Tensor,  # [NT, P, 2]
    alpha_clamp: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    t_min: float = 1e-4,
    compute_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The function ``soar_tpu.render.block_composite.composite_block``
    computes, through the dense [NT, P, K] cumprod chain.

    Returns ``(accum [NT, P, C], corr [NT, P], T [NT, P])``; the caller
    SUBTRACTS ``corr = sum_k w_k * (dx*e0 + dy*e1)`` from the depth channel.

    ``compute_dtype=torch.bfloat16`` is the JAX package's bf16 XLA chain
    (``RasterConfig.composite_dtype``): the splat set is decided in f32,
    alpha, the exclusion cumprod and the weights ride bf16, and the channel
    sums accumulate bf16 values in f32.  As there, the plane-corrected depth
    is rounded per pixel-slot: the last channel's ``attr - dif_z`` goes to
    bf16 whole, and ``corr`` returns what the caller's subtraction needs.
    """
    d = xy[:, None, :, :] - pixf[:, :, None, :]  # [NT, P, K, 2]
    alpha = splat_alpha(
        d, conic[:, None], opac[:, None], valid[:, None], alpha_clamp, alpha_min
    )
    dif_z = d[..., 0] * e[:, None, :, 0] + d[..., 1] * e[:, None, :, 1]
    if compute_dtype == torch.float32:
        weights, t_final = composite_weights(alpha, t_min)
        accum = torch.einsum("npk,nkc->npc", weights, attrs)
        corr = torch.sum(weights * dif_z, dim=-1)
        return accum, corr, t_final
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got {compute_dtype}")
    weights, t_final = composite_weights(alpha.to(torch.bfloat16), t_min)
    w = weights.float()
    rounded = attrs.to(torch.bfloat16).float()
    accum = torch.einsum("npk,nkc->npc", w, rounded)
    depth_k = (attrs[:, None, :, -1] - dif_z).to(torch.bfloat16).float()
    corr = torch.sum(w * (rounded[:, None, :, -1] - depth_k), dim=-1)
    return accum, corr, t_final.float()


def depth_plane_coeffs(jinv: torch.Tensor) -> torch.Tensor:
    """The linear form of the per-pixel depth's plane correction: with
    ``e = depth_plane_coeffs(jinv)`` [..., 2], a slot's depth at screen
    offset (dx, dy) from its mean is ``depth - (dx*e0 + dy*e1)`` (the z row
    of ``auxiliary.h:390-397``, from ``jinv`` columns 0-3, 6 and 9)."""
    return torch.stack(
        [
            jinv[..., 0] * jinv[..., 6] + jinv[..., 2] * jinv[..., 9],
            jinv[..., 1] * jinv[..., 6] + jinv[..., 3] * jinv[..., 9],
        ],
        dim=-1,
    )


def tile_pixel_centres(tile_origins: torch.Tensor, tile: int) -> torch.Tensor:
    """Pixel coordinates [NT, tile*tile, 2] (x, y; row-major within the
    tile) of the tiles whose top-left pixels are ``tile_origins [NT, 2]``."""
    l_ar = torch.arange(tile, dtype=torch.float32, device=tile_origins.device)
    lx = l_ar.repeat(tile)
    ly = l_ar.repeat_interleave(tile)
    o = tile_origins.to(torch.float32)
    return torch.stack([o[:, None, 0] + lx[None, :], o[:, None, 1] + ly[None, :]], dim=-1)
