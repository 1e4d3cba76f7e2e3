"""Tile-grid machinery (port of ``soar_tpu.render.tilegrid``): 16x16 tiles,
a static per-surfel slot grid, sort-by-packed-key binning, range
extraction, and the tile->image untile reshape.

The JAX package packs (tile, quantized depth) into one uint32 sort key.
Torch has no uint32 sort, so the port builds the same value in int64
(``tile << depth_bits | dq``, never negative and below 2^32) and sorts it
stably: equal keys keep their slot order, as ``lax.sort_key_val`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def slot_tiles(
    side: int,
    mnx: torch.Tensor,
    mny: torch.Tensor,
    mxx: torch.Tensor,
    mxy: torch.Tensor,
    ok_row: torch.Tensor,
    ntx: int,
    NT: int,
) -> torch.Tensor:
    """Each row's ``side^2`` candidate tile ids from its clamped tile rect
    [mnx, mxx) x [mny, mxy); slots outside the rect or with
    ``ok_row=False`` route to the sentinel tile ``NT`` (sorts last)."""
    dxy = torch.arange(side, dtype=torch.int64, device=mnx.device)
    dx = dxy.repeat(side)  # [side*side]
    dy = dxy.repeat_interleave(side)
    tx = mnx[:, None] + dx[None, :]
    ty = mny[:, None] + dy[None, :]
    ok = (tx < mxx[:, None]) & (ty < mxy[:, None]) & ok_row[:, None]
    return torch.where(ok, ty * ntx + tx, NT)


def tile_ranges(
    sorted_tile: torch.Tensor, NT: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tile (start offset, count) in a tile-sorted key array."""
    boundaries = torch.arange(NT, dtype=sorted_tile.dtype, device=sorted_tile.device)
    starts = torch.searchsorted(sorted_tile, boundaries, right=False)
    ends = torch.searchsorted(sorted_tile, boundaries, right=True)
    return starts, ends - starts


def depth_bits_for(NT: int) -> int:
    """Bits left for quantized depth in a 32-bit (tile, depth) packed key."""
    tile_bits = max(int(NT + 1).bit_length(), 1)
    return 32 - tile_bits


def quantize_depth(
    depth_key: torch.Tensor, valid: torch.Tensor, depth_bits: int
) -> torch.Tensor:
    """Quantize depth over the frame's valid [min, max] range into
    ``depth_bits`` bits, in float32 as the JAX package does.  The float ->
    integer cast follows XLA's (NaN -> 0, saturating at 2^32 - 1) and the
    clamp comes AFTER it: f32 rounds 2^db - 1 up to 2^db for db > 24."""
    inf = float("inf")
    dmin = torch.min(torch.where(valid, depth_key, inf))
    dmax = torch.max(torch.where(valid, depth_key, -inf))
    span = torch.clamp_min(dmax - dmin, 1e-8)
    q = torch.clamp_min((depth_key - dmin) / span * (2.0**depth_bits - 1.0), 0.0)
    q = torch.nan_to_num(q, nan=0.0).clamp_max(2.0**32 - 1.0)
    return torch.clamp_max(q.to(torch.int64), 2**depth_bits - 1)


def untile(
    img_flat: torch.Tensor, ch: int, ntx: int, nty: int, tile: int,
    H: int, W: int,
) -> torch.Tensor:
    """[NT, tile*tile, ch] tile-major pixels -> [H, W, ch] image."""
    img = img_flat.reshape(nty, ntx, tile, tile, ch)
    img = img.permute(0, 2, 1, 3, 4).reshape(nty * tile, ntx * tile, ch)
    return img[:H, :W]
