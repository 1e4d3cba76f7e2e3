"""Multiresolution hash encoding (port of ``soar_tpu.field.hashgrid``).

Two storage modes, as in the JAX package: ``cell`` (default) hashes the
lattice cell once and one wide row holds its 8 corner features; ``corner``
hashes every corner independently (tcnn / nerfstudio semantics).  The f32
table is cast to ``dtype`` (bf16 by default, round-to-nearest-even) before
the gather; the lerp accumulates in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..core.constants import constant


@dataclasses.dataclass(frozen=True)
class HashGridConfig:
    num_levels: int = 16
    min_res: int = 16
    max_res: int = 2048
    log2_hashmap_size: int = 18
    features_per_level: int = 2
    init_scale: float = 1e-4
    mode: str = "cell"  # "cell" | "corner"
    dtype: str = "bfloat16"

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def out_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def row_width(self) -> int:
        mult = 8 if self.mode == "cell" else 1
        return self.features_per_level * mult

    def resolutions(self) -> Tuple[int, ...]:
        if self.num_levels == 1:
            return (self.min_res,)
        growth = math.exp(
            (math.log(self.max_res) - math.log(self.min_res))
            / (self.num_levels - 1)
        )
        return tuple(
            int(math.floor(self.min_res * growth**lvl))
            for lvl in range(self.num_levels)
        )


def init_hash_grid(
    generator: torch.Generator, cfg: HashGridConfig, device
) -> torch.Tensor:
    """Table [num_levels, table_size, row_width] float32, U(-s, s), drawn
    from ``generator`` (which must live on ``device``)."""
    u = torch.rand(
        (cfg.num_levels, cfg.table_size, cfg.row_width),
        generator=generator,
        device=device,
    )
    return (2.0 * u - 1.0) * cfg.init_scale


_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


def _hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, mask: int):
    """``soar_tpu``'s uint32 hash in int64: each product is reduced mod 2^32
    (the uint32 wraparound), then XOR-folded and masked."""
    h = (
        ((ix * _PRIMES[0]) & _U32)
        ^ ((iy * _PRIMES[1]) & _U32)
        ^ ((iz * _PRIMES[2]) & _U32)
    )
    return h & mask


_CORNERS = tuple((c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8))


def hash_encode(
    table: torch.Tensor, positions: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """Encode positions in [0, 1]^3 -> [N, num_levels * features] float32:
    trilinear interpolation of the 8 corner features at every level."""
    dev = positions.device
    p = positions.reshape(-1, 3)
    N = p.shape[0]
    L = cfg.num_levels
    F = cfg.features_per_level
    mask = cfg.table_size - 1

    res = constant(cfg.resolutions(), torch.float32, dev)
    scaled = p[:, None, :] * res[None, :, None]  # [N, L, 3]
    base_f = torch.floor(scaled)
    w = scaled - base_f
    base = base_f.to(torch.int64)

    corners = constant(_CORNERS, torch.int64, dev)  # [8, 3]
    cw = torch.prod(
        torch.where(
            corners[None, None, :, :] == 1,
            w[:, :, None, :],
            1.0 - w[:, :, None, :],
        ),
        dim=-1,
    )  # [N, L, 8]

    level_off = (torch.arange(L, device=dev) * cfg.table_size)[None, :]
    gdtype = getattr(torch, cfg.dtype)
    if cfg.mode == "cell":
        h = _hash3(base[..., 0], base[..., 1], base[..., 2], mask)  # [N, L]
        flat_idx = (h + level_off).reshape(-1)
        flat_table = table.reshape(L * cfg.table_size, cfg.row_width)
    else:
        cidx = base[:, :, None, :] + corners[None, None, :, :]  # [N, L, 8, 3]
        h = _hash3(cidx[..., 0], cidx[..., 1], cidx[..., 2], mask)
        flat_idx = (h + level_off[:, :, None]).reshape(-1)
        flat_table = table.reshape(L * cfg.table_size, F)
    rows = flat_table.to(gdtype)[flat_idx]
    g = rows.reshape(N, L, 8, F).to(torch.float32)

    out = torch.sum(g * cw[..., None], dim=2)  # [N, L, F]
    return out.reshape(positions.shape[:-1] + (L * F,))


def normalize_positions(
    xyz: torch.Tensor, aabb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB-normalize to [0,1]^3; positions outside the box become 0."""
    pos = (xyz - aabb[0]) / (aabb[1] - aabb[0])
    selector = torch.all((pos > 0.0) & (pos < 1.0), dim=-1)
    return pos * selector[..., None], selector
