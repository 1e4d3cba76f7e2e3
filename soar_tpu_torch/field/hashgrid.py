"""Multiresolution hash encoding (port of ``soar_tpu.field.hashgrid``).

Two storage modes, as in the JAX package: ``cell`` (default) hashes the
lattice cell once and one wide row holds its 8 corner features; ``corner``
hashes every corner independently (tcnn / nerfstudio semantics).  The f32
table is cast to ``dtype`` (bf16 by default, round-to-nearest-even) before
the gather; the lerp accumulates in f32.

:func:`hash_encode` on CUDA launches ``csrc/hash_encode.cu`` (forward, and
the table's gradient in the backward), which reads the f32 table in place
and rounds what it gathers; on the CPU it runs the plain PyTorch version,
:func:`hash_encode_plain`, which is also what the kernel is held against.
A CUDA call the kernel is not built for (positions that need a gradient, a
gather dtype other than bf16 or f32, other than 2 features a level, ...)
raises NotImplementedError: there is no plain path on the card.
``hash_encode.kernel`` and ``hash_encode.kernel_bwd`` count the kernel's
forward and backward launches, and ``hash_encode.eager`` the plain calls,
since import.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .. import kernels
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


def _lookup(p: torch.Tensor, cfg: HashGridConfig):
    """The rows that positions ``p`` [N, 3] read, as indices into the table
    flattened to rows (``[N * L]`` in cell mode, ``[N * L * 8]`` in corner
    mode), and the trilinear weights [N, L, 8] of their corners."""
    dev = p.device
    L = cfg.num_levels
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
    if cfg.mode == "cell":
        h = _hash3(base[..., 0], base[..., 1], base[..., 2], mask)  # [N, L]
        flat_idx = (h + level_off).reshape(-1)
    else:
        cidx = base[:, :, None, :] + corners[None, None, :, :]  # [N, L, 8, 3]
        h = _hash3(cidx[..., 0], cidx[..., 1], cidx[..., 2], mask)
        flat_idx = (h + level_off[:, :, None]).reshape(-1)
    return flat_idx, cw


def hash_encode_plain(
    table: torch.Tensor, positions: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """:func:`hash_encode` in plain PyTorch, on any device."""
    p = positions.reshape(-1, 3)
    N = p.shape[0]
    L = cfg.num_levels
    F = cfg.features_per_level
    flat_idx, cw = _lookup(p, cfg)
    flat_table = table.reshape(L * cfg.table_size, cfg.row_width)
    rows = flat_table.to(getattr(torch, cfg.dtype))[flat_idx]
    g = rows.reshape(N, L, 8, F).to(torch.float32)

    out = torch.sum(g * cw[..., None], dim=2)  # [N, L, F]
    return out.reshape(positions.shape[:-1] + (L * F,))


# Gather dtypes the kernel is built for (csrc/hash_encode.cu kF32, kBF16); it
# takes 2 features a level, as every field of the port.
DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def launch_args(n_points: int, cfg: HashGridConfig) -> Tuple[int, ...]:
    """The kernel's integer arguments ``(N, L, log2 rows, corner, dtype
    code)`` for ``n_points`` positions; NotImplementedError where the kernel
    is not built for ``cfg`` (its gather dtype, feature count or mode) or
    the output's indices pass 32 bits."""
    F, L = cfg.features_per_level, cfg.num_levels
    if cfg.dtype not in DTYPE_CODES:
        why = f"gather dtype {cfg.dtype} (it takes {' or '.join(DTYPE_CODES)})"
    elif F != 2:
        why = f"{F} features a level (it takes 2)"
    elif cfg.mode not in ("cell", "corner"):
        why = f"mode {cfg.mode!r}"
    elif n_points * L * F >= 2**31:
        why = f"{n_points} points: the output's indices pass 32 bits"
    else:
        return (n_points, L, cfg.log2_hashmap_size, int(cfg.mode == "corner"),
                DTYPE_CODES[cfg.dtype])
    raise NotImplementedError(f"hash_encode's CUDA kernel is not built for {why}")


def refusal(table: torch.Tensor, positions: torch.Tensor) -> Optional[str]:
    """What in a CUDA call's tensors the kernel is not built for, or None:
    it takes float32 tensors on one device, a table whose rows start on 16
    bytes, and positions that need no gradient (it gives them none)."""
    if torch.is_grad_enabled() and positions.requires_grad:
        return "positions that need a gradient"
    if table.dtype != torch.float32 or positions.dtype != torch.float32:
        return f"a {table.dtype} table with {positions.dtype} positions (it takes float32)"
    if table.device != positions.device:
        return f"a table on {table.device} with positions on {positions.device}"
    if table.data_ptr() % 16:
        return "a table not aligned to 16 bytes"
    return None


def _launch(cfg, args, pos, table=None, out=None, grad_out=None, grad_table=None):
    """csrc/hash_encode.cu on the current stream: the forward into ``out``
    when ``grad_out`` is None, else the table's gradient into ``grad_table``;
    counted in ``hash_encode.kernel`` / ``hash_encode.kernel_bwd``."""
    res = constant(cfg.resolutions(), torch.float32, pos.device)
    ptr = [0 if t is None else t.data_ptr() for t in (table, out, grad_out, grad_table)]
    stream = torch.cuda.current_stream(pos.device).cuda_stream
    err = kernels.load("hash_encode").hash_encode(
        ptr[0], pos.data_ptr(), res.data_ptr(), ptr[1], ptr[2], ptr[3], *args, stream)
    if err != 0:
        raise RuntimeError(f"hash_encode kernel launch failed: CUDA error {err}")
    if grad_out is None:
        hash_encode.kernel += 1
    else:
        hash_encode.kernel_bwd += 1


class _HashEncode(torch.autograd.Function):
    """The kernel pair as one differentiable op of the table [L, T, W]."""

    @staticmethod
    def forward(ctx, table, pos, cfg, args):
        out = torch.empty((pos.shape[0], cfg.out_dim), dtype=torch.float32, device=pos.device)
        _launch(cfg, args, pos, table=table, out=out)
        ctx.save_for_backward(pos)
        ctx.cfg, ctx.args, ctx.table_shape = cfg, args, table.shape
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        (pos,) = ctx.saved_tensors
        grad_table = torch.empty(ctx.table_shape, dtype=torch.float32, device=pos.device)
        _launch(ctx.cfg, ctx.args, pos, grad_out=grad_out.contiguous(), grad_table=grad_table)
        return grad_table, None, None, None


def hash_encode(
    table: torch.Tensor, positions: torch.Tensor, cfg: HashGridConfig
) -> torch.Tensor:
    """Encode positions in [0, 1]^3 -> [N, num_levels * features] float32:
    trilinear interpolation of the 8 corner features at every level.  On
    CUDA the kernel computes it, and its backward gives the table's
    gradient; a CUDA call it is not built for raises NotImplementedError."""
    if not positions.is_cuda:
        hash_encode.eager += 1
        return hash_encode_plain(table, positions, cfg)
    p = positions.reshape(-1, 3)
    args = launch_args(p.shape[0], cfg)
    table3 = table.reshape(cfg.num_levels, cfg.table_size, cfg.row_width).contiguous()
    why = refusal(table3, positions)
    if why is not None:
        raise NotImplementedError(f"hash_encode's CUDA kernel is not built for {why}")
    out = _HashEncode.apply(table3, p.contiguous(), cfg, args)
    return out.reshape(positions.shape[:-1] + (cfg.out_dim,))


# Kernel launches (forward, backward) and plain calls since import.
hash_encode.kernel = hash_encode.kernel_bwd = hash_encode.eager = 0


def normalize_positions(
    xyz: torch.Tensor, aabb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """AABB-normalize to [0,1]^3; positions outside the box become 0."""
    pos = (xyz - aabb[0]) / (aabb[1] - aabb[0])
    selector = torch.all((pos > 0.0) & (pos < 1.0), dim=-1)
    return pos * selector[..., None], selector
