"""Count-bounded per-tile composite over gathered tile lists: the CUDA
kernel's wrapper (port of ``soar_tpu.render.pallas_composite``).

:func:`composite_tiles` has the signature, defaults and outputs of the JAX
``composite_tiles_pallas``.  CUDA tensors launch
``csrc/composite_tiles.cu`` — there is no fallback; CPU tensors go to the
plain PyTorch version
(:func:`soar_tpu_torch.render.composite.composite_tiles_plain`).  Like the
JAX kernel it is forward only (``composite_tiles_pallas`` has no VJP): the
outputs carry no autograd graph on either device.  As in the JAX package no
renderer path calls it — the renders go through
:func:`soar_tpu_torch.render.block_composite.composite_block` — and it is
kept as the per-tile walk over a tile's actual splat list, held equal to the
dense composite.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .composite import composite_tiles_plain

MAX_PIXELS = 256  # one thread per pixel: tiles up to 16x16
_RECORD_FLOATS = 20  # the kernel's per-slot record in shared memory
_SMEM_LIMIT = 48 * 1024  # static-launch shared memory per block


def composite_tiles(
    xy: torch.Tensor,  # [NT, K, 2]
    conic: torch.Tensor,  # [NT, K, 3]
    opac: torch.Tensor,  # [NT, K]
    colors: torch.Tensor,  # [NT, K, 3]
    normals: torch.Tensor,  # [NT, K, 3]
    depths: torch.Tensor,  # [NT, K]
    jinv: torch.Tensor,  # [NT, K, 10]
    slot_valid: torch.Tensor,  # [NT, K] bool
    counts: torch.Tensor,  # [NT] int
    tile_origins: torch.Tensor,  # [NT, 2] int (x, y) pixel origins
    tile: int = 16,
    alpha_clamp: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    t_min: float = 1e-4,
    perpix_depth: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(color [NT, P, 3], normal [NT, P, 3], depth [NT, P],
    T [NT, P])``, P = tile*tile, without an autograd graph; background
    compositing and depth normalisation stay with the caller."""
    args = (xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
            tile_origins)
    consts = (tile, alpha_clamp, alpha_min, t_min, perpix_depth)
    with torch.no_grad():
        if xy.device.type == "cpu":
            return composite_tiles_plain(*args, *consts)
        return _launch(*args, *consts)


def _launch(xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
            tile_origins, tile, alpha_clamp, alpha_min, t_min, perpix_depth):
    dev = xy.device
    tensors = (xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
               tile_origins)
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "composite_tiles takes CPU or CUDA tensors on one device, got "
            f"{sorted({str(t.device) for t in tensors})}"
        )
    NT, K = xy.shape[:2]
    P = tile * tile
    floats = {"xy": (xy, (NT, K, 2)), "conic": (conic, (NT, K, 3)), "opac": (opac, (NT, K)),
              "colors": (colors, (NT, K, 3)), "normals": (normals, (NT, K, 3)),
              "depths": (depths, (NT, K)), "jinv": (jinv, (NT, K, 10))}
    for name, (t, shape) in floats.items():
        if t.dtype != torch.float32:
            raise TypeError(f"composite_tiles: {name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"composite_tiles: {name} has shape {tuple(t.shape)}, want {shape}")
    if slot_valid.dtype != torch.bool or tuple(slot_valid.shape) != (NT, K):
        raise ValueError("composite_tiles: slot_valid must be bool [NT, K]")
    if counts.is_floating_point() or tuple(counts.shape) != (NT,):
        raise ValueError("composite_tiles: counts must be an integer [NT] tensor")
    if tile_origins.is_floating_point() or tuple(tile_origins.shape) != (NT, 2):
        raise ValueError("composite_tiles: tile_origins must be an integer [NT, 2] tensor")
    if not (1 <= P <= MAX_PIXELS):
        raise ValueError(f"the kernel takes tiles of 1..{MAX_PIXELS} pixels, got {tile}x{tile}")
    if K < 1 or K * _RECORD_FLOATS * 4 > _SMEM_LIMIT:
        raise ValueError(f"K={K} slots x {_RECORD_FLOATS} floats exceed the kernel's "
                         f"{_SMEM_LIMIT} B of shared memory")

    ins = [t.contiguous() for t, _ in floats.values()]
    valid_u8 = slot_valid.contiguous().view(torch.uint8)
    # Counts above K are clipped by the kernel; the clamp keeps an int64
    # count inside int32.
    counts_i32 = counts.clamp(0, K).to(torch.int32).contiguous()
    origins_i32 = tile_origins.to(torch.int32).contiguous()
    color = torch.empty((NT, P, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((NT, P, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((NT, P), dtype=torch.float32, device=dev)
    T = torch.empty((NT, P), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.load("composite_tiles").composite_tiles(
        *(t.data_ptr() for t in ins), valid_u8.data_ptr(), counts_i32.data_ptr(),
        origins_i32.data_ptr(), color.data_ptr(), normal.data_ptr(), depth.data_ptr(),
        T.data_ptr(), NT, K, tile, int(bool(perpix_depth)),
        float(alpha_clamp), float(alpha_min), float(t_min), stream,
    )
    if err != 0:
        raise RuntimeError(f"composite_tiles kernel launch failed: CUDA error {err}")
    composite_tiles.launches += 1
    return color, normal, depth, T


# Kernel launches since the last reset; chip_smoke.py reads it to show its
# tile-list path went through the kernel.
composite_tiles.launches = 0
