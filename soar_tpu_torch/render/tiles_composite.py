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

The kernel reads its inputs as they come (:func:`launch_args`): each float
list through its own tile and slot strides, ``counts`` and ``tile_origins``
as int32 or int64, ``slot_valid`` as bytes.  The column views that
:func:`soar_tpu_torch.render.tiled.gather_tile_lists` returns are handed over
without a copy, so a call on them is one device op.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from .. import kernels
from .block_composite import SMEM_OPTIN
from .composite import composite_tiles_plain

MAX_PIXELS = 256  # tiles up to 16x16
_RECORD_FLOATS = 20  # the kernel's per-slot record in shared memory
_GROUP = 8  # slots the kernel evaluates together (kGroup)

# The float lists in the kernel's argument order, with their last
# dimension (None: an [NT, K] list).
_FLOAT_LISTS = (("xy", 2), ("conic", 3), ("opac", None), ("colors", 3),
                ("normals", 3), ("depths", None), ("jinv", 10))


def tiles_smem_bytes(K: int) -> int:
    """Shared memory composite_tiles.cu asks for: one 20-float record a
    slot, K rounded up to whole groups of slots, dynamic, up to
    ``SMEM_OPTIN``."""
    return 4 * _RECORD_FLOATS * (-(-K // _GROUP) * _GROUP)


class LaunchArgs(NamedTuple):
    """What :func:`_launch` hands the kernel.  ``tensors`` are the ten
    inputs as the kernel reads them — each the caller's own tensor, or a
    copy where ``copied`` names it (``slot_valid`` as a uint8 view) — and
    ``pointers`` their addresses; ``strides`` the (tile, slot) strides in
    elements of the seven float lists, in their argument order."""

    tensors: Tuple[torch.Tensor, ...]
    pointers: Tuple[int, ...]
    strides: Tuple[int, ...]
    copied: Tuple[str, ...]
    counts_i64: bool
    origins_i64: bool
    NT: int
    K: int
    P: int


def launch_args(xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
                tile_origins, tile: int = 16) -> LaunchArgs:
    """Checks devices, types, shapes and the shared-memory footprint, and
    takes each input as the kernel can read it: a float list with any tile
    and slot strides, but unit stride over the last dimension of an
    [NT, K, W] list; ``counts`` [NT] and ``tile_origins`` [NT, 2] contiguous
    int32 or int64; ``slot_valid`` contiguous bool.  Only an input that is
    not so is copied (another integer type goes to int32).  Runs on any
    device and launches nothing.  It runs on every call, so each check is
    one attribute read (a call's host time is most of its time on the
    renderer's real tile lists)."""
    floats = (xy, conic, opac, colors, normals, depths, jinv)
    everything = (*floats, slot_valid, counts, tile_origins)
    dev = xy.get_device()  # -1 on the CPU; comparing torch.device objects costs 2 us
    if any(t.get_device() != dev for t in everything):
        raise ValueError(
            "composite_tiles takes CPU or CUDA tensors on one device, got "
            f"{sorted({str(t.device) for t in everything})}"
        )
    if xy.dim() != 3:
        raise ValueError(f"composite_tiles: xy has shape {tuple(xy.shape)}, want [NT, K, 2]")
    NT, K, _ = xy.shape
    P = tile * tile
    copied = []
    ins, strides = [], []
    for t, (name, W) in zip(floats, _FLOAT_LISTS):
        shape = (NT, K) if W is None else (NT, K, W)
        if t.dtype != torch.float32:
            raise TypeError(f"composite_tiles: {name} must be float32, got {t.dtype}")
        if t.shape != shape:
            raise ValueError(f"composite_tiles: {name} has shape {tuple(t.shape)}, want {shape}")
        st = t.stride()
        if W is not None and st[2] != 1:
            t = t.contiguous()
            st = t.stride()
            copied.append(name)
        ins.append(t)
        strides += st[:2]
    if slot_valid.dtype != torch.bool or slot_valid.shape != (NT, K):
        raise ValueError("composite_tiles: slot_valid must be bool [NT, K]")
    if not slot_valid.is_contiguous():
        slot_valid = slot_valid.contiguous()
        copied.append("slot_valid")
    ints = []
    for t, name, shape in ((counts, "counts", (NT,)), (tile_origins, "tile_origins", (NT, 2))):
        if t.is_floating_point() or t.is_complex() or t.shape != shape:
            raise ValueError(f"composite_tiles: {name} must be an integer {list(shape)} tensor")
        if t.dtype not in (torch.int32, torch.int64) or not t.is_contiguous():
            t = t.to(torch.int32 if t.dtype != torch.int64 else t.dtype).contiguous()
            copied.append(name)
        ints.append(t)
    if not (1 <= P <= MAX_PIXELS):
        raise ValueError(f"the kernel takes tiles of 1..{MAX_PIXELS} pixels, got {tile}x{tile}")
    need = tiles_smem_bytes(K)
    if K < 1 or need > SMEM_OPTIN:
        raise ValueError(f"composite_tiles: K={K} slots need {need} B of shared memory, "
                         f"over the {SMEM_OPTIN} B a block may have")
    tensors = (*ins, slot_valid.view(torch.uint8), *ints)
    return LaunchArgs(tensors, tuple(t.data_ptr() for t in tensors), tuple(strides),
                      tuple(copied), ints[0].dtype == torch.int64,
                      ints[1].dtype == torch.int64, NT, K, P)


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
    if xy.device.type == "cpu":
        with torch.no_grad():
            return composite_tiles_plain(*args, *consts)
    return _launch(*args, *consts)  # fresh outputs: no autograd graph either


def _launch(xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
            tile_origins, tile, alpha_clamp, alpha_min, t_min, perpix_depth):
    a = launch_args(xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
                    tile_origins, tile)
    dev = xy.device
    if dev.type != "cuda":
        raise ValueError(f"composite_tiles takes CPU or CUDA tensors, got {dev}")
    NT, P = a.NT, a.P
    color = torch.empty((NT, P, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((NT, P, 3), dtype=torch.float32, device=dev)
    depth = torch.empty((NT, P), dtype=torch.float32, device=dev)
    T = torch.empty((NT, P), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kernels.load("composite_tiles").composite_tiles(
        *a.pointers, color.data_ptr(), normal.data_ptr(), depth.data_ptr(), T.data_ptr(),
        (ctypes.c_int64 * len(a.strides))(*a.strides), NT, a.K, tile,
        int(bool(perpix_depth)), int(a.counts_i64), int(a.origins_i64),
        float(alpha_clamp), float(alpha_min), float(t_min), stream,
    )
    if err != 0:
        raise RuntimeError(f"composite_tiles kernel launch failed: CUDA error {err}")
    composite_tiles.launches += 1
    return color, normal, depth, T


# Kernel launches since the last reset; chip_smoke.py reads it to show its
# tile-list path went through the kernel.
composite_tiles.launches = 0
