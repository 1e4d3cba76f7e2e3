"""Rasterizer input/output/config types (port of ``soar_tpu.render.types``)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class GaussianInputs(NamedTuple):
    """Per-surfel rasterizer inputs (world space, post-LBS)."""

    means3d: torch.Tensor  # [N, 3]
    quats: torch.Tensor  # [N, 4] wxyz, normalized
    scales: torch.Tensor  # [N, 3] world-space scales (z ignored when surface)
    opacities: torch.Tensor  # [N] in [0, 1]
    colors: torch.Tensor  # [N, C]


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterization switches; every default equals
    ``soar_tpu.render.types.RasterConfig``'s.

    ``composite`` picks the per-tile composite: ``"kernel"`` (default) goes
    through :func:`soar_tpu_torch.render.block_composite.composite_block`,
    which launches the CUDA kernel for CUDA tensors and runs the plain
    PyTorch version for CPU tensors; ``"plain"`` forces the plain version on
    any device (it exists so the kernel can be held against it on the card).

    ``composite_dtype="bf16"`` is the JAX package's bf16 XLA chain and acts
    under ``composite="plain"`` only (:func:`soar_tpu_torch.render.composite.
    composite_block_plain`).  Under ``composite="kernel"`` nothing reads it:
    the kernels composite in f32, as the JAX package's Pallas kernels do
    whatever ``composite_dtype`` says, and a CPU tensor's stand-in for the
    kernel is the f32 plain version.
    """

    surface: bool = True
    normalize_depth: bool = True
    perpix_depth: bool = True
    render_front: bool = False
    sort_descending: bool = False
    near: float = 0.1
    compose_reverse: bool = False
    tile: int = 16
    max_per_tile: int = 96
    dup_side: int = 5
    dup_side_small: int = 2
    fat_budget: int = 8192
    composite: str = "kernel"
    composite_dtype: str = "f32"
    pallas_block: int = 1
    scale_modifier: float = 1.0
    low_pass: float = 0.3
    alpha_clamp: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_min: float = 1e-4

    def __post_init__(self):
        if self.composite not in ("kernel", "plain"):
            raise ValueError(
                f"composite must be 'kernel' or 'plain', got {self.composite!r}"
            )
        if self.composite_dtype not in ("f32", "bf16"):
            raise ValueError(
                f"composite_dtype must be 'f32' or 'bf16', got {self.composite_dtype!r}"
            )


class Preprocessed(NamedTuple):
    """Per-surfel screen-space quantities produced by the shared preprocess."""

    valid: torch.Tensor  # [N] bool: survives culling
    xy: torch.Tensor  # [N, 2] pixel coords of the mean
    depth: torch.Tensor  # [N] view-space z
    conic: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor  # [N] screen radius in pixels
    normal_view: torch.Tensor  # [N, 3] view-space normal
    view_dot: torch.Tensor  # [N] dot(p_view, n_view); front iff <= -0.01
    jinv: torch.Tensor  # [N, 10] local homography
    colors: torch.Tensor  # [N, C]
    opacities: torch.Tensor  # [N]


class RenderOutputs(NamedTuple):
    color: torch.Tensor  # [H, W, C]  (C + T * bg)
    normal: torch.Tensor  # [H, W, 3] view-space accumulated normal
    depth: torch.Tensor  # [H, W]
    opac: torch.Tensor  # [H, W] alpha = 1 - T
    transmittance: torch.Tensor  # [H, W] final T (clamped)
    # [2] int32 capacity canaries: (splats dropped by max_per_tile,
    # surfels whose tile footprint exceeded their slot grid).
    overflow: Optional[torch.Tensor] = None
    # [N] bool per-surfel culling survival; main pass only.
    visible: Optional[torch.Tensor] = None
