"""Image-space post ops on rendered maps, channel-last (port of
``soar_tpu.render.postprocess``): ``depth2normal`` and ``normal2curv``."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as Fn

from ..core.camera import Camera, focal_from_fov
from ..core.transforms import safe_normalize


def _pad_edge(x: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [H+2, W+2, C], edge-replicated."""
    return Fn.pad(x.permute(2, 0, 1)[None], (1, 1, 1, 1), mode="replicate")[0].permute(1, 2, 0)


def _cross_sum_neighbors(p: torch.Tensor, mask: torch.Tensor):
    """Shared 4-neighborhood machinery for both post ops."""
    pc = p[1:-1, 1:-1] * mask[1:-1, 1:-1]
    up = (p[:-2, 1:-1] - pc) * mask[:-2, 1:-1]
    left = (p[1:-1, :-2] - pc) * mask[1:-1, :-2]
    down = (p[2:, 1:-1] - pc) * mask[2:, 1:-1]
    right = (p[1:-1, 2:] - pc) * mask[1:-1, 2:]
    return up, left, down, right


def depth2normal(
    depth: torch.Tensor,  # [H, W]
    mask: torch.Tensor,  # [H, W] bool
    camera: Camera,
    image_size: Tuple[int, int],
) -> torch.Tensor:
    """Normals from the rendered depth by cross products of backprojected
    neighbor differences (conventional fx/fy pairing, as the JAX package)."""
    H, W = image_size
    fx = focal_from_fov(camera.fovx, W)
    fy = focal_from_fov(camera.fovy, H)
    ys = torch.arange(H, dtype=torch.float32, device=depth.device)
    xs = torch.arange(W, dtype=torch.float32, device=depth.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    x = (px - camera.prcppoint[0] * W) * depth / fx
    y = (py - camera.prcppoint[1] * H) * depth / fy
    cam_pos = torch.stack([x, y, depth], dim=-1)  # [H, W, 3]

    p = _pad_edge(cam_pos)
    m = _pad_edge(mask[..., None].to(torch.float32)) > 0.5

    up, left, down, right = _cross_sum_neighbors(p, m.to(cam_pos.dtype))
    cross = torch.linalg.cross
    n = cross(up, left) + cross(right, up) + cross(down, right) + cross(left, down)
    n = safe_normalize(n)
    return n * mask[..., None]


def normal2curv(normal: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Curvature proxy: L1 norm of the 4-neighborhood normal Laplacian.
    normal [H, W, 3], mask [H, W] -> [H, W]."""
    n = _pad_edge(normal)
    m = _pad_edge(mask[..., None].to(torch.float32))
    up, left, down, right = _cross_sum_neighbors(n, m)
    curv = (up + left + down + right) * mask[..., None]
    return torch.sum(torch.abs(curv), dim=-1)
