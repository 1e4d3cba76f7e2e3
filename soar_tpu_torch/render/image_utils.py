"""Multi-camera visibility, pruning helpers and occupancy-grid splatting
(port of ``soar_tpu.render.image_utils``).

- ``contour_padding``: mask dilation as a max-pool;
- ``world2scrn``, ``mask_prune``, ``grid_prune``, ``depth2wpos``,
  ``reproject_depth``: camera projections and masks;
- ``gaussian_to_occgrid``: surfel opacity scattered into voxels with
  ``index_add_`` (the JAX package's ``segment_sum``).

A batched :class:`~soar_tpu_torch.core.camera.Camera` carries a leading
camera axis on every field.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.camera import Camera, focal_from_fov, ndc2pix


def contour_padding(mask: torch.Tensor, pad: int) -> torch.Tensor:
    """Dilate a [H, W] (or [H, W, 1]) mask by ``pad`` pixels (max-pool);
    returns a bool mask of the same shape."""
    if pad <= 0:
        return mask
    squeeze = mask.ndim == 2
    m = mask if squeeze else mask[..., 0]
    out = F.max_pool2d(m.float()[None, None], 2 * pad + 1, stride=1, padding=pad)[0, 0] > 0
    return out if squeeze else out[..., None]


def world2scrn(
    xyz: torch.Tensor,  # [N, 3]
    cams: Camera,  # batched: leading axis = #cams
    masks: Optional[torch.Tensor],  # [C, H, W] or None (all visible)
    image_size: Tuple[int, int],
    pad: int = 0,
    znear: float = 0.1,
    zfar: float = 100.0,
):
    """Project points into every camera.  Returns (cam_pos [C, N, 3],
    ndc [C, N, 2], in_mask [C, N] bool, out_view [C, N] bool)."""
    H, W = image_size
    xh = torch.cat([xyz, torch.ones_like(xyz[:, :1])], -1)  # [N, 4]
    cam_pos = torch.einsum("cij,nj->cni", cams.w2c, xh)[..., :3]
    out_z = (cam_pos[..., 2] <= znear) | (cam_pos[..., 2] > zfar)

    proj = torch.einsum("cij,nj->cni", cams.full_proj, xh)
    ndc3 = proj[..., :3] / (proj[..., 3:] + 1e-7)
    out_xy = ((ndc3[..., 0] <= -1) | (ndc3[..., 0] > 1)
              | (ndc3[..., 1] <= -1) | (ndc3[..., 1] > 1))
    out_view = out_xy | out_z

    px = ndc2pix(ndc3[..., 0], W, cams.prcppoint[:, None, 0])
    py = ndc2pix(ndc3[..., 1], H, cams.prcppoint[:, None, 1])
    ndc = torch.stack([px / W * 2.0 - 1.0, py / H * 2.0 - 1.0], dim=-1)

    if masks is None:
        in_mask = torch.ones(out_view.shape, dtype=torch.bool, device=xyz.device)
    else:
        if pad > 0:
            masks = torch.stack([contour_padding(m > 0, pad) for m in masks])
        ix = torch.clamp(px, 0, W - 1).to(torch.int64)
        iy = torch.clamp(py, 0, H - 1).to(torch.int64)
        cam_idx = torch.arange(masks.shape[0], device=xyz.device)[:, None]
        in_mask = masks[cam_idx, iy, ix] > 0
    return cam_pos, ndc, in_mask, out_view


def mask_prune(
    pts: torch.Tensor,
    cams: Camera,
    masks: Optional[torch.Tensor],
    image_size: Tuple[int, int],
    pad: int = 4,
) -> torch.Tensor:
    """Keep points that are never visibly outside every camera mask."""
    _, _, in_mask, out_view = world2scrn(pts, cams, masks, image_size, pad)
    remove = torch.any(~(in_mask | out_view), dim=0)
    unseen = torch.all(out_view, dim=0)
    return ~(remove | unseen)


def gaussian_to_occgrid(
    xyz: torch.Tensor,  # [N, 3]
    opacity: torch.Tensor,  # [N]
    grid_dim: Tuple[int, int, int],
    shift: torch.Tensor,  # [3], added before scaling
    scale,  # scalar or [3]
    splat_radius: int = 1,
) -> torch.Tensor:
    """Occupancy grid: each surfel's opacity added into its voxel and the
    cube of ``splat_radius`` around it (``index_add_``)."""
    dev = xyz.device
    D = torch.tensor(grid_dim, device=dev)
    base = torch.floor((xyz + shift) * scale).to(torch.int64)  # [N, 3]
    offs = torch.arange(-splat_radius, splat_radius + 1, device=dev)
    ox, oy, oz = torch.meshgrid(offs, offs, offs, indexing="ij")
    cube = torch.stack([ox, oy, oz], -1).reshape(-1, 3)  # [K, 3]
    cells = base[:, None, :] + cube[None]  # [N, K, 3]
    ok = torch.all((cells >= 0) & (cells < D), dim=-1)
    flat = (cells[..., 0] * grid_dim[1] * grid_dim[2] + cells[..., 1] * grid_dim[2]
            + cells[..., 2])
    total = grid_dim[0] * grid_dim[1] * grid_dim[2]
    flat = torch.where(ok, flat, total)  # the dropped slot
    vals = opacity[:, None].expand(flat.shape).float()
    occ = torch.zeros(total + 1, device=dev).index_add_(0, flat.reshape(-1), vals.reshape(-1))
    return occ[:-1].reshape(grid_dim)


def grid_prune(
    grid: torch.Tensor,
    shift: torch.Tensor,
    scale,
    pts: torch.Tensor,
    thrsh: float = 1.0,
) -> torch.Tensor:
    """Keep points inside sufficiently occupied voxels."""
    D = torch.tensor(grid.shape, device=pts.device)
    cord = torch.floor((pts + shift) * scale).to(torch.int64)
    out = torch.any((cord <= 0) | (cord > D - 1), dim=-1)
    cord = torch.minimum(torch.clamp_min(cord, 0), D - 1)
    val = grid[cord[:, 0], cord[:, 1], cord[:, 2]]
    return (val > thrsh) & ~out


def depth2wpos(
    depth: torch.Tensor,  # [H, W]
    mask: torch.Tensor,  # [H, W]
    camera: Camera,
    image_size: Tuple[int, int],
) -> torch.Tensor:
    """Back-project a depth map to world positions [H, W, 3]."""
    H, W = image_size
    fx = focal_from_fov(camera.fovx, W)
    fy = focal_from_fov(camera.fovy, H)
    ys = torch.arange(H, dtype=torch.float32, device=depth.device)
    xs = torch.arange(W, dtype=torch.float32, device=depth.device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    x = (px - camera.prcppoint[0] * W) * depth / fx
    y = (py - camera.prcppoint[1] * H) * depth / fy
    cam_pos = torch.stack([x, y, depth], -1)
    R = camera.w2c[:3, :3]
    t = camera.w2c[:3, 3]
    wpos = (cam_pos - t) @ R  # R^T (p - t), row-vector form
    return wpos * mask[..., None]


def reproject_depth(
    depth: torch.Tensor,
    cam0: Camera,
    mask0: torch.Tensor,
    cams: Camera,
    image_size: Tuple[int, int],
):
    """NDC and visibility of cam0's back-projected depth in other cameras."""
    wpos = depth2wpos(depth, mask0, cam0, image_size).reshape(-1, 3)
    _, ndc, in_mask, out_view = world2scrn(wpos, cams, None, image_size)
    return ndc, in_mask & ~out_view
