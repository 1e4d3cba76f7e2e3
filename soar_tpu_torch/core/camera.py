"""Cameras and projection math (port of ``soar_tpu.core.camera``).

Column-vector convention: ``p_cam = w2c @ [p_world, 1]``,
``p_clip = full_proj @ [p_world, 1]``.  The reference's camera chain is
reproduced exactly: the dataset's w2c row flip, ``convert_pose``'s y/z
column flip of c2w, the projection with principal point, and ``ndc2pix``
with its principal-point shift.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from .constants import constant


class Camera(NamedTuple):
    """Per-view camera tensors; image size travels separately as
    ``image_size=(H, W)``."""

    fovx: torch.Tensor  # [] radians
    fovy: torch.Tensor  # [] radians
    w2c: torch.Tensor  # [4, 4]
    full_proj: torch.Tensor  # [4, 4]
    campos: torch.Tensor  # [3]
    prcppoint: torch.Tensor  # [2] principal point as a fraction of (W, H)


def convert_pose(c2w: torch.Tensor) -> torch.Tensor:
    """Flip the y and z camera axes: ``C2W @ diag(1,-1,-1,1)``."""
    flip = constant((1.0, -1.0, -1.0, 1.0), c2w.dtype, c2w.device)
    return c2w * flip[None, :]


def projection_matrix(
    znear: float,
    zfar: float,
    fovx: torch.Tensor,
    fovy: torch.Tensor,
    cxcy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    img_wh: Optional[Tuple[int, int]] = None,
    z_sign: float = 1.0,
) -> torch.Tensor:
    """Perspective projection with optional principal point; P[2,2] is the
    reference's ``z_sign*(zfar+znear)/(zfar-znear)``."""
    fovx = torch.as_tensor(fovx, dtype=torch.float32)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=fovx.device)
    tan_half_fovy = torch.tan(fovy / 2.0)
    tan_half_fovx = torch.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear

    zero = torch.zeros((), dtype=torch.float32, device=fovx.device)
    if cxcy is not None and img_wh is not None:
        cx, cy = cxcy
        w, h = img_wh
        f32 = dict(dtype=torch.float32, device=fovx.device)
        p02 = (2.0 * torch.as_tensor(cx, **f32) - w) / w + zero
        p12 = (2.0 * torch.as_tensor(cy, **f32) - h) / h + zero
    else:
        p02 = zero
        p12 = zero

    return torch.stack(
        [
            torch.stack([znear / right, zero, p02, zero]),
            torch.stack([zero, znear / top, p12, zero]),
            torch.stack(
                [
                    zero,
                    zero,
                    zero + z_sign * (zfar + znear) / (zfar - znear),
                    zero - (zfar * znear) / (zfar - znear),
                ]
            ),
            torch.stack([zero, zero, zero + z_sign, zero]),
        ]
    )


def camera_from_c2w(
    c2w: torch.Tensor,
    fovx,
    fovy,
    znear: float = 0.1,
    zfar: float = 100.0,
    cxcy: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    img_wh: Optional[Tuple[int, int]] = None,
    prcppoint: Optional[torch.Tensor] = None,
) -> Camera:
    """``get_cam_info_gaussian_cxcy``: convert_pose, invert, compose with the
    projection.  ``c2w``'s device is the camera's device."""
    dev = c2w.device
    c2w_cv = convert_pose(c2w)
    R = c2w_cv[:3, :3]
    t = c2w_cv[:3, 3]
    w2c = torch.eye(4, dtype=c2w.dtype, device=dev)
    w2c[:3, :3] = R.T
    w2c[:3, 3] = -R.T @ t
    fovx = torch.as_tensor(fovx, dtype=torch.float32, device=dev)
    fovy = torch.as_tensor(fovy, dtype=torch.float32, device=dev)
    P = projection_matrix(znear, zfar, fovx, fovy, cxcy=cxcy, img_wh=img_wh)
    full_proj = P @ w2c
    if prcppoint is None:
        prcppoint = constant((0.5, 0.5), c2w.dtype, dev)
    return Camera(
        fovx=fovx,
        fovy=fovy,
        w2c=w2c,
        full_proj=full_proj,
        campos=t,
        prcppoint=torch.as_tensor(prcppoint, device=dev),
    )


def focal_from_fov(fov, pixels):
    """``fov2focal``."""
    if isinstance(fov, torch.Tensor):
        return pixels / (2.0 * torch.tan(fov / 2.0))
    return pixels / (2.0 * math.tan(fov / 2.0))


def ndc2pix(v: torch.Tensor, size, prcp) -> torch.Tensor:
    """``cuda_rasterizer/auxiliary.h:42-46``."""
    return ((v + 1.0) * size - 1.0) * 0.5 + size * (prcp - 0.5)


def get_ray_directions(H: int, W: int, focal, principal=None) -> torch.Tensor:
    """Per-pixel ray directions [H, W, 3] in the OpenGL camera frame (x
    right, y up, looking down -z), pixel centres at +0.5:
    ``((i - cx) / fx, -(j - cy) / fy, -1)``.  ``focal`` is ``(fx, fy)``,
    floats or 0-d tensors; the result lives on their device."""
    fx, fy = (torch.as_tensor(f, dtype=torch.float32) for f in focal)
    dev = fx.device
    if principal is None:
        cx, cy = W / 2.0, H / 2.0
    else:
        cx, cy = principal
    i = torch.arange(W, dtype=torch.float32, device=dev) + 0.5
    j = torch.arange(H, dtype=torch.float32, device=dev) + 0.5
    jj, ii = torch.meshgrid(j, i, indexing="ij")
    return torch.stack([(ii - cx) / fx, -(jj - cy) / fy, -torch.ones_like(ii)], dim=-1)


def get_rays(directions: torch.Tensor, c2w: torch.Tensor, normalize: bool = True):
    """Rotate camera-frame directions [H, W, 3] into world space with c2w
    [..., 4, 4]; returns ``(rays_o, rays_d)``, each [..., H, W, 3]."""
    rays_d = torch.einsum("...ij,hwj->...hwi", c2w[..., :3, :3], directions)
    if normalize:
        rays_d = rays_d / torch.clamp_min(torch.linalg.norm(rays_d, dim=-1, keepdim=True), 1e-12)
    rays_o = c2w[..., None, None, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def look_at_c2w(camera_position: torch.Tensor, center: torch.Tensor,
                up: torch.Tensor) -> torch.Tensor:
    """OpenGL-style c2w [..., 4, 4]: columns (right, up, -lookat | position)."""

    def unit(v):
        return v / torch.clamp_min(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)

    lookat = unit(center - camera_position)
    right = unit(torch.linalg.cross(lookat, up, dim=-1))
    up2 = unit(torch.linalg.cross(right, lookat, dim=-1))
    R = torch.stack([right, up2, -lookat], dim=-1)
    c2w = torch.cat([R, camera_position[..., :, None]], dim=-1)
    bottom = constant((0.0, 0.0, 0.0, 1.0), c2w.dtype, c2w.device)
    return torch.cat([c2w, bottom.expand(c2w.shape[:-2] + (1, 4))], dim=-2)
