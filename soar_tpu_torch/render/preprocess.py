"""Per-surfel screen-space preprocessing (port of
``soar_tpu.render.preprocess``): projection, frustum / back-face / grazing
culling as a validity mask, view-space normals, EWA 3D->2D covariance with
the 0.3 low-pass, screen radius, and the per-pixel-depth local homography
``jinv`` (``cuda_rasterizer/forward.cu:204-385``, ``auxiliary.h:291-397``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core import spans
from ..core.camera import Camera, focal_from_fov, ndc2pix
from ..core.transforms import quat_to_rotmat
from .types import GaussianInputs, Preprocessed, RasterConfig


def _ewa_cov2d(
    p_view: torch.Tensor,  # [N, 3]
    cov3d: torch.Tensor,  # [N, 3, 3]
    w_rot: torch.Tensor,  # [3, 3]
    focal: Tuple[torch.Tensor, torch.Tensor],
    tan_fov: Tuple[torch.Tensor, torch.Tensor],
    low_pass: float,
) -> torch.Tensor:
    """cov2d = J W Σ Wᵀ Jᵀ + low_pass·I at the fov-clamped view point,
    returned as (a, b, c) packing [[a, b], [b, c]]."""
    fx, fy = focal
    tanx, tany = tan_fov
    tz = p_view[:, 2]
    tx = torch.clamp(p_view[:, 0] / tz, -1.3 * tanx, 1.3 * tanx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -1.3 * tany, 1.3 * tany) * tz

    zero = torch.zeros_like(tz)
    J = torch.stack(
        [
            torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], dim=-1),
            torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], dim=-1),
        ],
        dim=-2,
    )  # [N, 2, 3]
    JW = J @ w_rot
    cov = JW @ cov3d @ JW.transpose(-1, -2)  # [N, 2, 2]
    a = cov[:, 0, 0] + low_pass
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + low_pass
    return torch.stack([a, b, c], dim=-1)


def _local_homo(
    p_view: torch.Tensor,
    n_view: torch.Tensor,
    ax0_view: torch.Tensor,
    ax1_view: torch.Tensor,
    fx: torch.Tensor,
    fy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse local homography between the screen plane and the surfel's
    tangent plane.  Returns (jinv [N, 10], grazing [N] bool): jinv[:4] is
    the 2x2 screen->tangent Jacobian scaled by S_fix/Svp, jinv[4:7] = u0,
    jinv[7:10] = u1."""
    s_fix = 1000.0
    svp = (fx + fy) / 2.0

    px = p_view[:, 0] / p_view[:, 2]
    py = p_view[:, 1] / p_view[:, 2]
    ones = torch.ones_like(px)

    def norm3(v):
        mod = torch.clamp_min(torch.linalg.norm(v, dim=-1), 1e-8)
        return v / mod[:, None], mod

    dir_x0, mod_x0 = norm3(torch.stack([px + 1.0 / s_fix, py, ones], dim=-1))
    dir_x1, mod_x1 = norm3(torch.stack([px, py + 1.0 / s_fix, ones], dim=-1))

    prj_x0 = torch.sum(dir_x0 * n_view, dim=-1)
    prj_x1 = torch.sum(dir_x1 * n_view, dim=-1)
    # Grazing cull (threshold 0.01); the reference divides the normalized
    # dot by the direction norm again — replicated.
    grazing = (torch.abs(prj_x0 / mod_x0) < 0.01) | (torch.abs(prj_x1 / mod_x1) < 0.01)

    t_temp = torch.sum(p_view * n_view, dim=-1)

    def safe(x):
        return torch.where(torch.abs(x) < 1e-12, 1e-12, x)

    t_x0 = t_temp / safe(prj_x0)
    t_x1 = t_temp / safe(prj_x1)
    xu0 = dir_x0 * t_x0[:, None] - p_view
    xu1 = dir_x1 * t_x1[:, None] - p_view

    u0, u1 = ax0_view, ax1_view
    scale = svp / s_fix
    j00 = torch.sum(xu0 * u0, dim=-1) / scale
    j01 = torch.sum(xu1 * u0, dim=-1) / scale
    j10 = torch.sum(xu0 * u1, dim=-1) / scale
    j11 = torch.sum(xu1 * u1, dim=-1) / scale

    jinv = torch.cat([torch.stack([j00, j01, j10, j11], dim=-1), u0, u1], dim=-1)
    return jinv, grazing


@spans.spanned("soar.raster.preprocess")
def preprocess(
    g: GaussianInputs,
    camera: Camera,
    image_size: Tuple[int, int],
    cfg: RasterConfig,
) -> Preprocessed:
    H, W = image_size
    fx = focal_from_fov(camera.fovx, W)
    fy = focal_from_fov(camera.fovy, H)
    tanx = torch.tan(camera.fovx * 0.5)
    tany = torch.tan(camera.fovy * 0.5)

    N = g.means3d.shape[0]
    ones = torch.ones_like(g.means3d[:, :1])
    p_h = torch.cat([g.means3d, ones], dim=-1)  # [N, 4]

    p_hom = p_h @ camera.full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    p_view = (p_h @ camera.w2c.T)[:, :3]

    x_pix = ndc2pix(p_proj[:, 0], W, camera.prcppoint[0])
    y_pix = ndc2pix(p_proj[:, 1], H, camera.prcppoint[1])
    xy = torch.stack([x_pix, y_pix], dim=-1)

    # Frustum test with a 20% border; z >= cfg.near (see RasterConfig).
    ex, ey = 0.2 * W, 0.2 * H
    valid = (
        (p_view[:, 2] >= cfg.near)
        & (x_pix >= -ex)
        & (x_pix < W + ex)
        & (y_pix >= -ey)
        & (y_pix < H + ey)
    )

    R = quat_to_rotmat(g.quats)  # [N, 3, 3], columns are local axes
    w_rot = camera.w2c[:3, :3]
    # A splat in front of the near plane is culled, but the footprint and
    # local homography below divide by its depth: at z = 0 they are NaN, and
    # the zero cotangent it gets times that NaN makes NaN gradients on the
    # parameters it shares with every other splat (the field).  Those terms
    # take its depth clamped to the near plane; a kept splat's values are
    # unchanged, and a culled splat's are never read.  (The JAX package has
    # the NaN: ROADMAP.md, Queue 3.)
    z = p_view[:, 2]
    p_safe = torch.cat([p_view[:, :2], torch.where(z >= cfg.near, z, cfg.near)[:, None]], -1)

    zeros10 = torch.zeros((N, 10), dtype=g.means3d.dtype, device=g.means3d.device)
    if cfg.surface:
        n_view = R[..., :, 2] @ w_rot.T
        ax0_view = R[..., :, 0] @ w_rot.T
        ax1_view = R[..., :, 1] @ w_rot.T
        view_dot = torch.sum(p_view * n_view, dim=-1)
        if cfg.render_front:
            valid = valid & (view_dot <= -0.01)
        if cfg.perpix_depth:
            jinv, grazing = _local_homo(p_safe, n_view, ax0_view, ax1_view, fx, fy)
            valid = valid & ~grazing
        else:
            jinv = zeros10
    else:
        n_view = torch.zeros_like(g.means3d)
        view_dot = torch.full((N,), -1.0, dtype=g.means3d.dtype, device=g.means3d.device)
        jinv = zeros10

    # Σ = R S² Rᵀ with the z-scale zeroed for flat surfels.
    s = g.scales * cfg.scale_modifier
    if cfg.surface:
        s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], dim=-1)
    RS = R * s[:, None, :]
    cov3d = RS @ RS.transpose(-1, -2)

    cov = _ewa_cov2d(p_safe, cov3d, w_rot, (fx, fy), (tanx, tany), cfg.low_pass)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    valid = valid & (det != 0.0)
    det_inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    conic = torch.stack(
        [cov[:, 2] * det_inv, -cov[:, 1] * det_inv, cov[:, 0] * det_inv], dim=-1
    )

    mid = 0.5 * (cov[:, 0] + cov[:, 2])
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))
    valid = valid & (radius > 0.0)

    return Preprocessed(
        valid=valid,
        xy=xy,
        depth=p_view[:, 2],
        conic=conic,
        radius=radius,
        normal_view=n_view,
        view_dot=view_dot,
        jinv=jinv,
        colors=g.colors,
        opacities=g.opacities,
    )
