"""Rotation / quaternion math (port of ``soar_tpu.core.transforms``).

Quaternions are ``wxyz`` (scalar first); rotation matrices are standard
(columns are the rotated basis vectors, so a surfel's normal is ``R[:, 2]``).
"""

from __future__ import annotations

import torch

from .constants import constant


def safe_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize with a gradient that is finite at x == 0."""
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + eps * eps)


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize quaternions along the last axis."""
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), eps)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion(s) -> 3x3 rotation matrix(es); does not normalize."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack(
        [
            1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y),
            2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x),
            2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y),
        ],
        dim=-1,
    )
    return R.reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix(es) -> wxyz quaternion(s), w >= 0.

    Branchless Shepperd: all four candidates, pick the one whose pivot is
    largest, normalize, canonicalize the sign."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    qw = torch.stack([1.0 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], -1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4(cand), 4(wxyz)]

    pivots = torch.stack(
        [1.0 + m00 + m11 + m22, 1.0 + m00 - m11 - m22,
         1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(pivots, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def batch_rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle vectors [..., 3] -> rotation matrices [..., 3, 3] (the smplx
    formulation: angle is the norm of the eps-shifted vector)."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)
    rot_dir = rot_vecs / angle
    cos = torch.cos(angle)[..., None]
    sin = torch.sin(angle)[..., None]
    rx, ry, rz = rot_dir[..., 0], rot_dir[..., 1], rot_dir[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(rot_vecs.shape[:-1] + (3, 3))
    ident = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return ident + sin * K + (1.0 - cos) * (K @ K)


def rotmat_to_rotvec(R: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Matrix -> axis-angle, exact at every angle including pi: through the
    best-conditioned of the four quaternion candidates, then
    ``2 * atan2(|v|, w)``."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    comp2 = torch.stack(
        [
            torch.clamp_min(1.0 + tr, 0.0),
            torch.clamp_min(1.0 + m00 - m11 - m22, 0.0),
            torch.clamp_min(1.0 - m00 + m11 - m22, 0.0),
            torch.clamp_min(1.0 - m00 - m11 + m22, 0.0),
        ],
        dim=-1,
    )
    S = 2.0 * torch.sqrt(comp2 + eps)
    s_w, s_x, s_y, s_z = S[..., 0], S[..., 1], S[..., 2], S[..., 3]
    cands = torch.stack(
        [
            torch.stack(
                [0.25 * s_w, (m21 - m12) / s_w, (m02 - m20) / s_w, (m10 - m01) / s_w],
                dim=-1,
            ),
            torch.stack(
                [(m21 - m12) / s_x, 0.25 * s_x, (m01 + m10) / s_x, (m02 + m20) / s_x],
                dim=-1,
            ),
            torch.stack(
                [(m02 - m20) / s_y, (m01 + m10) / s_y, 0.25 * s_y, (m12 + m21) / s_y],
                dim=-1,
            ),
            torch.stack(
                [(m10 - m01) / s_z, (m02 + m20) / s_z, (m12 + m21) / s_z, 0.25 * s_z],
                dim=-1,
            ),
        ],
        dim=-2,
    )
    pick = torch.argmax(comp2, dim=-1)
    idx = pick[..., None, None].expand(pick.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q * torch.sign(torch.where(q[..., :1] == 0.0, 1.0, q[..., :1]))
    v2 = torch.sum(q[..., 1:] ** 2, dim=-1)
    small = v2 < 1e-12
    vnorm = torch.sqrt(torch.where(small, 1.0, v2))
    angle = 2.0 * torch.atan2(torch.where(small, 0.0, vnorm), q[..., 0])
    scale = torch.where(
        small, 2.0 / torch.clamp_min(q[..., 0], 1e-6), angle / vnorm
    )
    return q[..., 1:] * scale[..., None]


def transform_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Pack rotation [..., 3, 3] and translation [..., 3] into [..., 4, 4]."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = constant((0.0, 0.0, 0.0, 1.0), R.dtype, R.device).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)
