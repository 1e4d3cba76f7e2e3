"""SMPL-family body model and LBS (port of ``soar_tpu.body.model``).

``lbs`` returns vertices, joints and the per-joint 4x4 affines ``A`` that the
avatar re-skinning needs.  The benchmark's bodies are the procedural
:func:`make_test_body`, which needs no download (no file loaders here).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.transforms import batch_rodrigues, transform_mat


class BodyModel(NamedTuple):
    v_template: torch.Tensor  # [V, 3]
    shapedirs: torch.Tensor  # [V, 3, S]
    posedirs: torch.Tensor  # [(J-1)*9, V*3]
    J_regressor: torch.Tensor  # [J, V]
    lbs_weights: torch.Tensor  # [V, J]
    parents: Tuple[int, ...]  # static kinematic tree, parents[0] == -1
    faces: torch.Tensor  # [F, 3] int64
    num_betas: int
    pose_mean: Optional[torch.Tensor] = None  # [J*3] additive mean pose
    # SMPL-X landmark tables (None for SMPL and procedural bodies): the extra
    # vertex joints and the face landmarks' barycentric tables that extend
    # the 55 kinematic joints to the smplx package's 144.
    extra_joint_idxs: Optional[torch.Tensor] = None  # [21] vertex ids
    lmk_faces_idx: Optional[torch.Tensor] = None  # [51] static face landmarks
    lmk_bary_coords: Optional[torch.Tensor] = None  # [51, 3]
    dyn_lmk_faces_idx: Optional[torch.Tensor] = None  # [79, 17] contour table
    dyn_lmk_bary_coords: Optional[torch.Tensor] = None  # [79, 17, 3]

    @property
    def num_joints(self) -> int:
        return len(self.parents)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]


class LBSOutput(NamedTuple):
    vertices: torch.Tensor  # [B, V, 3]
    joints: torch.Tensor  # [B, J, 3]
    A: torch.Tensor  # [B, J, 4, 4] per-joint world affines (transl included)


def lbs(
    model: BodyModel,
    shape_components: torch.Tensor,  # [B, S]
    full_pose: torch.Tensor,  # [B, J*3] axis-angle (global_orient first)
    transl: Optional[torch.Tensor] = None,  # [B, 3]
) -> LBSOutput:
    """Linear blend skinning; translation is applied to vertices, joints and
    baked into ``A[..., :3, 3]`` as the reference does."""
    B = full_pose.shape[0]
    J = model.num_joints

    v_shaped = model.v_template + torch.einsum(
        "bl,mkl->bmk", shape_components, model.shapedirs
    )
    joints = torch.einsum("bik,ji->bjk", v_shaped, model.J_regressor)

    rot_mats = batch_rodrigues(full_pose.reshape(B, J, 3))  # [B, J, 3, 3]

    ident = torch.eye(3, dtype=v_shaped.dtype, device=v_shaped.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)
    pose_offsets = (pose_feature @ model.posedirs).reshape(B, -1, 3)
    v_posed = v_shaped + pose_offsets

    rel_joints = joints - torch.cat(
        [torch.zeros_like(joints[:, :1]), joints[:, list(model.parents[1:])]],
        dim=1,
    )
    local_T = transform_mat(rot_mats, rel_joints)  # [B, J, 4, 4]
    chain = [local_T[:, 0]]
    for j in range(1, J):
        chain.append(chain[model.parents[j]] @ local_T[:, j])
    world_T = torch.stack(chain, dim=1)  # [B, J, 4, 4]
    posed_joints = world_T[..., :3, 3]

    # A = T - [0 | T @ j_rest]
    joints_h = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    shifted = torch.einsum("bjxy,bjy->bjx", world_T, joints_h)  # [B, J, 4]
    A = torch.cat(
        [world_T[..., :, :3], (world_T[..., :, 3] - shifted)[..., None]], dim=-1
    )

    T = torch.einsum("vj,bjxy->bvxy", model.lbs_weights, A)
    v_h = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvxy,bvy->bvx", T, v_h)[..., :3]

    if transl is not None:
        verts = verts + transl[:, None]
        posed_joints = posed_joints + transl[:, None]
        t4 = torch.cat([transl, torch.zeros_like(transl[:, :1])], dim=-1)
        A = torch.cat(
            [A[..., :, :3], (A[..., :, 3] + t4[:, None, :])[..., None]], dim=-1
        )

    return LBSOutput(vertices=verts, joints=posed_joints, A=A)


# SMPL-X full-pose segment layout: global(1) body(21) jaw leye reye
# lhand(15) rhand(15) = 55 joints.
SMPLX_SEGMENTS = (
    ("global_orient", 1),
    ("body_pose", 21),
    ("jaw_pose", 1),
    ("leye_pose", 1),
    ("reye_pose", 1),
    ("left_hand_pose", 15),
    ("right_hand_pose", 15),
)


def _pose_segments(params, num_joints: int):
    """The SMPL-X 7-segment layout for 55 joints, else (and for a
    ``body_pose`` covering the full J-1 tail) global + body_pose."""
    full_tail = (("global_orient", 1), ("body_pose", num_joints - 1))
    if num_joints != 55:
        return full_tail
    bp = params.get("body_pose")
    if bp is not None:
        n_tail = (num_joints - 1) * 3
        if bp.shape[-1] == n_tail or (
            bp.ndim >= 2 and tuple(bp.shape[-2:]) == (num_joints - 1, 3)
        ):
            return full_tail
    return SMPLX_SEGMENTS


def _seg_rows(p, n: int) -> int:
    """Batch rows of a segment param whose flat per-item length is ``n``."""
    if p is None or p.numel() % n:
        return 1
    rows = p.numel() // n
    return rows if (rows == 1 or (p.ndim >= 2 and p.shape[0] == rows)) else 1


def _to_batch(p: torch.Tensor, batch: int, n: int) -> torch.Tensor:
    """[n] / [k,3] / [1, n] / [batch, n] / [batch, k, 3] -> [batch, n]."""
    p = p.reshape(-1, n)
    if p.shape[0] != batch:
        p = p.expand(batch, n)
    return p


def assemble_smplx_pose(
    params: Dict[str, torch.Tensor], batch: int, num_joints: int = 55,
    device=None,
) -> torch.Tensor:
    """Concatenate pose segments into the full [B, J*3] pose vector; missing
    segments default to zeros."""
    parts = []
    for name, njoints in _pose_segments(params, num_joints):
        p = params.get(name)
        if p is None:
            p = torch.zeros((batch, njoints * 3), device=device)
        else:
            p = _to_batch(p, batch, njoints * 3)
        parts.append(p)
    return torch.cat(parts, dim=-1)


def smplx_forward(
    model: BodyModel, params: Dict[str, torch.Tensor]
) -> LBSOutput:
    """Forward from a reference-style param dict (betas / body_pose /
    global_orient / transl / hand & face poses / expression)."""
    shape_components, full_pose, transl = _assemble_lbs_inputs(model, params)
    return lbs(model, shape_components, full_pose, transl)


def _assemble_lbs_inputs(model: BodyModel, params: Dict[str, torch.Tensor]):
    """Param dict -> (shape_components, full_pose incl. pose_mean, transl)."""
    dev = model.v_template.device
    betas = torch.atleast_2d(params["betas"])
    J = model.num_joints
    n_expr_total = model.shapedirs.shape[-1] - model.num_betas
    seg_lens = {name: nj * 3 for name, nj in _pose_segments(params, J)}
    seg_lens["transl"] = 3
    rows = [betas.shape[0]]
    rows += [_seg_rows(params.get(k), n) for k, n in seg_lens.items()]
    if params.get("expression") is not None:
        rows.append(torch.atleast_2d(params["expression"]).shape[0])
    B = max(rows)
    if betas.shape[0] != B:
        betas = betas.expand(B, betas.shape[-1])
    n_expr = n_expr_total
    expr = params.get("expression")
    if n_expr > 0:
        if expr is None:
            expr = torch.zeros((B, n_expr), device=dev)
        expr = torch.atleast_2d(expr)[:, :n_expr]
        shape_components = torch.cat(
            [betas[:, : model.num_betas], _to_batch(expr, B, n_expr)], dim=-1
        )
    else:
        shape_components = betas[:, : model.num_betas]
    full_pose = assemble_smplx_pose(params, B, model.num_joints, device=dev)
    if model.pose_mean is not None:
        full_pose = full_pose + model.pose_mean
    transl = params.get("transl")
    if transl is not None:
        transl = _to_batch(transl, B, 3)
    return shape_components, full_pose, transl


def make_test_body(
    num_joints: int = 5,
    segments_per_bone: int = 4,
    ring: int = 8,
    num_betas: int = 4,
    seed: int = 0,
    device="cuda",
) -> BodyModel:
    """Procedural articulated "capsule chain" body: a chain of bones along
    +y, each wrapped in a tube of vertices, LBS weights interpolating
    between adjacent joints.  Built with numpy from ``seed`` exactly as
    ``soar_tpu.body.model.make_test_body`` builds it."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    J = num_joints
    bone_len = 0.25
    verts = []
    weights = []
    radius = 0.06
    n_rows = J * segments_per_bone
    for row in range(n_rows + 1):
        y = row / segments_per_bone * bone_len
        joint_f = row / segments_per_bone
        j0 = min(int(np.floor(joint_f)), J - 1)
        j1 = min(j0 + 1, J - 1)
        t = joint_f - j0 if j1 > j0 else 0.0
        for k in range(ring):
            a = 2 * np.pi * k / ring
            verts.append([radius * np.cos(a), y, radius * np.sin(a)])
            w = np.zeros(J)
            w[j0] = 1.0 - t
            w[j1] += t
            weights.append(w)
    v_template = np.asarray(verts, np.float32)
    lbs_weights = np.asarray(weights, np.float32)
    V = v_template.shape[0]

    faces = []
    for row in range(n_rows):
        for k in range(ring):
            a = row * ring + k
            b = row * ring + (k + 1) % ring
            c = (row + 1) * ring + k
            d = (row + 1) * ring + (k + 1) % ring
            faces.append([a, c, b])
            faces.append([b, c, d])
    faces = np.asarray(faces, np.int64)

    J_regressor = np.zeros((J, V), np.float32)
    for j in range(J):
        row = j * segments_per_bone
        J_regressor[j, row * ring : (row + 1) * ring] = 1.0 / ring

    parents = tuple([-1] + list(range(J - 1)))
    shapedirs = (rng.randn(V, 3, num_betas) * 0.01).astype(np.float32)
    posedirs = (rng.randn((J - 1) * 9, V * 3) * 1e-4).astype(np.float32)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return BodyModel(
        v_template=t(v_template),
        shapedirs=t(shapedirs),
        posedirs=t(posedirs),
        J_regressor=t(J_regressor),
        lbs_weights=t(lbs_weights),
        parents=parents,
        faces=t(faces),
        num_betas=num_betas,
    )
