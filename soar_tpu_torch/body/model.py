"""SMPL-family body model and LBS (port of ``soar_tpu.body.model``).

``lbs`` returns vertices, joints and the per-joint 4x4 affines ``A`` that the
avatar re-skinning needs; :func:`smplx_forward_full` adds the SMPL-X
landmark joints (144 in all).  Bodies come from the official SMPL-X
``.npz`` (:func:`load_smplx_npz`) or legacy SMPL ``.pkl``
(:func:`load_smpl_pkl`), both user-supplied and never vendored, or from the
procedural :func:`make_test_body`, which needs no download.
"""

from __future__ import annotations

import math
import os
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


# The smplx package's extra vertex joints of the SMPL-X topology, in its
# VertexJointSelector order: face 5, feet 6, finger tips left then right 5.
SMPLX_EXTRA_JOINT_VERTEX_IDS = (
    9120,  # nose
    9929,  # reye
    9448,  # leye
    616,  # rear
    6,  # lear
    5770,  # LBigToe
    5780,  # LSmallToe
    8846,  # LHeel
    8463,  # RBigToe
    8474,  # RSmallToe
    8635,  # RHeel
    5361,  # lthumb
    4933,  # lindex
    5058,  # lmiddle
    5169,  # lring
    5286,  # lpinky
    8079,  # rthumb
    7669,  # rindex
    7794,  # rmiddle
    7905,  # rring
    8022,  # rpinky
)


def vertices2landmarks(
    vertices: torch.Tensor,  # [B, V, 3]
    faces: torch.Tensor,  # [F, 3]
    lmk_faces_idx: torch.Tensor,  # [L] or [B, L]
    lmk_bary_coords: torch.Tensor,  # [L, 3] or [B, L, 3]
) -> torch.Tensor:
    """Barycentric landmark interpolation -> [B, L, 3]."""
    B = vertices.shape[0]
    if lmk_faces_idx.ndim == 1:
        lmk_faces_idx = lmk_faces_idx[None].expand(B, -1)
        lmk_bary_coords = lmk_bary_coords[None].expand(B, -1, -1)
    lmk_faces = faces[lmk_faces_idx]  # [B, L, 3] vertex ids
    batch = torch.arange(B, device=vertices.device)[:, None, None]
    lmk_vertices = vertices[batch, lmk_faces]  # [B, L, 3, 3]
    return torch.einsum("blfi,blf->bli", lmk_vertices, lmk_bary_coords)


def _neck_y_bucket(full_pose: torch.Tensor, parents) -> torch.Tensor:
    """Dynamic-contour table row from the neck chain's y rotation: the
    axis-angle rotations along the chain from joint 12 to the root
    accumulated, turned into a y Euler angle, clamped and rounded (half to
    even, as ``jnp.round``) to a bucket in [0, 78]."""
    chain = []
    j = 12
    while j != -1:
        chain.append(j)
        j = parents[j]
    B = full_pose.shape[0]
    aa = full_pose.reshape(B, -1, 3)[:, chain]
    rots = batch_rodrigues(aa.reshape(-1, 3)).reshape(B, -1, 3, 3)
    rel = torch.eye(3, dtype=full_pose.dtype, device=full_pose.device).expand(B, 3, 3)
    for i in range(len(chain)):
        rel = torch.einsum("bij,bjk->bik", rots[:, i], rel)
    # rot_mat_to_euler: y = atan2(-R[2,0], sqrt(R[0,0]^2 + R[1,0]^2)).
    y = torch.atan2(-rel[:, 2, 0], torch.sqrt(rel[:, 0, 0] ** 2 + rel[:, 1, 0] ** 2))
    y_deg = torch.round(torch.clamp_max(-y * 180.0 / math.pi, 39.0)).to(torch.int64)
    neg_vals = torch.where(y_deg < -39, torch.full_like(y_deg, 78), 39 - y_deg)
    return torch.where(y_deg < 0, neg_vals, y_deg)


def smplx_forward_full(
    model: BodyModel, params: Dict[str, torch.Tensor]
) -> Tuple[LBSOutput, torch.Tensor]:
    """Forward returning ``(LBSOutput, joints144)``: [0:55] kinematic,
    [55:76] extra vertex joints, [76:127] static face landmarks, [127:144]
    the dynamic face contour.  Needs the landmark tables that
    :func:`load_smplx_npz` reads from a real SMPL-X npz.  The landmarks are
    interpolated on the translated vertices: barycentric weights sum to 1,
    so that equals translating the untranslated landmarks."""
    if model.extra_joint_idxs is None or model.lmk_faces_idx is None:
        raise ValueError(
            "smplx_forward_full needs the SMPL-X landmark tables "
            "(extra_joint_idxs / lmk_*); load the body via load_smplx_npz"
        )
    shape_components, full_pose, transl = _assemble_lbs_inputs(model, params)
    out = lbs(model, shape_components, full_pose, transl)
    extra = out.vertices[:, model.extra_joint_idxs]
    static = vertices2landmarks(out.vertices, model.faces, model.lmk_faces_idx,
                                model.lmk_bary_coords)
    parts = [out.joints, extra, static]
    if model.dyn_lmk_faces_idx is not None:
        bucket = _neck_y_bucket(full_pose, model.parents)
        parts.append(vertices2landmarks(out.vertices, model.faces,
                                        model.dyn_lmk_faces_idx[bucket],
                                        model.dyn_lmk_bary_coords[bucket]))
    return out, torch.cat(parts, dim=1)


def _to_device(arrays: Dict[str, Optional[np.ndarray]], dev) -> Dict:
    return {k: None if v is None else torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in arrays.items()}


def load_smplx_npz(
    path: str, num_betas: int = 10, num_expression: int = 10, device="cuda"
) -> BodyModel:
    """The official SMPL-X ``.npz`` (e.g. SMPLX_NEUTRAL.npz; user-supplied,
    https://smpl-x.is.tue.mpg.de/).  Keeps the first ``num_betas`` of its
    300 shape and the first ``num_expression`` of its 100 expression
    directions, posedirs as [P, V*3], the MANO hand means as ``pose_mean``
    (flat_hand_mean=False) and, with 55 joints, the landmark tables."""
    dev = resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SMPL-X model file not found: {path}. Download from "
            "https://smpl-x.is.tue.mpg.de/ (proprietary, not vendored)."
        )
    with np.load(path, allow_pickle=True) as data:
        v_template = np.asarray(data["v_template"], np.float32)
        shapedirs_all = np.asarray(data["shapedirs"], np.float32)
        if shapedirs_all.shape[-1] >= 400:
            shapedirs = np.concatenate(
                [shapedirs_all[..., :num_betas],
                 shapedirs_all[..., 300 : 300 + num_expression]], axis=-1)
        else:
            shapedirs = shapedirs_all[..., : num_betas + num_expression]
        posedirs = np.asarray(data["posedirs"], np.float32)
        posedirs = posedirs.reshape(-1, posedirs.shape[-1]).T  # [V, 3, P] -> [P, V*3]
        J_regressor = np.asarray(data["J_regressor"], np.float32)
        weights = np.asarray(data["weights"], np.float32)
        parents = np.asarray(data["kintree_table"], np.int64)[0].copy()
        parents[0] = -1
        faces = np.asarray(data["f"], np.int64)
        J = len(parents)
        # flat_hand_mean=False: the MANO hand means are added to the hand
        # segments (joints 25-39 left, 40-54 right); the others are 0.
        pose_mean = None
        if "hands_meanl" in data and J == 55:
            pose_mean = np.zeros((J * 3,), np.float32)
            pose_mean[25 * 3 : 40 * 3] = np.asarray(data["hands_meanl"], np.float32).reshape(-1)
            pose_mean[40 * 3 : 55 * 3] = np.asarray(data["hands_meanr"], np.float32).reshape(-1)
        lmk = dict.fromkeys(("extra_joint_idxs", "lmk_faces_idx", "lmk_bary_coords",
                             "dyn_lmk_faces_idx", "dyn_lmk_bary_coords"))
        if "lmk_faces_idx" in data and J == 55:
            lmk["lmk_faces_idx"] = np.asarray(data["lmk_faces_idx"], np.int64)
            lmk["lmk_bary_coords"] = np.asarray(data["lmk_bary_coords"], np.float32)
            lmk["extra_joint_idxs"] = np.asarray(SMPLX_EXTRA_JOINT_VERTEX_IDS, np.int64)
            if "dynamic_lmk_faces_idx" in data:
                lmk["dyn_lmk_faces_idx"] = np.asarray(data["dynamic_lmk_faces_idx"], np.int64)
                lmk["dyn_lmk_bary_coords"] = np.asarray(data["dynamic_lmk_bary_coords"],
                                                        np.float32)
    t = _to_device(dict(v_template=v_template, shapedirs=shapedirs, posedirs=posedirs,
                        J_regressor=J_regressor, lbs_weights=weights, faces=faces,
                        pose_mean=pose_mean, **lmk), dev)
    return BodyModel(parents=tuple(int(p) for p in parents), num_betas=num_betas, **t)


def save_smplx_npz(path: str, model: BodyModel) -> None:
    """Write ``model`` in the official SMPL-X ``.npz`` layout that
    :func:`load_smplx_npz` reads (``v_template``, ``shapedirs`` [V, 3, S],
    ``posedirs`` [V, 3, P], ``J_regressor``, ``weights``, ``kintree_table``,
    ``f``, the MANO hand means from ``pose_mean`` and the landmark tables).
    The file does not carry the extra joints' vertex ids: the reader takes
    SMPL-X's own, so a body that should read back equal has those."""
    def a(t):
        return t.detach().cpu().numpy()

    J = model.num_joints
    V = model.num_verts
    P = model.posedirs.shape[0]
    out = dict(
        v_template=a(model.v_template),
        shapedirs=a(model.shapedirs),
        posedirs=a(model.posedirs).T.reshape(V, 3, P),
        J_regressor=a(model.J_regressor),
        weights=a(model.lbs_weights),
        kintree_table=np.stack([np.asarray(model.parents, np.int64), np.arange(J)]),
        f=a(model.faces),
    )
    if model.pose_mean is not None and J == 55:
        pm = a(model.pose_mean)
        out.update(hands_meanl=pm[25 * 3:40 * 3], hands_meanr=pm[40 * 3:55 * 3])
    if model.lmk_faces_idx is not None:
        out.update(lmk_faces_idx=a(model.lmk_faces_idx), lmk_bary_coords=a(model.lmk_bary_coords))
    if model.dyn_lmk_faces_idx is not None:
        out.update(dynamic_lmk_faces_idx=a(model.dyn_lmk_faces_idx),
                   dynamic_lmk_bary_coords=a(model.dyn_lmk_bary_coords))
    with open(path, "wb") as f:
        np.savez(f, **out)


def load_smpl_pkl(path: str, num_betas: int = 10, device="cuda") -> BodyModel:
    """A legacy SMPL ``.pkl`` (basicModel_*_lbs_10_207_0_v1.0.0.pkl;
    user-supplied, https://smpl.is.tue.mpg.de/): 24 joints, no expression
    directions.  Array-likes are read with ``np.array``, a sparse
    ``J_regressor`` through its ``toarray()``."""
    import pickle

    dev = resolve_device(device)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"SMPL model file not found: {path} (download from "
            "https://smpl.is.tue.mpg.de/; proprietary, not vendored)"
        )
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")

    def arr(x, dtype=np.float32):
        if hasattr(x, "toarray"):  # a scipy sparse matrix
            x = x.toarray()
        return np.array(x, dtype=dtype)

    posedirs = arr(data["posedirs"])
    parents = np.asarray(data["kintree_table"], np.int64)[0].copy()
    parents[0] = -1
    t = _to_device(dict(
        v_template=arr(data["v_template"]),
        shapedirs=arr(data["shapedirs"])[..., :num_betas],
        posedirs=posedirs.reshape(-1, posedirs.shape[-1]).T,
        J_regressor=arr(data["J_regressor"]),
        lbs_weights=arr(data["weights"]),
        faces=np.asarray(data["f"], np.int64),
    ), dev)
    return BodyModel(parents=tuple(int(p) for p in parents), num_betas=num_betas, **t)


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
