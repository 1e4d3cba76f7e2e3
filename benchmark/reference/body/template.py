"""Template-mesh processing for avatar initialization (port of
``soar_tpu.body.template``).

Host-side numpy with a seeded ``RandomState``, so the port reproduces the
JAX package's subdivision, normals and tangent frames exactly; only the
final matrix -> quaternion step runs through this package's own
:func:`rotmat_to_quat` in float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.transforms import rotmat_to_quat


def subdivide(
    verts: np.ndarray, faces: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """One round of midpoint subdivision: each edge gets a unique midpoint
    vertex, each face becomes 4 (``trimesh.remesh.subdivide`` connectivity)."""
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)

    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    edges_sorted = np.sort(edges, axis=1)
    V = len(verts)
    keys = edges_sorted[:, 0] * V + edges_sorted[:, 1]
    uniq_keys, inverse = np.unique(keys, return_inverse=True)
    uniq = np.stack([uniq_keys // V, uniq_keys % V], axis=1)
    midpoints = verts[uniq].mean(axis=1)
    mid_idx = inverse.reshape(3, -1).T + len(verts)  # [F, 3]: m01, m12, m20

    new_verts = np.concatenate([verts, midpoints], axis=0)
    f = faces
    m01, m12, m20 = mid_idx[:, 0], mid_idx[:, 1], mid_idx[:, 2]
    new_faces = np.concatenate(
        [
            np.stack([f[:, 0], m01, m20], axis=1),
            np.stack([m01, f[:, 1], m12], axis=1),
            np.stack([m20, m12, f[:, 2]], axis=1),
            np.stack([m01, m12, m20], axis=1),
        ],
        axis=0,
    )
    return new_verts.astype(np.float32), new_faces.astype(np.int64)


def subdivide_n(
    verts: np.ndarray, faces: np.ndarray, n: int
) -> Tuple[np.ndarray, np.ndarray]:
    """``init_xyz_on_mesh``: n rounds of subdivision."""
    for _ in range(n):
        verts, faces = subdivide(verts, faces)
    return verts, faces


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (trimesh ``vertex_normals`` semantics)."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    V = len(verts)
    vn = np.zeros_like(verts)
    idx = faces.reshape(-1)
    for c in range(3):
        vn[:, c] = np.bincount(idx, np.repeat(fn[:, c], 3), minlength=V)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def vertex_area_radius(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex disk radius from 1/3 of adjacent face areas."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1) / 2.0
    vtx_area = np.bincount(
        faces.reshape(-1), np.repeat(area / 3.0, 3), minlength=len(verts)
    )
    return np.sqrt(vtx_area / np.pi)


def init_qso_on_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    scale_init_factor: float = 1.0,
    thickness_init_factor: float = 0.5,
    max_scale: float = 0.1,
    min_scale: float = 0.0,
    opacity_base: float = 0.9,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Quaternion / scale-logit / opacity-logit init on a template mesh:
    frames with local z = vertex normal and random in-plane tangents.

    Returns (quats_wxyz [V,4], scale_logits [V,3], opacity_logits [V,1])."""
    rng = np.random.RandomState(seed)
    uz = vertex_normals(verts, faces)
    rand_dir = rng.randn(*uz.shape)
    ux = np.cross(uz, rand_dir)
    ux /= np.maximum(np.linalg.norm(ux, axis=-1, keepdims=True), 1e-12)
    uy = np.cross(uz, ux)
    uy /= np.maximum(np.linalg.norm(uy, axis=-1, keepdims=True), 1e-12)
    frame = np.stack([ux, uy, uz], axis=-1)  # columns

    # float32, as the JAX package converts the float64 frame before its
    # rotmat_to_quat.
    quats = rotmat_to_quat(torch.from_numpy(frame.astype(np.float32))).numpy()

    radius = vertex_area_radius(verts, faces)
    radius = np.clip(
        radius * scale_init_factor, min_scale + 1e-4, max_scale - 1e-4
    )
    thickness = np.clip(
        radius * thickness_init_factor, min_scale + 1e-4, max_scale - 1e-4
    )
    scale_logits = np.stack(
        [np.log(radius), np.log(radius), np.log(thickness)], axis=-1
    ).astype(np.float32)

    opacity_logit = float(np.log(opacity_base / (1.0 - opacity_base)))
    opacity_logits = np.full((len(verts), 1), opacity_logit, np.float32)
    return quats.astype(np.float32), scale_logits, opacity_logits
