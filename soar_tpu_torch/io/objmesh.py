"""OBJ mesh loading with optional UVs (port of ``soar_tpu.io.objmesh``;
numpy on the host, as there).

Replaces ``utils/mesh.py`` (``load_obj_mesh`` :262, used for the SMPL-X UV
template at ``utils/smpl.py:381-390``) with a compact numpy parser, plus
``compute_normal`` / ``compute_tangent`` equivalents (the normal computation
is shared with :mod:`soar_tpu_torch.body.template`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_obj_mesh(
    path: str, with_texture: bool = False
):
    """Returns (verts [V,3], faces [F,3]) or, with_texture,
    (verts, faces, uvs [T,2], uv_faces [F,3])."""
    verts, uvs, faces, uv_faces = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                uvs.append([float(x) for x in line.split()[1:3]])
            elif line.startswith("f "):
                toks = line.split()[1:]
                # triangulate polygons as a fan
                idx = [t.split("/") for t in toks]
                for i in range(1, len(idx) - 1):
                    tri = [idx[0], idx[i], idx[i + 1]]
                    faces.append([int(t[0]) - 1 for t in tri])
                    if len(tri[0]) > 1 and tri[0][1]:
                        uv_faces.append([int(t[1]) - 1 for t in tri])
    v = np.asarray(verts, np.float32)
    fc = np.asarray(faces, np.int64)
    if with_texture:
        return (
            v,
            fc,
            np.asarray(uvs, np.float32) if uvs else np.zeros((0, 2), np.float32),
            np.asarray(uv_faces, np.int64) if uv_faces else fc.copy(),
        )
    return v, fc


def compute_normal(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (``utils/mesh.py:386``)."""
    from ..body.template import vertex_normals

    return vertex_normals(verts, faces)


def compute_tangent(
    verts: np.ndarray,
    faces: np.ndarray,
    uvs: np.ndarray,
    uv_faces: np.ndarray,
) -> np.ndarray:
    """Per-vertex tangents from UV derivatives (``utils/mesh.py:409``)."""
    tan = np.zeros_like(verts)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    t0, t1, t2 = (uvs[uv_faces[:, i]] for i in range(3))
    e1, e2 = v1 - v0, v2 - v0
    du1, dv1 = t1[:, 0] - t0[:, 0], t1[:, 1] - t0[:, 1]
    du2, dv2 = t2[:, 0] - t0[:, 0], t2[:, 1] - t0[:, 1]
    r = du1 * dv2 - du2 * dv1
    r = np.where(np.abs(r) < 1e-12, 1e-12, r)
    t = (e1 * dv2[:, None] - e2 * dv1[:, None]) / r[:, None]
    for i in range(3):
        np.add.at(tan, faces[:, i], t)
    n = np.linalg.norm(tan, axis=-1, keepdims=True)
    return tan / np.maximum(n, 1e-12)
