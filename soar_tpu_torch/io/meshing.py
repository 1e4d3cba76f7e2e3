"""Gaussian -> mesh extraction (port of ``soar_tpu.io.meshing``).

Rebuild of the GaussianIO meshing path (``geometry/gaussian_io.py:176-292``)
plus the mesh utilities (``geometry/mesh_utils.py``), with the JAX package's
two substitutions:

- isosurfacing uses MARCHING TETRAHEDRA instead of the ``mcubes`` package:
  each cell splits into 6 tets whose 16 sign cases are derived
  programmatically — no 256-entry tri table, same isosurface (denser
  triangulation, which the decimation step absorbs);
- decimation/cleanup use vertex-clustering + degenerate-face removal instead
  of pymeshlab/open3d; Poisson reconstruction (``mesh_utils.py:6``) is the
  spectral uniform-grid solve in :mod:`.poisson`.

The density field — every grid point against every kept Gaussian — is the
part that runs on the device (:func:`extract_density_field`, ``device=``).
Where JAX evaluates a jitted 65,536-point chunk, eager PyTorch would
materialise a [points, N, 3] offset tensor; the offsets are kept as three
[points, N] components instead and the points per chunk are capped from N
(:data:`CHUNK_ELEMENTS`).  The sum at a grid point does not depend on the
chunk it falls in.  Isosurface, cleaning and decimation stay numpy on the
host, as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.transforms import quat_to_rotmat

# Most elements of one [points, N] intermediate of the density field
# (128 MiB in f32); a chunk holds about a dozen of them at once.
CHUNK_ELEMENTS = 1 << 25


def points_per_chunk(num_gaussians: int, chunk: int = 65536) -> int:
    """Grid points the density field evaluates at once against
    ``num_gaussians`` Gaussians: ``chunk``, capped so that one [points, N]
    intermediate holds at most :data:`CHUNK_ELEMENTS` elements."""
    return max(1, min(chunk, CHUNK_ELEMENTS // max(num_gaussians, 1)))


def _inverse_cov6(cov6: torch.Tensor):
    """The six coefficients of Sigma^-1 from the packed upper-triangular
    covariance (a, b, c, d, e, f) = (xx, xy, xz, yy, yz, zz)."""
    a, b, c, dd, e, f = (cov6[..., i] for i in range(6))
    det = a * dd * f + 2 * b * c * e - a * e * e - dd * c * c - f * b * b
    det = torch.where(torch.abs(det) < 1e-24, 1e-24, det)
    return (
        (dd * f - e * e) / det,
        (c * e - b * f) / det,
        (b * e - c * dd) / det,
        (a * f - c * c) / det,
        (b * c - a * e) / det,
        (a * dd - b * b) / det,
    )


def _coeff(x, y, z, inv6) -> torch.Tensor:
    ia, ib, ic, idd, ie, if_ = inv6
    power = -0.5 * (
        ia * x * x + idd * y * y + if_ * z * z
    ) - ib * x * y - ic * x * z - ie * y * z
    return torch.exp(torch.clamp_max(power, 0.0))


def gaussian_3d_coeff(d: torch.Tensor, cov6: torch.Tensor) -> torch.Tensor:
    """exp(-0.5 dᵀ Σ⁻¹ d) from the packed upper-triangular covariance
    (``geometry/gaussian_base.py:67-90``)."""
    return _coeff(d[..., 0], d[..., 1], d[..., 2], _inverse_cov6(cov6))


def extract_density_field(
    xyz,  # [N, 3]
    scales,  # [N, 3] activated
    quats,  # [N, 4] normalized
    opacities,  # [N]
    resolution: int = 128,
    opacity_min: float = 0.005,
    chunk: int = 65536,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Evaluate the summed-Gaussian density on a grid normalized to ~[-1,1]
    (``gaussian_io.py:176-267``).  Inputs are tensors or numpy arrays and are
    moved to ``device``, where every operation runs; at most ``chunk`` grid
    points are evaluated at once (fewer when N is large).  Returns
    ``(occ [R, R, R], center [3], scale)`` as numpy arrays and a float."""
    dev = resolve_device(device)
    xyz, scales, quats, opacities = (
        torch.as_tensor(a, dtype=torch.float32).to(dev).detach()
        for a in (xyz, scales, quats, opacities)
    )
    keep = opacities > opacity_min
    xyz, scales, quats, opacities = xyz[keep], scales[keep], quats[keep], opacities[keep]

    mn, mx = xyz.amin(0), xyz.amax(0)
    center = (mn + mx) / 2.0
    scale = 1.8 / max(float((mx - mn).max()), 1e-6)
    g_xyz = (xyz - center) * scale
    stds = scales * scale

    RS = quat_to_rotmat(quats) * stds[:, None, :]
    cov = RS @ RS.transpose(-1, -2)
    cov6 = torch.stack(
        [cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2],
         cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]],
        dim=-1,
    )
    inv6 = tuple(c[None, :] for c in _inverse_cov6(cov6))
    gx, gy, gz = (g_xyz[None, :, i] for i in range(3))

    # numpy's linspace, so the grid is the JAX package's to the bit.
    lin = torch.from_numpy(np.linspace(-1, 1, resolution, dtype=np.float32)).to(dev)
    xx, yy, zz = torch.meshgrid(lin, lin, lin, indexing="ij")
    pts = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)

    step = points_per_chunk(g_xyz.shape[0], chunk)
    vals = torch.empty(pts.shape[0], dtype=torch.float32, device=dev)
    for i in range(0, pts.shape[0], step):
        p = pts[i:i + step]
        w = _coeff(p[:, 0:1] - gx, p[:, 1:2] - gy, p[:, 2:3] - gz, inv6)
        vals[i:i + step] = torch.sum(w * opacities[None], dim=-1)
    occ = vals.reshape(resolution, resolution, resolution).cpu().numpy()
    return occ, center.cpu().numpy(), scale


# 6-tet decomposition of the cube around the main diagonal 0-7
# (corner indices in bit order: bit0=x, bit1=y, bit2=z).
_TETS = np.asarray(
    [
        [0, 1, 3, 7],
        [0, 3, 2, 7],
        [0, 2, 6, 7],
        [0, 6, 4, 7],
        [0, 4, 5, 7],
        [0, 5, 1, 7],
    ],
    np.int64,
)


def _tet_case_tables():
    """Static triangle emission per 4-bit inside mask: for each of the 14
    active cases, a list of triangles, each a row of 3 (inside-corner,
    outside-corner) edge pairs — the same emission order as the scalar
    marching-tets loop this replaced (1-in fan, 3-in reversed fan, 2-in
    quad split into two tris)."""
    tables = {}
    for code in range(1, 15):
        ins = [bool((code >> k) & 1) for k in range(4)]
        in_i = [k for k in range(4) if ins[k]]
        out_i = [k for k in range(4) if not ins[k]]
        if len(in_i) == 1:
            a = in_i[0]
            tris = [[(a, out_i[0]), (a, out_i[1]), (a, out_i[2])]]
        elif len(in_i) == 3:
            a = out_i[0]
            tris = [[(in_i[2], a), (in_i[1], a), (in_i[0], a)]]
        else:  # 2 in, 2 out -> quad -> 2 tris
            i0, i1 = in_i
            o0, o1 = out_i
            e0, e1, e2, e3 = (i0, o0), (i0, o1), (i1, o1), (i1, o0)
            tris = [[e0, e1, e2], [e0, e2, e3]]
        tables[code] = np.asarray(tris, np.int64)  # [n_tri, 3, 2]
    return tables


_TET_CASES = _tet_case_tables()


def marching_tetrahedra(
    field: np.ndarray, level: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a dense [X, Y, Z] field at ``level``.

    Vertices are returned in INDEX coordinates (like mcubes), faces int64.
    Fully vectorized: active cells -> 6 tets each -> per-case batched edge
    emission from static tables -> one ``np.unique`` over integer edge keys
    replaces the per-edge dict dedup (the scalar loop dominated
    ``extract_mesh`` runtime at production resolutions).
    """
    X, Y, Z = field.shape
    # Cube corner offsets in z-fastest bit order: bit0=x, bit1=y, bit2=z.
    corners = np.asarray(
        [[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)], np.int64
    )

    gx, gy, gz = np.meshgrid(
        np.arange(X - 1), np.arange(Y - 1), np.arange(Z - 1), indexing="ij"
    )
    base = np.stack([gx, gy, gz], -1).reshape(-1, 3)  # [C, 3]
    corner_pos = base[:, None, :] + corners[None]  # [C, 8, 3]
    corner_val = field[
        corner_pos[..., 0], corner_pos[..., 1], corner_pos[..., 2]
    ]  # [C, 8]

    inside_all = corner_val > level
    # Skip cells entirely inside/outside quickly.
    active = ~(inside_all.all(-1) | (~inside_all).all(-1))
    act = np.nonzero(active)[0]
    if len(act) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    # All tets of all active cells: positions [T, 4, 3], values [T, 4].
    tp = corner_pos[act][:, _TETS].reshape(-1, 4, 3)
    tv = corner_val[act][:, _TETS].reshape(-1, 4)
    code = (tv > level) @ np.asarray([1, 2, 4, 8])  # [T] 4-bit inside mask

    # Per-case batched emission: edge endpoints as (inside, outside) corner
    # positions/values, grouped in rows of 3 (one face per row).
    p_in, p_out, v_in, v_out = [], [], [], []
    for c, tris in _TET_CASES.items():
        sel = np.nonzero(code == c)[0]
        if len(sel) == 0:
            continue
        for tri in tris:  # tri: [3, 2] (in_corner, out_corner)
            p_in.append(tp[sel][:, tri[:, 0]])  # [S, 3, 3]
            p_out.append(tp[sel][:, tri[:, 1]])
            v_in.append(tv[sel][:, tri[:, 0]])  # [S, 3]
            v_out.append(tv[sel][:, tri[:, 1]])
    if not p_in:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    p_in = np.concatenate(p_in).reshape(-1, 3)  # [3*F, 3] lattice points
    p_out = np.concatenate(p_out).reshape(-1, 3)
    v_in = np.concatenate(v_in).reshape(-1)
    v_out = np.concatenate(v_out).reshape(-1)

    # Dedup edges by integer lattice-endpoint key (order-canonicalized).
    # Every tet sharing an edge classifies its endpoints identically
    # (inside-ness is a property of the field values), so the interpolated
    # vertex is the same for every occurrence — keep the first.
    NV = X * Y * Z
    id_in = (p_in[:, 0] * Y + p_in[:, 1]) * Z + p_in[:, 2]
    id_out = (p_out[:, 0] * Y + p_out[:, 1]) * Z + p_out[:, 2]
    key = np.minimum(id_in, id_out) * NV + np.maximum(id_in, id_out)
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)

    t = (level - v_in[first]) / (v_out[first] - v_in[first] + 1e-12)
    t = np.clip(t, 0.0, 1.0)[:, None]
    verts_np = (
        p_in[first] + (p_out[first] - p_in[first]) * t
    ).astype(np.float32)
    faces_np = inv.reshape(-1, 3).astype(np.int64)
    # Consistent outward winding: the 6-tet cube decomposition has mixed
    # parity, so per-tet case emission alone leaves ~half the faces flipped.
    # Orient every face against the field gradient at its centroid (the
    # inside>level region has increasing field, so outward normals must
    # oppose the gradient).
    grad = np.stack(np.gradient(field.astype(np.float32)), axis=-1)
    cent = verts_np[faces_np].mean(axis=1)
    ci = np.clip(
        np.round(cent).astype(np.int64), 0, np.asarray(field.shape) - 1
    )
    gc = grad[ci[:, 0], ci[:, 1], ci[:, 2]]
    fn = np.cross(
        verts_np[faces_np[:, 1]] - verts_np[faces_np[:, 0]],
        verts_np[faces_np[:, 2]] - verts_np[faces_np[:, 0]],
    )
    flip = np.sum(fn * gc, axis=1) > 0
    faces_np[flip] = faces_np[flip][:, ::-1]
    return verts_np, faces_np


def clean_mesh(
    verts: np.ndarray, faces: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop degenerate faces and unreferenced vertices
    (``geometry/mesh_utils.py:91`` equivalent, dependency-free)."""
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    ok = (v0 != v1) & (v1 != v2) & (v0 != v2)
    a = np.linalg.norm(
        np.cross(verts[v1] - verts[v0], verts[v2] - verts[v0]), axis=-1
    )
    faces = faces[ok & (a > 1e-12)]
    used = np.unique(faces)
    remap = np.full(len(verts), -1, np.int64)
    remap[used] = np.arange(len(used))
    return verts[used], remap[faces]


def decimate_mesh(
    verts: np.ndarray, faces: np.ndarray, target_faces: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Vertex-clustering decimation (``mesh_utils.py:45`` contract without
    pymeshlab): snap vertices to a grid sized to roughly hit the target face
    count, merge, drop degenerates."""
    if len(faces) <= target_faces:
        return verts, faces
    lo, hi = verts.min(0), verts.max(0)
    extent = float((hi - lo).max())
    # Face count scales ~ (extent/cell)²; solve for cell size.
    cells = max(int(np.sqrt(target_faces / 2.0)), 4)
    for _ in range(8):
        cell = extent / cells
        key = np.floor((verts - lo) / max(cell, 1e-12)).astype(np.int64)
        kflat = key[:, 0] * 73856093 ^ key[:, 1] * 19349663 ^ key[:, 2] * 83492791
        uniq, inv = np.unique(kflat, return_inverse=True)
        new_verts = np.zeros((len(uniq), 3))
        cnt = np.zeros(len(uniq))
        np.add.at(new_verts, inv, verts)
        np.add.at(cnt, inv, 1.0)
        new_verts /= cnt[:, None]
        new_faces = inv[faces]
        new_verts2, new_faces2 = clean_mesh(new_verts, new_faces)
        if len(new_faces2) <= target_faces or cells <= 4:
            return new_verts2.astype(np.float32), new_faces2
        cells = int(cells * 0.8)
    return new_verts2.astype(np.float32), new_faces2


def extract_mesh(
    params,
    density_thresh: float = 0.8,
    resolution: int = 128,
    decimate_target: int = 100000,
    scales=None,
    opacities=None,
    timings: Optional[Dict[str, float]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full pipeline (``gaussian_io.py:268-292``): density field ->
    isosurface -> clean -> decimate; vertices mapped back to world space.
    The density field runs on the device ``params`` lives on.

    By default the density reads the EXPLICIT scaling/opacity logits —
    exactly what the reference's ``extract_fields`` does via
    ``get_scaling``/``get_opacity`` (``gaussian_io.py:184-191``).  Note the
    reference quirk this inherits: SOAR's field-driven training renders
    with field scales and opacity forced to 1
    (``diff_gaussian_rasterizer.py:88-102, 259``), so those explicit
    tensors stay at their init values and the exported isosurface reflects
    init-time attributes.  Pass ``scales`` [N, 1|3] (linear) and
    ``opacities`` [N] (0..1) — e.g. ``query_attributes`` outputs — to
    export from what the trained avatar actually renders.

    ``timings``, when given, receives the wall seconds of the density field
    (``density_field_s``, ended by the copy of the grid to the host) and of
    the host part (``host_s``)."""
    from ..avatar import state as S

    dev = params.xyz.device
    with torch.no_grad():
        if scales is None:
            scales = S.get_scaling(params)
        scales = torch.as_tensor(scales, dtype=torch.float32).to(dev)
        if scales.shape[-1] == 1:
            scales = scales.expand(-1, 3)
        if opacities is None:
            opacities = S.get_opacity(params)[:, 0]
        opacities = torch.as_tensor(opacities, dtype=torch.float32).to(dev).reshape(-1)
        t0 = time.perf_counter()
        occ, center, scale = extract_density_field(
            params.xyz,
            scales[:, :3],
            S.get_rotation(params),
            opacities,
            resolution=resolution,
            device=dev,
        )
    t1 = time.perf_counter()
    verts, faces = marching_tetrahedra(occ, density_thresh)
    if len(verts):
        verts = verts / (resolution - 1.0) * 2.0 - 1.0
        verts = verts / scale + center
        verts, faces = clean_mesh(verts, faces)
        if decimate_target > 0 and len(faces) > decimate_target:
            verts, faces = decimate_mesh(verts, faces, decimate_target)
        verts = verts.astype(np.float32)
    if timings is not None:
        timings["density_field_s"] = t1 - t0
        timings["host_s"] = time.perf_counter() - t1
    return verts, faces


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Mesh exporter (``geometry/exporter.py`` obj output)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def poisson_reconstruct(points, normals=None, **kwargs):
    """Poisson surface reconstruction from oriented points
    (``geometry/mesh_utils.py:6``, ``utils/general_utils.py:248``) —
    dependency-free spectral implementation in :mod:`.poisson`."""
    from .poisson import poisson_reconstruct as _pr

    return _pr(points, normals, **kwargs)
