"""Poisson surface reconstruction from oriented points — dependency-free
(port of ``soar_tpu.io.poisson``: numpy and scipy on the host, as there).

Rebuild of the reference's two Poisson paths, which both shell out to
binary packages this package does not depend on:

- ``geometry/mesh_utils.py:6`` ``poisson_mesh_reconstruction`` (open3d
  ``create_from_point_cloud_poisson`` at depth 9, statistical outlier
  removal, density-quantile vertex pruning);
- ``utils/general_utils.py:248`` ``poisson_mesh`` (pymeshlab screened
  Poisson + distance-quality pruning + Laplacian smoothing).

Neither has an in-repo caller (dead public API), but both are part of the
mesh-utils surface, so this module implements the same pipeline with the
tools at hand:

1. statistical outlier removal (kNN mean-distance gate, same
   ``nb_neighbors/std_ratio`` semantics as open3d);
2. normal estimation via local PCA when normals are absent, oriented
   outward from the local centroid axis (open3d's ``estimate_normals``);
3. trilinear splat of the oriented normals into a uniform-grid vector
   field V — the smoothed indicator gradient;
4. spectral Poisson solve  lap(chi) = div V  via numpy real FFTs.  The
   screened-Poisson octree of the reference exists to reach depth-9
   resolution sparsely; on a dense 128–256 grid the FFT solve is exact,
   simpler, and fast (the indicator is smooth, so periodic wrap with a
   padded border is harmless);
5. isosurface at the mean indicator value over the input samples
   (Kazhdan's iso-level choice) with the in-repo marching tetrahedra;
6. distance-quality vertex pruning against the input cloud (the
   density-quantile / ``q>thrsh`` pruning of both reference paths);
7. Laplacian smoothing (``apply_coord_laplacian_smoothing``,
   ``stepsmoothnum`` iterations).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _remove_statistical_outliers(
    points: np.ndarray, nb_neighbors: int = 20, std_ratio: float = 10.0
) -> np.ndarray:
    """Indices kept by open3d's ``remove_statistical_outlier`` rule: drop
    points whose mean kNN distance exceeds mean + std_ratio * std."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=min(nb_neighbors + 1, len(points)))
    mean_d = d[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    return np.nonzero(mean_d <= thresh)[0]


def estimate_normals(points: np.ndarray, k: int = 16) -> np.ndarray:
    """Local-PCA normals (smallest eigenvector of the kNN covariance),
    oriented away from the neighborhood centroid — adequate for the
    star-shaped body/garment clouds this pipeline meshes."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    _, idx = tree.query(points, k=min(k, len(points)))
    nbrs = points[idx]  # [N, k, 3]
    mu = nbrs.mean(axis=1, keepdims=True)
    d = nbrs - mu
    cov = np.einsum("nki,nkj->nij", d, d)
    _, vecs = np.linalg.eigh(cov)  # ascending eigenvalues
    n = vecs[:, :, 0]
    outward = points - points.mean(axis=0)
    flip = np.sign(np.sum(n * outward, axis=1, keepdims=True))
    flip[flip == 0] = 1.0
    return (n * flip).astype(np.float32)


def _splat_trilinear(
    grid: np.ndarray, pts01: np.ndarray, values: np.ndarray
) -> None:
    """Scatter-add ``values`` [N, C] into ``grid`` [R, R, R, C] with
    trilinear weights; ``pts01`` in [0, 1)."""
    R = grid.shape[0]
    p = pts01 * (R - 1)
    i0 = np.floor(p).astype(np.int64)
    f = (p - i0).astype(np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                ix = np.clip(i0[:, 0] + dx, 0, R - 1)
                iy = np.clip(i0[:, 1] + dy, 0, R - 1)
                iz = np.clip(i0[:, 2] + dz, 0, R - 1)
                np.add.at(grid, (ix, iy, iz), values * w[:, None])


def _sample_trilinear(grid: np.ndarray, pts01: np.ndarray) -> np.ndarray:
    R = grid.shape[0]
    p = pts01 * (R - 1)
    i0 = np.floor(p).astype(np.int64)
    f = (p - i0).astype(np.float32)
    out = np.zeros(len(pts01), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = (
                    (f[:, 0] if dx else 1 - f[:, 0])
                    * (f[:, 1] if dy else 1 - f[:, 1])
                    * (f[:, 2] if dz else 1 - f[:, 2])
                )
                ix = np.clip(i0[:, 0] + dx, 0, R - 1)
                iy = np.clip(i0[:, 1] + dy, 0, R - 1)
                iz = np.clip(i0[:, 2] + dz, 0, R - 1)
                out += grid[ix, iy, iz] * w
    return out


def _laplacian_smooth(
    verts: np.ndarray, faces: np.ndarray, iters: int = 3, lam: float = 0.5
) -> np.ndarray:
    """Umbrella-operator smoothing (``apply_coord_laplacian_smoothing``)."""
    if len(faces) == 0 or iters <= 0:
        return verts
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    v = verts.copy()
    deg = np.zeros(len(verts), np.float32)
    np.add.at(deg, src, 1.0)
    deg = np.maximum(deg, 1.0)[:, None]
    for _ in range(iters):
        acc = np.zeros_like(v)
        np.add.at(acc, src, v[dst])
        v = v + lam * (acc / deg - v)
    return v


def poisson_reconstruct(
    points: np.ndarray,
    normals: Optional[np.ndarray] = None,
    depth: int = 7,
    prune_quantile: float = 0.1,
    smooth_iters: int = 3,
    nb_neighbors: int = 20,
    std_ratio: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Reconstruct a watertight-ish surface from an oriented point cloud.

    ``depth`` sets the grid as 2**depth per side (capped at 256; the
    reference's octree depth-9 exists because dense CPU grids were
    infeasible there — the FFT solve makes 128–256 dense cheap).
    ``prune_quantile`` mirrors the reference's density-quantile vertex
    pruning: mesh vertices in the farthest-from-data quantile band are
    removed.  Returns (verts [V, 3], faces [F, 3]) in input coordinates.
    """
    from scipy.spatial import cKDTree

    from .meshing import clean_mesh, marching_tetrahedra

    points = np.asarray(points, np.float32).reshape(-1, 3)
    if len(points) < 8:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    keep = _remove_statistical_outliers(points, nb_neighbors, std_ratio)
    points = points[keep]
    if normals is None:
        normals = estimate_normals(points)
    else:
        normals = np.asarray(normals, np.float32).reshape(-1, 3)[keep]
        normals = normals / np.maximum(
            np.linalg.norm(normals, axis=1, keepdims=True), 1e-8
        )

    R = int(min(2 ** depth, 256))
    mn, mx = points.min(0), points.max(0)
    center = (mn + mx) / 2.0
    # border margin so the indicator can close around the shape
    scale = 0.8 / max(float((mx - mn).max()), 1e-6)
    pts01 = (points - center) * scale + 0.5  # in [0.1, 0.9]

    V = np.zeros((R, R, R, 3), np.float32)
    _splat_trilinear(V, pts01, normals)

    # div V by central differences (matches the splat's compact stencil
    # better than a spectral derivative, which rings at the samples)
    div = np.zeros((R, R, R), np.float32)
    for ax in range(3):
        div += np.gradient(V[..., ax], 1.0 / (R - 1), axis=ax)

    # spectral Poisson solve: lap(chi) = div  ->  chi_hat = -div_hat / k^2
    k = np.fft.fftfreq(R, d=1.0 / (R - 1)).astype(np.float32) * 2.0 * np.pi
    kz = np.fft.rfftfreq(R, d=1.0 / (R - 1)).astype(np.float32) * 2.0 * np.pi
    k2 = (
        k[:, None, None] ** 2 + k[None, :, None] ** 2
        + kz[None, None, :] ** 2
    )
    k2[0, 0, 0] = 1.0
    chi_hat = -np.fft.rfftn(div) / k2
    chi_hat[0, 0, 0] = 0.0
    chi = np.fft.irfftn(chi_hat, s=(R, R, R), axes=(0, 1, 2)).astype(np.float32)

    # With outward normals grad(chi) points outward, i.e. chi is high
    # OUTSIDE; negate so inside-is-high matches the density-field
    # convention marching_tetrahedra orients faces by.
    chi = -chi
    iso = float(_sample_trilinear(chi, pts01).mean())
    verts, faces = marching_tetrahedra(chi, iso)
    if len(verts) == 0:
        return verts, faces
    verts01 = verts / (R - 1.0)

    # distance-quality pruning vs the input cloud (general_utils.py:269-294)
    tree = cKDTree(pts01)
    d, _ = tree.query(verts01, k=1)
    if prune_quantile > 0.0:
        vthresh = np.quantile(d, 1.0 - prune_quantile)
        # never prune vertices closer than ~2 cells: quantile pruning on an
        # already-tight mesh must not eat the surface itself
        vkeep = d <= max(vthresh, 2.0 / R)
        remap = -np.ones(len(verts), np.int64)
        remap[vkeep] = np.arange(int(vkeep.sum()))
        fkeep = vkeep[faces].all(axis=1)
        verts01 = verts01[vkeep]
        faces = remap[faces[fkeep]]

    verts01, faces = clean_mesh(verts01, faces)
    if len(verts01):
        verts01 = _laplacian_smooth(verts01, faces, iters=smooth_iters)
    verts_w = (verts01 - 0.5) / scale + center
    return verts_w.astype(np.float32), faces
