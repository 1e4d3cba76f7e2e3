"""Skinning-weight transfer and neighbor queries (port of
``soar_tpu.body.skinning``).

Chunked dense distances + top-k: the K=30 inverse-distance skinning blend
and the 3-NN mean squared distance for initial surfel scales.  Both are
one-time init costs (the surfel set is static).

``torch.topk`` and ``lax.top_k`` may order equal distances differently, so
at a tie on the K-th neighbour the two packages can pick different
neighbour sets; tests compare on random points, where ties do not occur.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _chunked_topk_neg_dist2(
    points: torch.Tensor, ref: torch.Tensor, k: int, chunk: int = 4096
):
    """For each point, negative squared distances and indices of its k
    nearest reference points, chunked over points to bound memory at
    ``chunk * V`` floats."""
    k = min(k, ref.shape[0])
    ref_sq = torch.sum(ref * ref, dim=-1)
    negs, idxs = [], []
    for start in range(0, points.shape[0], chunk):
        p = points[start:start + chunk]
        d2 = (
            torch.sum(p * p, dim=-1, keepdim=True)
            - 2.0 * p @ ref.T
            + ref_sq[None, :]
        )
        neg, idx = torch.topk(-d2, k, dim=-1)
        negs.append(neg)
        idxs.append(idx)
    return torch.cat(negs), torch.cat(idxs)


def knn_idw_weights(
    points: torch.Tensor,
    verts: torch.Tensor,
    lbs_weights: torch.Tensor,
    k: int = 30,
) -> torch.Tensor:
    """Inverse-distance-weighted LBS-weight blend over the K nearest
    canonical vertices (dist clamped to [1e-4, 1.0] after sqrt)."""
    neg_d2, idx = _chunked_topk_neg_dist2(points, verts, k)
    dist = torch.sqrt(torch.clamp_min(-neg_d2, 0.0))
    dist = torch.clamp(dist, 1e-4, 1.0)
    w = 1.0 / dist
    w = w / torch.sum(w, dim=-1, keepdim=True)
    neighbor_weights = lbs_weights[idx]  # [N, K, J]
    return torch.sum(w[..., None] * neighbor_weights, dim=-2)


def mean_knn_sq_dist(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Mean squared distance to the k nearest OTHER points (``distCUDA2``)."""
    neg_d2, _ = _chunked_topk_neg_dist2(points, points, k + 1)
    return torch.mean(-neg_d2[:, 1:], dim=-1)


class SkinningData(NamedTuple):
    inv_mats: torch.Tensor  # [J, 4, 4] inverse canonical per-joint affines
    cano_vertices: torch.Tensor  # [V, 3]
    point_weights: torch.Tensor  # [N, J]


def make_skinning_data(
    model_lbs_weights: torch.Tensor,
    cano_A: torch.Tensor,
    cano_vertices: torch.Tensor,
    points: torch.Tensor,
    k: int = 30,
) -> SkinningData:
    inv_mats = torch.linalg.inv(cano_A)
    weights = knn_idw_weights(points, cano_vertices, model_lbs_weights, k=k)
    return SkinningData(
        inv_mats=inv_mats, cano_vertices=cano_vertices, point_weights=weights
    )


def point_skinning_mats(skin: SkinningData, live_A: torch.Tensor) -> torch.Tensor:
    """Per-point canonical->live 4x4 transforms ``A_live @ A_cano^-1``
    blended by the per-point weights.  Returns [N, 4, 4]."""
    cano2live = live_A @ skin.inv_mats
    return torch.einsum("nj,jxy->nxy", skin.point_weights, cano2live)


def apply_point_mats(pt_mats: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform points by per-point affines."""
    return (
        torch.einsum("nxy,ny->nx", pt_mats[..., :3, :3], points)
        + pt_mats[..., :3, 3]
    )
