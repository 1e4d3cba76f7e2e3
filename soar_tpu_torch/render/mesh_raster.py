"""Z-buffer triangle mesh rasterization (port of
``soar_tpu.render.mesh_raster``), in plain PyTorch: no gradients, no kernel.

    get_proj_mat(K, img_wh, znear) -> proj
    render_mesh(verts, faces, w2c, proj, img_wh)
        -> {"normal": [H, W, 3] in [0, 1], "mask": [H, W, 1],
            "depth": [H, W], "overflow": [2] (dropped past K, capped)}

The same tile-binned design as the splat renderer: project the triangles,
bin each face's screen bbox into 16x16 tiles through the capped
``dup_side`` slot grid (:mod:`soar_tpu_torch.render.tilegrid`), sort by
(tile, quantized NDC depth) nearest first, keep the first K entries of
each tile, then a dense per-pixel edge function and arg-min z-test over
[NT, P, K].  The sort is stable on an int64 key, as ``lax.sort_key_val``
keeps equal keys in input order; ``torch.argmin`` takes the first index
of a tie, as ``jnp.argmin`` does.

The z-test key is the projected NDC depth, so flipping the projection's
third row (the back-surface pass of ``preproc.compute_normal``) reverses
both the arg-min and the truncation order: that pass renders, and keeps,
the farthest faces.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core.camera import ndc2pix, projection_matrix
from .tilegrid import cdiv, depth_bits_for, quantize_depth, slot_tiles, tile_ranges
from .tilegrid import untile as _untile


def get_proj_mat(
    K: torch.Tensor, img_wh: Tuple[int, int], znear: float = 0.1, zfar: float = 1000.0
) -> torch.Tensor:
    """Projection from pinhole intrinsics, principal point included; on
    ``K``'s device."""
    W, H = img_wh
    K = torch.as_tensor(K, dtype=torch.float32)
    fovx = 2.0 * torch.arctan(W / (2.0 * K[0, 0]))
    fovy = 2.0 * torch.arctan(H / (2.0 * K[1, 1]))
    return projection_matrix(znear, zfar, fovx, fovy, cxcy=(K[0, 2], K[1, 2]),
                             img_wh=(W, H))


def _vertex_normals(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Area-weighted vertex normals: each face's cross product scattered
    onto its three vertices (``index_add_``), then normalised."""
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    fn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn.index_add_(0, faces[:, i], fn)
    return vn / torch.clamp_min(torch.linalg.norm(vn, dim=-1, keepdim=True), 1e-12)


@torch.no_grad()
def render_mesh(
    verts: torch.Tensor,  # [V, 3] world space
    faces: torch.Tensor,  # [F, 3] integer
    w2c: torch.Tensor,  # [4, 4] world->camera (column-vector convention)
    proj: torch.Tensor,  # [4, 4] from get_proj_mat
    img_wh: Tuple[int, int],
    tile: int = 16,
    max_per_tile: int = 64,
    dup_side: int = 8,
) -> Dict[str, torch.Tensor]:
    W, H = img_wh
    ntx, nty = cdiv(W, tile), cdiv(H, tile)
    NT = ntx * nty
    dev = verts.device
    verts = verts.float()
    faces = faces.to(device=dev, dtype=torch.int64)
    w2c = torch.as_tensor(w2c, dtype=torch.float32, device=dev)
    proj = torch.as_tensor(proj, dtype=torch.float32, device=dev)
    F = faces.shape[0]

    full_proj = proj @ w2c
    v_h = torch.cat([verts, torch.ones_like(verts[:, :1])], dim=-1)
    clip = v_h @ full_proj.T
    ndc = clip[:, :3] / torch.clamp_min(clip[:, 3:4], 1e-8)
    vx = ndc2pix(ndc[:, 0], W, 0.5)
    vy = ndc2pix(ndc[:, 1], H, 0.5)
    vz = (v_h @ w2c.T)[:, 2]  # view-space depth (output)
    vkey = ndc[:, 2]  # z-test key: screen-affine NDC depth
    vnorm = _vertex_normals(verts, faces)

    px, py, pz, pk = vx[faces], vy[faces], vz[faces], vkey[faces]  # [F, 3]
    fnorm = vnorm[faces]  # [F, 3, 3]
    valid = torch.all(pz > 1e-4, dim=-1)

    # Screen bbox -> tile rect, capped at dup_side^2 tiles per face.
    min_x = torch.clamp(torch.floor(px.amin(-1) / tile), 0, ntx).to(torch.int64)
    min_y = torch.clamp(torch.floor(py.amin(-1) / tile), 0, nty).to(torch.int64)
    max_x = torch.clamp(torch.floor((px.amax(-1) + tile) / tile), 0, ntx).to(torch.int64)
    max_y = torch.clamp(torch.floor((py.amax(-1) + tile) / tile), 0, nty).to(torch.int64)
    S = dup_side
    tile_id = slot_tiles(S, min_x, min_y, max_x, max_y, valid, ntx, NT)

    # (tile, depth) packed key, nearest first within a tile by the same key
    # the arg-min uses, so the first-K truncation drops the faces the z-test
    # would lose anyway (the farthest ones under the flipped back pass).
    depth_bits = depth_bits_for(NT)
    inf = torch.tensor(math.inf, device=dev)
    face_key = torch.where(valid[:, None], pk, inf).amin(-1)
    dq = quantize_depth(face_key, valid, depth_bits)
    key = (tile_id << depth_bits) | dq[:, None]
    face_idx = torch.arange(F, device=dev)[:, None].expand(F, S * S)
    sorted_key, perm = torch.sort(key.reshape(-1), stable=True)
    sorted_idx = face_idx.reshape(-1)[perm]
    starts, counts = tile_ranges(sorted_key >> depth_bits, NT)

    K = max_per_tile
    k_ar = torch.arange(K, device=dev)
    entry = torch.clamp_max(starts[:, None] + k_ar[None, :], sorted_idx.shape[0] - 1)
    slot_valid = k_ar[None, :] < torch.clamp_max(counts, K)[:, None]
    gidx = sorted_idx[entry]  # [NT, K]

    # Capacity canaries, as in ``tiled.bin_and_sort``: entries past K (the
    # farthest, harmless to the z-test in moderation) and faces whose bbox
    # exceeded the dup_side grid (real holes: raise dup_side).
    dropped = torch.clamp_min(counts - K, 0).sum()
    capped = ((((max_x - min_x) > S) | ((max_y - min_y) > S)) & valid).sum()
    overflow = torch.stack([dropped, capped]).to(torch.int32)

    gx, gy, gz, gk = px[gidx], py[gidx], pz[gidx], pk[gidx]  # [NT, K, 3]

    # Per-tile pixel coordinates [NT, P].
    t_ar = torch.arange(NT, device=dev)
    tx0, ty0 = (t_ar % ntx) * tile, (t_ar // ntx) * tile
    l_ar = torch.arange(tile, dtype=torch.float32, device=dev)
    lx, ly = l_ar.repeat(tile), l_ar.repeat_interleave(tile)
    pxf = tx0[:, None] + lx[None, :]
    pyf = ty0[:, None] + ly[None, :]

    # Edge functions / barycentrics [NT, P, K].
    x0, x1, x2 = gx[..., 0][:, None], gx[..., 1][:, None], gx[..., 2][:, None]
    y0, y1, y2 = gy[..., 0][:, None], gy[..., 1][:, None], gy[..., 2][:, None]
    X, Y = pxf[:, :, None], pyf[:, :, None]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    w0 = (x1 - X) * (y2 - Y) - (y1 - Y) * (x2 - X)
    w1 = (x2 - X) * (y0 - Y) - (y2 - Y) * (x0 - X)
    w2 = (x0 - X) * (y1 - Y) - (y0 - Y) * (x1 - X)
    denom = torch.where(area.abs() < 1e-12, torch.full_like(area, 1e-12), area)
    b0, b1, b2 = w0 / denom, w1 / denom, w2 / denom
    inside = ((b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0) & (area.abs() > 1e-12)
              & slot_valid[:, None, :])

    # Z-test on the NDC depth; the reported depth is the view-space depth,
    # perspective-correct through 1/z interpolation.
    zkey = b0 * gk[..., 0][:, None] + b1 * gk[..., 1][:, None] + b2 * gk[..., 2][:, None]
    zkey = torch.where(inside, zkey, inf)
    inv_z = b0 / gz[..., 0][:, None] + b1 / gz[..., 1][:, None] + b2 / gz[..., 2][:, None]
    depth = torch.where(inside, 1.0 / torch.clamp_min(inv_z, 1e-8), inf)

    best = torch.argmin(zkey, dim=-1)  # [NT, P], first index on ties
    bi = best[..., None]
    hit = torch.gather(zkey, 2, bi)[..., 0] < math.inf

    bsel = torch.stack([torch.gather(b, 2, bi)[..., 0] for b in (b0, b1, b2)], dim=-1)
    best_face = torch.gather(gidx, 1, best)  # [NT, P] face ids
    nsel = fnorm[best_face]  # [NT, P, 3 verts, 3]
    normal = torch.einsum("tpv,tpvc->tpc", bsel, nsel)
    normal = normal / torch.clamp_min(torch.linalg.norm(normal, dim=-1, keepdim=True), 1e-12)
    normal = torch.where(hit[..., None], (normal + 1.0) / 2.0, torch.zeros_like(normal))
    depth_out = torch.where(hit, torch.gather(depth, 2, bi)[..., 0], torch.zeros_like(pxf))

    def untile(img_flat, ch):
        return _untile(img_flat, ch, ntx, nty, tile, H, W)

    return {
        "normal": untile(normal, 3),
        "mask": untile(hit[..., None].float(), 1),
        "depth": untile(depth_out[..., None], 1)[..., 0],
        "overflow": overflow,
    }
