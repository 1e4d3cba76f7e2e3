"""Correctness oracle: every pixel composites over ALL surfels (port of
``soar_tpu.render.oracle``).

O(N * H * W) and therefore test-scale only as a full image, but it has
exactly the semantics of the reference pipeline (preprocess -> global depth
sort -> front-to-back blend, ``cuda_rasterizer/rasterizer_impl.cu:188-313``)
with none of the tile machinery, which makes it the golden model of the
tiled renderer.  :func:`rasterize_oracle_at` evaluates it at chosen pixels,
which bounds the tiled renderer's truncation error from a subsample at
production scale.  Differentiable by plain autograd.

Where JAX maps a jitted chunk function over pixel chunks, this is a Python
loop, and eager PyTorch materialises each [pixels, N] intermediate that XLA
fused; the number of pixels per chunk is therefore capped from N
(:data:`CHUNK_ELEMENTS`).  A pixel's result does not depend on the chunk it
falls in.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.camera import Camera
from .composite import composite_weights, depth_plane_coeffs, finalize_accum, splat_alpha
from .preprocess import preprocess
from .tilegrid import cdiv
from .types import GaussianInputs, RasterConfig, RenderOutputs

# Most elements of one [pixels, N] intermediate (256 MiB in f32); a chunk
# holds about fifteen of them at once.
CHUNK_ELEMENTS = 1 << 26


def _oracle_chunk_renderer(
    g: GaussianInputs,
    camera: Camera,
    image_size: Tuple[int, int],
    bg_color: torch.Tensor,
    cfg: RasterConfig,
):
    """Shared preprocess + global sort + per-pixel-chunk compositor.
    Returns ``(render_chunk, N)`` with ``render_chunk(pix[p, 2]) -> (color,
    normal, depth, opac, T)``: the exact reference semantics at arbitrary
    pixel coordinates."""
    H, W = image_size
    pre = preprocess(g, camera, image_size, cfg)
    dev = pre.xy.device

    # Global depth sort, ascending (front-to-back) or descending for the
    # back-surface pass (``rasterizer_impl.cu:269-289``).  Invalid surfels
    # sort last via +inf keys; equal depths keep their index order.
    depth_key = -pre.depth if cfg.sort_descending else pre.depth
    key = torch.where(pre.valid, depth_key, torch.inf)
    order = torch.argsort(key, stable=True)

    xy = pre.xy[order]
    conic = pre.conic[order]
    opac = pre.opacities[order]
    valid = pre.valid[order]
    colors = pre.colors[order]
    normals = pre.normal_view[order]
    depths = pre.depth[order]
    jinv = pre.jinv[order]
    radius = pre.radius[order]

    # Tile-rect membership: the reference only blends a splat into pixels of
    # tiles inside its 3-sigma rect (``auxiliary.h:53-63`` + binning), so a
    # pixel outside the rect never sees the splat even where alpha >= 1/255.
    tile = cfg.tile
    ntx, nty = cdiv(W, tile), cdiv(H, tile)
    rect_min_x = torch.clamp(torch.floor((xy[:, 0] - radius) / tile), 0, ntx)
    rect_min_y = torch.clamp(torch.floor((xy[:, 1] - radius) / tile), 0, nty)
    rect_max_x = torch.clamp(torch.floor((xy[:, 0] + radius + tile - 1) / tile), 0, ntx)
    rect_max_y = torch.clamp(torch.floor((xy[:, 1] + radius + tile - 1) / tile), 0, nty)

    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)
    e = depth_plane_coeffs(jinv)

    def render_chunk(pchunk):
        d = xy[None, :, :] - pchunk[:, None, :]  # [p, N, 2]
        ptx = torch.floor(pchunk[:, 0:1] / tile)
        pty = torch.floor(pchunk[:, 1:2] / tile)
        in_rect = (
            (ptx >= rect_min_x[None])
            & (ptx < rect_max_x[None])
            & (pty >= rect_min_y[None])
            & (pty < rect_max_y[None])
        )
        alpha = splat_alpha(
            d, conic[None], opac[None], valid[None] & in_rect,
            cfg.alpha_clamp, cfg.alpha_min,
        )
        weights, t_final = composite_weights(alpha, cfg.transmittance_min)
        accum_color = weights @ colors
        if cfg.surface:
            accum_normal = weights @ normals
        else:
            accum_normal = torch.zeros((pchunk.shape[0], 3), dtype=weights.dtype, device=dev)
        if cfg.surface and cfg.perpix_depth:
            depth_k = depths[None] - (d[..., 0] * e[None, :, 0] + d[..., 1] * e[None, :, 1])
            accum_depth = torch.sum(weights * depth_k, dim=-1)
        else:
            accum_depth = weights @ depths
        return finalize_accum(
            accum_color, accum_normal, accum_depth, t_final, bg, cfg.normalize_depth
        )

    return render_chunk, xy.shape[0]


def _render_in_chunks(render_chunk, pix: torch.Tensor, n_surfels: int, pixel_chunk: int):
    chunk = max(1, min(pixel_chunk, CHUNK_ELEMENTS // max(n_surfels, 1)))
    parts = [render_chunk(pix[i:i + chunk]) for i in range(0, pix.shape[0], chunk)]
    return tuple(torch.cat(cols, dim=0) for cols in zip(*parts))


def rasterize_oracle_at(
    g: GaussianInputs,
    camera: Camera,
    image_size: Tuple[int, int],
    bg_color: torch.Tensor,
    pix: torch.Tensor,
    cfg: RasterConfig = RasterConfig(),
):
    """Exact-composite outputs at arbitrary pixel centres ``pix [P, 2]``
    (x, y float coords).  Returns ``(color [P, C], normal [P, 3], depth [P],
    opac [P], T [P])``."""
    render_chunk, n = _oracle_chunk_renderer(g, camera, image_size, bg_color, cfg)
    return _render_in_chunks(render_chunk, pix, n, pix.shape[0])


def rasterize_oracle(
    g: GaussianInputs,
    camera: Camera,
    image_size: Tuple[int, int],
    bg_color: torch.Tensor,
    cfg: RasterConfig = RasterConfig(),
    pixel_chunk: int = 4096,
) -> RenderOutputs:
    H, W = image_size
    render_chunk, n = _oracle_chunk_renderer(g, camera, image_size, bg_color, cfg)
    dev = g.means3d.device
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    pix = torch.stack([px, py], dim=-1).reshape(-1, 2)  # [H*W, 2]
    color, normal, depth, opac_out, T = _render_in_chunks(render_chunk, pix, n, pixel_chunk)
    return RenderOutputs(
        color=color.reshape(H, W, -1),
        normal=normal.reshape(H, W, 3),
        depth=depth.reshape(H, W),
        opac=opac_out.reshape(H, W),
        transmittance=T.reshape(H, W),
    )
