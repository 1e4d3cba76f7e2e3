"""Tile-binned surfel rasterizer (port of ``soar_tpu.render.tiled``).

The pipeline of the JAX package: preprocess; duplicate each surfel into a
static grid of tile slots (two-tier budget) and sort (tile, depth) keys;
per-tile ranges; a first-K gather of each tile's depth-ascending run; the
per-tile composite; output assembly.  The composite is
:func:`soar_tpu_torch.render.block_composite.composite_block` (the CUDA
kernel on CUDA tensors, its plain version on CPU tensors) unless
``RasterConfig.composite == "plain"``, which also honours
``composite_dtype="bf16"``.

The back-surface pass walks each tile's ascending run farthest-first (the
reversed gather), either alone (``compose_reverse``) or beside the front
pass from one sort (:func:`rasterize_front_back`).

A view runs in three phases: :func:`raster_passes` (preprocess to the
composites' inputs), :func:`composite_passes` and ``Passes.finish`` (the
output assembly), so that a caller can run the composites apart from the
rest (:mod:`soar_tpu_torch.render.graphs` replays the other two from CUDA
graphs).

``rows`` (a :func:`soar_tpu_torch.parallel.row_sharder`) row-shards a view
over the ranks of a process group: preprocess, binning, sort and gather
run whole on every rank, each rank composites its band of tile rows (a
contiguous slice of the tile axis), and the bands' composite outputs are
gathered, with autograd, before the output assembly.  Without it the
process composites every tile.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import torch

from ..core import spans
from ..core.camera import Camera
from . import graphs
from .block_composite import composite_block
from .composite import (
    composite_block_plain,
    depth_plane_coeffs,
    finalize_accum,
    tile_pixel_centres,
)
from .preprocess import preprocess
from .tilegrid import (
    cdiv,
    depth_bits_for,
    quantize_depth,
    slot_tiles as _slot_tiles,
    tile_ranges,
)
from .tilegrid import untile as _untile
from .types import GaussianInputs, Preprocessed, RasterConfig, RenderOutputs


@spans.spanned("soar.raster.sort")
def bin_and_sort(pre: Preprocessed, image_size: Tuple[int, int], cfg: RasterConfig):
    """Duplicate surfels into per-tile slots and depth-sort within tiles.

    Returns ``(sorted surfel indices [M], per-tile starts [NT], per-tile
    counts [NT], (ntx, nty), overflow [2] = (dropped past K, capped))``.
    """
    H, W = image_size
    tile = cfg.tile
    ntx, nty = cdiv(W, tile), cdiv(H, tile)
    NT = ntx * nty
    N = pre.xy.shape[0]
    S = cfg.dup_side
    dev = pre.xy.device

    x, y = pre.xy[:, 0], pre.xy[:, 1]
    r = pre.radius
    # Tile rect per surfel (``auxiliary.h:53-63`` getRect), clamped to grid.
    rect_min_x = torch.clamp(torch.floor((x - r) / tile), 0, ntx).to(torch.int64)
    rect_min_y = torch.clamp(torch.floor((y - r) / tile), 0, nty).to(torch.int64)
    rect_max_x = torch.clamp(
        torch.floor((x + r + tile - 1) / tile), 0, ntx
    ).to(torch.int64)
    rect_max_y = torch.clamp(
        torch.floor((y + r + tile - 1) / tile), 0, nty
    ).to(torch.int64)

    # Two-tier slot budget: every surfel gets an Ss x Ss slot grid; the
    # first fat_budget surfels (index order) whose rect exceeds it get the
    # full S x S grid instead.  Each surfel's slots come from exactly one
    # tier, so no tile composites a surfel twice.
    Ss = min(cfg.dup_side_small, S)
    B = min(cfg.fat_budget, N)
    two_tier = 0 < B < N and Ss < S
    if two_tier:
        wide = (
            ((rect_max_x - rect_min_x) > Ss) | ((rect_max_y - rect_min_y) > Ss)
        ) & pre.valid
        in_fat = wide & (torch.cumsum(wide, dim=0) <= B)
        # Stable argsort of the bool cast to an integer (torch does not
        # sort bools): the first B indices are the fat set, in index order.
        fat_idx = torch.argsort((~in_fat).to(torch.int32), stable=True)[:B]
        fat_ok = pre.valid[fat_idx] & in_fat[fat_idx]
    else:
        Ss = S
        fat_idx = None
        in_fat = torch.ones((N,), dtype=torch.bool, device=dev)

    def slot_tiles(side, mnx, mny, mxx, mxy, ok_row):
        return _slot_tiles(side, mnx, mny, mxx, mxy, ok_row, ntx, NT)

    if two_tier:
        tile_small = slot_tiles(
            Ss, rect_min_x, rect_min_y, rect_max_x, rect_max_y,
            pre.valid & ~in_fat,
        )  # [N, Ss*Ss]
        tile_fat = slot_tiles(
            S,
            rect_min_x[fat_idx],
            rect_min_y[fat_idx],
            rect_max_x[fat_idx],
            rect_max_y[fat_idx],
            fat_ok,
        )  # [B, S*S]
    else:
        tile_fat = slot_tiles(
            S, rect_min_x, rect_min_y, rect_max_x, rect_max_y, pre.valid
        )

    # (tile, depth) packed as in the JAX package's uint32 key, held in int64.
    depth_bits = depth_bits_for(NT)
    depth_key = -pre.depth if cfg.sort_descending else pre.depth
    dq = quantize_depth(depth_key, pre.valid, depth_bits)

    ids = torch.arange(N, dtype=torch.int64, device=dev)
    key_fat = (tile_fat << depth_bits) | (dq if not two_tier else dq[fat_idx])[:, None]
    idx_fat = (ids if not two_tier else fat_idx)[:, None].expand(tile_fat.shape)
    if two_tier:
        key_small = (tile_small << depth_bits) | dq[:, None]
        idx_small = ids[:, None].expand(tile_small.shape)
        key = torch.cat([key_small.reshape(-1), key_fat.reshape(-1)])
        surfel_idx = torch.cat([idx_small.reshape(-1), idx_fat.reshape(-1)])
    else:
        key = key_fat.reshape(-1)
        surfel_idx = idx_fat.reshape(-1)

    sorted_key, perm = torch.sort(key, stable=True)
    sorted_idx = surfel_idx[perm]
    sorted_tile = sorted_key >> depth_bits
    starts, counts = tile_ranges(sorted_tile, NT)

    # Capacity canaries: splats past max_per_tile are dropped by the
    # first-K gather; surfels wider than their tier's slot grid are capped.
    dropped = torch.sum(torch.clamp_min(counts - cfg.max_per_tile, 0))
    wide_small = ((rect_max_x - rect_min_x) > Ss) | ((rect_max_y - rect_min_y) > Ss)
    wide_fat = ((rect_max_x - rect_min_x) > S) | ((rect_max_y - rect_min_y) > S)
    capped = torch.sum(torch.where(in_fat, wide_fat, wide_small) & pre.valid)
    overflow = torch.stack([dropped, capped]).to(torch.int32)
    if spans.on():
        spans.count("raster.keys", key.numel())
        spans.count("raster.keys_in_tiles", counts.sum())
        spans.count("raster.dropped", overflow[0])
        spans.count("raster.capped", overflow[1])
    return sorted_idx, starts, counts, (ntx, nty), overflow


# Column layout of :func:`pack_surfels`: one gather serves every attribute.
_PACK_XY, _PACK_CONIC, _PACK_OPAC, _PACK_DEPTH = slice(0, 2), slice(2, 5), 5, 6
_PACK_VIEW_DOT, _PACK_JINV, _PACK_NORMAL, _PACK_COLOR0 = 7, slice(8, 18), slice(18, 21), 21


def pack_surfels(pre: Preprocessed) -> torch.Tensor:
    """The per-surfel attributes the composite reads, as one [N, 21 + C]
    array: xy 0:2, conic 2:5, opacity 5, depth 6, view_dot 7, jinv 8:18,
    view-space normal 18:21, colours 21:.  Culled rows are zeroed: they are
    still gatherable as first-K padding of a short tile run (masked by the
    slot mask), and NaN*0 would stay NaN."""
    packed = torch.cat(
        [
            pre.xy,
            pre.conic,
            pre.opacities[:, None],
            pre.depth[:, None],
            pre.view_dot[:, None],
            pre.jinv,
            pre.normal_view,
            pre.colors,
        ],
        dim=-1,
    )
    return torch.where(pre.valid[:, None], packed, 0.0)


def _slot_valid(counts: torch.Tensor, K: int) -> torch.Tensor:
    k_ar = torch.arange(K, dtype=torch.int64, device=counts.device)
    return k_ar[None, :] < torch.clamp_max(counts, K)[:, None]


def gather_slots(packed, sorted_idx, starts, counts, K: int, reverse: bool = False):
    """First-K gather of each tile's depth-ascending run; truncation drops
    the farthest splats.  ``reverse`` walks the run from its far end (offset
    ``count-1-k``), the back-surface order, keeping the farthest K.  Entries
    past a tile's count read neighbouring runs (or below its start,
    reversed) and are masked by the slot mask.  Returns ``(surfel indices
    [NT, K], gathered rows [NT, K, F])``."""
    NT, M = counts.shape[0], sorted_idx.shape[0]
    k_ar = torch.arange(K, dtype=torch.int64, device=counts.device)
    if reverse:
        off = counts[:, None] - 1 - k_ar[None, :]
    else:
        off = k_ar[None, :].expand(NT, K)
    entry = torch.clamp(starts[:, None] + off, 0, M - 1)  # [NT, K]
    gidx = sorted_idx[entry]
    return gidx, packed[gidx]


def tile_origins(ntx: int, nty: int, tile: int, device) -> torch.Tensor:
    """Top-left pixel (x, y) of every tile, row-major: int64 [NT, 2]."""
    t_ar = torch.arange(ntx * nty, dtype=torch.int64, device=device)
    return torch.stack([(t_ar % ntx) * tile, (t_ar // ntx) * tile], dim=-1)


def gather_tile_lists(
    pre: Preprocessed, image_size: Tuple[int, int], cfg: RasterConfig, reverse: bool = False
):
    """The gathered tile lists of one view, as the arguments of
    :func:`soar_tpu_torch.render.tiles_composite.composite_tiles` (and of its
    plain version): ``(xy, conic, opac, colors, normals, depths, jinv,
    slot_valid, counts, tile_origins)`` from the same binning, sort and
    first-K gather the rasterizer composites, plus the grid ``(ntx, nty)``
    and the overflow canaries."""
    sorted_idx, starts, counts, (ntx, nty), overflow = bin_and_sort(pre, image_size, cfg)
    K = cfg.max_per_tile
    _, gf = gather_slots(pack_surfels(pre), sorted_idx, starts, counts, K, reverse)
    lists = (
        gf[..., _PACK_XY], gf[..., _PACK_CONIC], gf[..., _PACK_OPAC],
        gf[..., _PACK_COLOR0:], gf[..., _PACK_NORMAL], gf[..., _PACK_DEPTH],
        gf[..., _PACK_JINV], _slot_valid(counts, K), counts,
        tile_origins(ntx, nty, cfg.tile, pre.xy.device),
    )
    return lists, (ntx, nty), overflow


def rasterize(
    g: GaussianInputs,
    camera: Camera,
    image_size: Tuple[int, int],
    bg_color: torch.Tensor,
    cfg: RasterConfig = RasterConfig(),
    rows=None,
) -> RenderOutputs:
    """Render one view.  Returns images shaped [H, W, ...]."""
    passes = raster_passes(g, camera, image_size, bg_color, cfg, None)
    return passes.finish(composite_passes(passes, cfg, rows))[0]


def rasterize_with_occ(
    g: GaussianInputs,
    occ_colors: torch.Tensor,
    camera: Camera,
    image_size: Tuple[int, int],
    bg_color: torch.Tensor,
    cfg: RasterConfig = RasterConfig(),
    rows=None,
) -> Tuple[RenderOutputs, RenderOutputs]:
    """Main pass + front-face-culled occlusion pass sharing one preprocess /
    binning / sort / gather: the occ pass re-composites the gathered slots
    with the occ colors, back-facing splats suppressed."""
    passes = raster_passes(g, camera, image_size, bg_color, cfg, occ_colors)
    return passes.finish(composite_passes(passes, cfg, rows))


def rasterize_front_back(
    g: GaussianInputs,
    occ_colors: torch.Tensor,
    camera: Camera,
    image_size: Tuple[int, int],
    bg_color: torch.Tensor,
    cfg: RasterConfig = RasterConfig(),
    rows=None,
) -> Tuple[RenderOutputs, RenderOutputs, RenderOutputs]:
    """Front-surface pass + back-surface pass + occlusion pass, all from one
    preprocess / binning / sort / gather: the back pass walks each tile's
    ascending run farthest-first (the reversed gather).  Returns
    ``(front, back, occ)``."""
    if cfg.sort_descending or cfg.compose_reverse:
        raise ValueError("rasterize_front_back takes an ascending, forward config")
    passes = raster_passes(g, camera, image_size, bg_color, cfg, occ_colors, also_back=True)
    (front, back), occ = passes.finish(composite_passes(passes, cfg, rows))
    return front, back, occ


def _band_composite(composite, rows, ntx: int, nty: int):
    """``composite`` on this rank's band of tile rows: its seven per-tile
    inputs sliced to the band's tiles, its three outputs gathered from
    every rank's band (one collective: packed along the channel axis)."""
    r0, r1 = rows.block(nty)
    t0, t1 = r0 * ntx, r1 * ntx

    def run(*args):
        tensors, consts = args[:7], args[7:]
        accum, corr, t_final = composite(*(a[t0:t1] for a in tensors), *consts)
        C = accum.shape[-1]
        band = torch.cat([accum, corr[..., None], t_final[..., None]], dim=-1)
        whole = rows.gather(band, nty, unit=ntx)
        return whole[..., :C], whole[..., C], whole[..., C + 1]

    return run


class Passes(NamedTuple):
    """One view rasterized up to its composites: the seven tensor arguments
    of each composite call (main pass, back pass, occ pass, in that order,
    as present), the constants every call takes, the tile grid, and
    ``finish``, which takes the calls' ``(accum, corr, T)`` in ``jobs``'
    order and assembles ``(main, occ)`` as :func:`rasterize_with_occ`
    returns them (``main`` a ``(front, back)`` pair with a back pass, ``occ``
    None without an occ pass)."""

    jobs: List[Tuple[torch.Tensor, ...]]
    consts: Tuple[float, float, float]
    grid: Tuple[int, int]
    finish: Callable


def raster_passes(
    g: GaussianInputs,
    camera: Camera,
    image_size: Tuple[int, int],
    bg_color: torch.Tensor,
    cfg: RasterConfig,
    occ_colors: Optional[torch.Tensor],
    also_back: bool = False,
) -> Passes:
    """Preprocess, binning, sort and gathers of one view, and the inputs of
    its composites; :func:`composite_passes` runs the composites and
    ``Passes.finish`` the rest."""
    H, W = image_size
    tile = cfg.tile
    K = cfg.max_per_tile
    dev = g.means3d.device

    pre = preprocess(g, camera, image_size, cfg)
    sorted_idx, starts, counts, (ntx, nty), overflow = bin_and_sort(
        pre, image_size, cfg
    )
    C_ch = pre.colors.shape[-1]
    with spans.span("soar.raster.gather"):
        slot_valid = _slot_valid(counts, K)
        packed = pack_surfels(pre)

        def gather(reverse: bool):
            return gather_slots(packed, sorted_idx, starts, counts, K, reverse)

        pixf = tile_pixel_centres(tile_origins(ntx, nty, tile, dev), tile)
        # Every slot order the passes composite: the main pass's (reversed
        # for a back-surface pass), the back pass's beside it, and the occ
        # pass's, always ascending, with its colours.
        gidx, g_main = gather(cfg.compose_reverse)
        g_back = gather(True)[1] if also_back else None
        g_front = g_main
        if occ_colors is not None:
            if cfg.compose_reverse:
                gidx, g_front = gather(False)
            occ_g = occ_colors[gidx]

    def untile(img_flat, ch):
        return _untile(img_flat, ch, ntx, nty, tile, H, W)

    bg = torch.as_tensor(bg_color, dtype=torch.float32, device=dev)

    def main_job(gf):
        """The main-pass composite's arguments for one gathered slot order."""
        xy = gf[..., _PACK_XY]
        conic = gf[..., _PACK_CONIC]
        opac = gf[..., _PACK_OPAC]
        depths = gf[..., _PACK_DEPTH]
        jinv = gf[..., _PACK_JINV]
        normals = gf[..., _PACK_NORMAL]
        colors = gf[..., _PACK_COLOR0:_PACK_COLOR0 + C_ch]
        if cfg.surface and cfg.perpix_depth:
            e = depth_plane_coeffs(jinv)
        else:
            e = torch.zeros_like(xy)
        parts = [colors]
        if cfg.surface:
            parts.append(normals)
        parts.append(depths[..., None])
        attrs = torch.cat(parts, dim=-1)
        return (xy, conic, opac, slot_valid, attrs, e, pixf)

    def main_out(result):
        accum, corr, t_final = result
        accum_color = accum[..., :C_ch]
        if cfg.surface:
            accum_normal = accum[..., C_ch:C_ch + 3]
        else:
            accum_normal = torch.zeros(accum.shape[:-1] + (3,), dtype=accum.dtype, device=dev)
        accum_depth = accum[..., -1] - corr
        color, normal, depth, opac_out, T = finalize_accum(
            accum_color, accum_normal, accum_depth, t_final, bg, cfg.normalize_depth
        )
        return RenderOutputs(
            color=untile(color, C_ch),
            normal=untile(normal, 3),
            depth=untile(depth[..., None], 1)[..., 0],
            opac=untile(opac_out[..., None], 1)[..., 0],
            transmittance=untile(T[..., None], 1)[..., 0],
            overflow=overflow,
        )

    jobs = [main_job(g_main)] + ([main_job(g_back)] if also_back else [])
    if occ_colors is not None:
        # Occlusion pass: back-facing splats culled, zero depth correction,
        # and xy / conic detached as the reference detaches the occ-pass
        # geometry (``diff_gaussian_rasterizer.py:281-291``); opacity and
        # the occ colors keep their gradients, as in the JAX package.
        xy, conic = g_front[..., _PACK_XY], g_front[..., _PACK_CONIC]
        front = g_front[..., _PACK_VIEW_DOT] <= -0.01
        jobs.append((xy.detach(), conic.detach(), g_front[..., _PACK_OPAC],
                     slot_valid & front, occ_g, torch.zeros_like(xy), pixf))

    # What finish reads of the front end, named here so that the closure
    # does not keep the whole preprocess output alive until it runs.
    visible = pre.valid
    occ_ch = None if occ_colors is None else occ_colors.shape[-1]

    def finish(results):
        ref_out = main_out(results[0])._replace(visible=visible)
        main_ret = (ref_out, main_out(results[1])) if also_back else ref_out
        if occ_ch is None:
            return main_ret, None
        accum_b, _, t_final_b = results[-1]
        Tb = torch.clamp_max(t_final_b, 1.0 - 1e-6)
        color_b = accum_b + Tb[..., None] * bg
        occ_out = RenderOutputs(
            color=untile(color_b, occ_ch),
            normal=ref_out.normal,
            depth=ref_out.depth,
            opac=untile((1.0 - Tb)[..., None], 1)[..., 0],
            transmittance=untile(Tb[..., None], 1)[..., 0],
        )
        return main_ret, occ_out

    consts = (cfg.alpha_clamp, cfg.alpha_min, cfg.transmittance_min)
    return Passes(jobs, consts, (ntx, nty), finish)


def composite_passes(passes: Passes, cfg: RasterConfig, rows=None) -> List[Tuple]:
    """Each of ``passes``' composite calls, in order: the kernel's wrapper
    (:func:`composite_block`) or, under ``composite="plain"``, the plain
    version in ``cfg.composite_dtype``; with ``rows``, on this rank's band
    of tile rows.  With autograd on, the passes count as a view rendered
    with autograd on (:data:`soar_tpu_torch.render.graphs.VIEWS`)."""
    if torch.is_grad_enabled():
        graphs.VIEWS.grad_view()
    if cfg.composite == "kernel":
        composite = composite_block
    else:
        cdt = torch.bfloat16 if cfg.composite_dtype == "bf16" else torch.float32

        def composite(*args):
            return composite_block_plain(*args, compute_dtype=cdt)

    if rows is not None:
        composite = _band_composite(composite, rows, *passes.grid)
    results = []
    for job in passes.jobs:
        with spans.span("soar.composite"):
            results.append(composite(*job, *passes.consts))
    return results

