"""Parity of the port's count-bounded tile composite with soar_tpu's Pallas
kernel (``composite_tiles_pallas``, run in interpret mode on the CPU as
tests/test_pallas_composite.py runs it).

On the CPU the port's wrapper runs ``composite_tiles_plain``, the dense
cumprod chain; the CUDA kernel itself is held against that plain version on
the card (tests/test_torch_port_kernels.py, chip_smoke.py).

Tolerances: 1e-4 absolute on all four outputs (the Pallas kernel's
sequential f32 product against the plain cumprod, sums of up to 16 weights
of O(1) values; the tolerance of the JAX package's own test), 1e-6 on the
crafted sticky-stop stack, whose weights are exact to a few ulps.  The two
formulations of the per-pixel depth inside the port (``depth - du·j`` per
slot here, ``accum_depth - corr`` in ``composite_block``) agree to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.render.pallas_composite import composite_tiles_pallas
from soar_tpu_torch.core.camera import camera_from_c2w, look_at_c2w
from soar_tpu_torch.render import composite as tcomp
from soar_tpu_torch.render import tiled as ttiled
from soar_tpu_torch.render import tiles_composite as ttiles
from soar_tpu_torch.render.preprocess import preprocess
from soar_tpu_torch.render.tilegrid import untile
from soar_tpu_torch.render.types import GaussianInputs, RasterConfig
from torch_port_helpers import (
    assert_close,
    make_gathered,
    make_render_scene,
    make_sticky_stack,
    t,
)

NAMES = ("color", "normal", "depth", "T")

CASES = {
    # the three fixtures of tests/test_pallas_composite.py ...
    "gathered": (lambda: make_gathered(), 1e-4),
    "sticky_stop": (make_sticky_stack, 1e-6),
    "counts": (lambda: make_gathered(seed=1, counts=[3, 0, 16, 16]), 1e-4),
    # ... further seeds, a count above K (clipped to K) and more tiles
    "seed2": (lambda: make_gathered(seed=2), 1e-4),
    "seed3_counts": (lambda: make_gathered(seed=3, counts=[1, 15, 0, 9]), 1e-4),
    "count_above_K": (lambda: make_gathered(seed=4, counts=[40, 16, 7, 100]), 1e-4),
    "nine_tiles_K24": (lambda: make_gathered(NT=9, K=24, seed=5,
                                             counts=[24, 0, 5, 24, 30, 12, 1, 24, 17]), 1e-4),
}


def _jax(data):
    return tuple(jnp.asarray(a) for a in data)


def _torch(data):
    return tuple(t(a) for a in data)


@pytest.mark.parametrize("perpix_depth", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_composite_tiles_plain_matches_jax_pallas(case, perpix_depth):
    make, atol = CASES[case]
    data = make()
    want = composite_tiles_pallas(*_jax(data), tile=16, perpix_depth=perpix_depth,
                                  interpret=True)
    got = tcomp.composite_tiles_plain(*_torch(data), tile=16, perpix_depth=perpix_depth)
    for g, w, name in zip(got, want, NAMES):
        assert tuple(g.shape) == tuple(w.shape), name
        assert_close(g, w, atol, msg=f"{case} {name}")
    counts = np.minimum(data[8], data[0].shape[1])
    empty = np.nonzero(counts == 0)[0]
    for i in empty:  # a tile with count 0: zeros and T = 1
        assert float(got[0][i].abs().max()) == 0.0 and bool((got[3][i] == 1.0).all())


def test_composite_tiles_wrapper_on_cpu():
    """A CPU tensor gets the plain version, without an autograd graph (the
    JAX kernel has no VJP) and without a kernel launch."""
    data = list(_torch(make_gathered(seed=6, counts=[16, 2, 0, 11])))
    data[2] = data[2].requires_grad_()
    before = ttiles.composite_tiles.launches
    got = ttiles.composite_tiles(*data)
    want = tcomp.composite_tiles_plain(*data)
    assert ttiles.composite_tiles.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w.detach()) and not g.requires_grad
    assert want[0].requires_grad  # the plain version itself is differentiable
    # int64 counts and origins (what the rasterizer's binning produces)
    data64 = list(data)
    data64[8], data64[9] = data[8].long(), data[9].long()
    for g, w in zip(ttiles.composite_tiles(*data64), got):
        assert torch.equal(g, w)


def _small_view(n_pts=150, seed=3):
    means, quats, scales, opac, colors = make_render_scene(n_pts, seed=seed, spread=0.35)
    g = GaussianInputs(*(t(a) for a in (means, quats, scales, opac, colors)))
    pos = torch.tensor([3.0 * np.cos(0.2) * np.sin(0.7), 3.0 * np.sin(0.2),
                        3.0 * np.cos(0.2) * np.cos(0.7)], dtype=torch.float32)
    c2w = look_at_c2w(pos, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))
    fov = float(np.deg2rad(40.0))
    return g, camera_from_c2w(c2w, fov, fov)


@pytest.mark.parametrize("K", [160, 16])
def test_tile_lists_of_a_rendered_view(K):
    """On the gathered tile lists of a small rendered scene (K=16 truncates:
    the dropped canary fires), the tile composite equals the accumulations
    of ``composite_block_plain`` on the same lists (1e-5: the same weights,
    another association of the depth's plane correction), the JAX Pallas
    kernel (1e-4), and — through ``finalize_accum`` and ``untile`` — the
    port's ``rasterize`` (1e-5)."""
    g, cam = _small_view()
    size = (64, 80)
    cfg = RasterConfig(max_per_tile=K, composite="plain")
    pre = preprocess(g, cam, size, cfg)
    lists, (ntx, nty), overflow = ttiled.gather_tile_lists(pre, size, cfg)
    xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts, origins = lists
    assert xy.shape == (ntx * nty, K, 2) and int(counts.max()) > 16
    assert (int(overflow[0]) > 0) == (K == 16)
    got = ttiles.composite_tiles(*lists, tile=cfg.tile)

    want_jax = composite_tiles_pallas(
        *(jnp.asarray(a.numpy()) for a in lists), tile=cfg.tile, interpret=True)
    for a, b, name in zip(got, want_jax, NAMES):
        assert_close(a, b, 1e-4, msg=f"vs pallas: {name}")

    e = tcomp.depth_plane_coeffs(jinv)
    attrs = torch.cat([colors, normals, depths[..., None]], -1)
    pixf = tcomp.tile_pixel_centres(origins, cfg.tile)
    accum, corr, T = tcomp.composite_block_plain(xy, conic, opac, slot_valid, attrs, e, pixf)
    assert_close(got[0], accum[..., 0:3], 1e-5, msg="color")
    assert_close(got[1], accum[..., 3:6], 1e-5, msg="normal")
    assert_close(got[2], accum[..., 6] - corr, 1e-5, msg="depth")
    assert_close(got[3], T, 1e-5, msg="T")

    bg = torch.tensor([0.1, 0.2, 0.3])
    out = ttiled.rasterize(g, cam, size, bg, cfg)
    color, normal, depth, opac_img, _ = tcomp.finalize_accum(*got, bg, cfg.normalize_depth)
    H, W = size
    assert_close(untile(color, 3, ntx, nty, cfg.tile, H, W), out.color, 1e-5, msg="image")
    assert_close(untile(normal, 3, ntx, nty, cfg.tile, H, W), out.normal, 1e-5, msg="normal")
    assert_close(untile(opac_img[..., None], 1, ntx, nty, cfg.tile, H, W)[..., 0], out.opac,
                 1e-5, msg="opac")
    m = out.opac > 0.5
    assert float(m.float().mean()) > 0.05
    d_img = untile(depth[..., None], 1, ntx, nty, cfg.tile, H, W)[..., 0]
    assert_close(d_img[m], out.depth[m], 1e-4, msg="depth image inside the mask")


# ------------------------------------------------- the kernel's launch arguments


@pytest.mark.parametrize("reverse", [False, True])
def test_launch_args_take_the_gathered_views_without_a_copy(reverse):
    """``gather_tile_lists`` hands out column views of one packed
    [NT, K, 24] gather (3 colour channels); the kernel reads them through
    their own strides, so no input is copied: the pointers handed over are
    the views' own, and so are the strides (24 between slots)."""
    g, cam = _small_view()
    size = (64, 80)
    cfg = RasterConfig(max_per_tile=32, composite="plain")
    lists, (ntx, nty), _ = ttiled.gather_tile_lists(preprocess(g, cam, size, cfg), size, cfg,
                                                    reverse=reverse)
    a = ttiles.launch_args(*lists, tile=cfg.tile)
    assert a.copied == ()
    assert a.pointers == tuple(x.data_ptr() for x in lists)
    assert (a.NT, a.K, a.P) == (ntx * nty, 32, 256)
    floats = lists[:7]
    assert a.strides == tuple(s for x in floats for s in x.stride()[:2])
    assert a.strides == (32 * 24, 24) * 7  # every list strides by the packed row
    assert all(x.stride()[2:] in ((), (1,)) for x in floats)
    assert a.counts_i64 and a.origins_i64  # the binning's int64, read as they are
    assert a.tensors[7].dtype == torch.uint8


def _contiguous_lists(NT=3, K=8):
    data = make_gathered(NT=NT, K=K, seed=7, counts=[8, 3, 0])
    return [t(x) for x in data]


# One input of each kind that the kernel cannot read as it is, and how.
def _stride_2(x):
    return torch.stack([x, torch.zeros_like(x)], -1)[..., 0]


def _planar(x):  # [W, NT, K] storage: stride NT*K over W
    return x.permute(2, 0, 1).contiguous().permute(1, 2, 0)


RESTRIDED = {
    "xy": _stride_2,
    "conic": _planar,
    "colors": _stride_2,
    "normals": _planar,
    "jinv": _stride_2,
    "slot_valid": lambda x: x.t().contiguous().t(),
    "counts": lambda x: x.to(torch.int16),
    "tile_origins": lambda x: x.t().contiguous().t(),
}
ARG_NAMES = ("xy", "conic", "opac", "colors", "normals", "depths", "jinv", "slot_valid",
             "counts", "tile_origins")


@pytest.mark.parametrize("name", sorted(RESTRIDED))
def test_launch_args_copy_only_the_input_the_kernel_cannot_read(name):
    """An [NT, K, W] list without unit stride over W (or a non-contiguous
    mask, origins, or counts of another integer type) is copied, and only
    that input; an [NT, K] list with any slot stride is taken as it is."""
    data = _contiguous_lists()
    i = ARG_NAMES.index(name)
    data[i] = RESTRIDED[name](data[i])
    if name in ("xy", "conic", "colors", "normals", "jinv"):
        assert data[i].stride(2) != 1
    else:
        assert not data[i].is_contiguous() or data[i].dtype == torch.int16
    # the [NT, K] lists as columns of a wider array: read through their strides
    wide = torch.stack([data[2], data[5], data[5]], -1)
    data[2], data[5] = wide[..., 0], wide[..., 1]
    a = ttiles.launch_args(*data, tile=16)
    assert a.copied == (name,)
    for j, (x, p) in enumerate(zip(data, a.pointers)):
        assert (p == x.data_ptr()) == (j != i), ARG_NAMES[j]
    assert torch.equal(a.tensors[i].to(data[i].dtype if name != "slot_valid" else torch.uint8),
                       data[i] if name != "slot_valid" else data[i].to(torch.uint8))
    assert a.strides[4:6] == a.strides[10:12] == (8 * 3, 3)
    assert a.tensors[8].dtype in (torch.int32, torch.int64)
    # The wrapper's plain version on these inputs is the contiguous inputs'.
    want = tcomp.composite_tiles_plain(*_contiguous_lists())
    for g_, w in zip(ttiles.composite_tiles(*data), want):
        assert torch.equal(g_, w)


@pytest.mark.parametrize("K", [96, 64])
def test_tiles_smem_footprint_admits_render_shapes_and_refuses_one_slot_more(K):
    """``launch_args`` holds the kernel's shared memory (one 20-float record
    a slot, K rounded up to whole groups of 8 slots, ``tiles_smem_bytes``)
    against the opt-in limit before any launch: the render's K=96 and the
    training step's K=64 pass, the largest K that fits passes, one slot more
    raises ValueError."""
    from soar_tpu_torch.render.block_composite import SMEM_OPTIN

    def args(K):
        shapes = [(1, K, 2), (1, K, 3), (1, K), (1, K, 3), (1, K, 3), (1, K), (1, K, 10)]
        floats = [torch.zeros(s) for s in shapes]
        return ttiles.launch_args(*floats, torch.ones(1, K, dtype=torch.bool),
                                  torch.tensor([K]), torch.zeros(1, 2, dtype=torch.int64))

    assert ttiles.tiles_smem_bytes(K) == 80 * K
    assert ttiles.tiles_smem_bytes(K - 7) == 80 * K  # whole groups of 8 slots
    assert args(K).K == K
    largest = SMEM_OPTIN // ttiles.tiles_smem_bytes(8) * 8
    assert args(largest).K == largest == 2904
    with pytest.raises(ValueError, match="shared memory"):
        args(largest + 1)
