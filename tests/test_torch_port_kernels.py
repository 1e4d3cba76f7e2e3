"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor soar_tpu, so it also runs where only the
port is installed.  On a machine with a GPU:

    python -m pytest tests/test_torch_port_kernels.py --noconftest -q

(``--noconftest``: the suite's conftest imports JAX.)  Without a GPU the
kernel tests skip — a CUDA kernel has no CPU mode — and the rest run.
"""

import numpy as np
import pytest
import torch

from soar_tpu_torch import kernels, resolve_device
from soar_tpu_torch.body.model import make_test_body
from soar_tpu_torch.render import block_composite as tbc
from soar_tpu_torch.render import composite as tcomp
from soar_tpu_torch.render import tiles_composite as ttiles
from torch_port_helpers import (
    assert_close_share,
    make_gathered,
    make_scene,
    make_sticky_stack,
    t,
)


def test_entry_points_default_to_cuda_and_never_fall_back():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert make_test_body(num_joints=2, segments_per_bone=1, ring=4).faces.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_test_body(num_joints=2, segments_per_bone=1, ring=4)
    assert resolve_device("cpu").type == "cpu"


def test_kernel_library_named_by_source_hash(monkeypatch):
    for name, (src, argtypes) in kernels.SOURCES.items():
        path = kernels.library_path(name)
        assert path.parent == kernels.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert path == kernels.library_path(name)
        assert (kernels.BUILD_DIR.parent / src).exists()
        # forward: 5 pointers, 4 ints, 3 floats, the stream; backward: one
        # pointer more (three cotangents in, gfeat out); the tile-list walk:
        # 10 inputs and 4 outputs, the float lists' strides, 6 ints, 3
        # floats, the stream; the hash encoding: 6 pointers (forward's and
        # backward's), 5 ints, the stream; the preprocess: the launch
        # structure, 2 ints, the stream.
        assert len(argtypes) == {"composite_fwd": 13, "composite_bwd": 14,
                                 "composite_tiles": 25, "hash_encode": 12,
                                 "preprocess": 4}[name]
        # Other nvcc flags name another library: a stale build is not reused.
        monkeypatch.setattr(kernels, "NVCC_FLAGS", [*kernels.NVCC_FLAGS, "-lineinfo"])
        assert kernels.library_path(name) != path
        monkeypatch.undo()


@pytest.mark.cuda
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("C", [7, 4, 3])
def test_composite_kernel_matches_plain_on_cuda(saturate, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = make_scene(NT=64, K=96, C=C, seed=7, saturate=saturate)
    cuda = [t(a).cuda() for a in scene]
    before = tbc.composite_block.launches
    got = tbc.composite_block(*cuda)
    torch.cuda.synchronize()
    assert tbc.composite_block.launches == before + 1
    want = tcomp.composite_block_plain(*cuda)
    # Sequential product in the kernel vs cumprod in the plain version:
    # 1e-5, with 1% of pixels allowed a T-cutoff flip.
    for g, w, name in zip(got, want, ("accum", "corr", "T")):
        assert_close_share(g, w, 1e-5, 0.01, msg=name)
    # A CUDA input that requires grad: autograd reaches the backward kernel,
    # once, and its gradient is the plain backward's.
    xy = cuda[0].clone().requires_grad_()
    before_fwd, before_bwd = tbc.composite_block.launches, tbc.composite_block.bwd_launches
    accum, corr, T = tbc.composite_block(xy, *cuda[1:])
    (accum.sum() + corr.sum() + T.sum()).backward()
    torch.cuda.synchronize()
    assert tbc.composite_block.launches == before_fwd + 1
    assert tbc.composite_block.bwd_launches == before_bwd + 1
    ones = (torch.ones_like(accum.transpose(1, 2)), torch.ones_like(corr), torch.ones_like(T))
    want_xy = tcomp.composite_block_bwd_plain(*cuda, *ones)[..., 0:2]
    scale = float(want_xy.abs().max())
    assert_close_share(xy.grad, want_xy, 1e-4 * scale, 0.01, msg="d/dxy")
    # Non-constant opacities (0.2-0.9, or 0.9-1.0 saturating), as the
    # GaussianDreamer step composites them at C = 4: their gradient is the
    # plain backward's too.
    opac = cuda[2].clone().requires_grad_()
    accum, corr, T = tbc.composite_block(cuda[0], cuda[1], opac, *cuda[3:])
    (accum.sum() + corr.sum() + T.sum()).backward()
    want_o = tcomp.composite_block_bwd_plain(*cuda, *ones)[..., 5]
    scale = float(want_o.abs().max())
    assert scale > 0
    assert_close_share(opac.grad, want_o, 1e-4 * scale, 0.01, msg="d/dopacity")


@pytest.mark.cuda
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("C", [7, 4, 3])
def test_composite_bwd_kernel_matches_plain_on_cuda(saturate, C):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = [t(a).cuda() for a in make_scene(NT=64, K=64, C=C, seed=8, saturate=saturate)]
    g = torch.Generator().manual_seed(9)
    cots = [torch.randn(s, generator=g).cuda() for s in ((64, C, 256), (64, 256), (64, 256))]
    before = tbc.composite_block.bwd_launches
    got = tbc.composite_block_bwd(*scene, *cots)
    torch.cuda.synchronize()
    assert tbc.composite_block.bwd_launches == before + 1
    want = tcomp.composite_block_bwd_plain(*scene, *cots)
    assert bool((got[..., 6] == 0).all())
    # The opacity column (5) carries the random cotangents' gradient.
    assert float(want[..., 5].abs().max()) > 0
    # Per column, relative to the column's largest magnitude: the kernel's
    # S_k = G - P_k cancels to ~1 ulp of G over 1 - alpha >= 0.01.  At most
    # 0.1% of the entries beyond 1e-4 (a pixel whose stop slot flips moves
    # one slot's sum), and none beyond 1e-2, so no wrong slot hides there.
    for col in range(9 + C):
        scale = float(want[..., col].abs().max())
        assert_close_share(got[..., col], want[..., col], 1e-4 * scale, 1e-3, msg=f"col {col}")
        assert_close_share(got[..., col], want[..., col], 1e-2 * scale, 0.0, msg=f"col {col}")


def _kernels_vs_plain(scene, seed, bwd=True):
    """Both composite kernels (the forward alone without ``bwd``) on
    ``scene`` (CUDA tensors) against their plain versions, with the
    tolerances of the tests above; two backward launches must be
    bit-equal.  Returns the kernels' outputs."""
    NT, P, C = scene[0].shape[0], scene[6].shape[1], scene[4].shape[2]
    got = tbc.composite_block(*scene)
    want = tcomp.composite_block_plain(*scene)
    for g, w, name in zip(got, want, ("accum", "corr", "T")):
        assert_close_share(g, w, 1e-5, 0.01, msg=name)
    if not bwd:
        return got, None
    g = torch.Generator().manual_seed(seed)
    cots = [torch.randn(s, generator=g).cuda() for s in ((NT, C, P), (NT, P), (NT, P))]
    gfeat = tbc.composite_block_bwd(*scene, *cots)
    torch.cuda.synchronize()
    assert torch.equal(tbc.composite_block_bwd(*scene, *cots), gfeat)
    want_g = tcomp.composite_block_bwd_plain(*scene, *cots)
    assert bool((gfeat[..., 6] == 0).all())
    for col in range(9 + C):
        scale = float(want_g[..., col].abs().max())
        assert_close_share(gfeat[..., col], want_g[..., col], 1e-4 * scale, 1e-3, msg=f"col {col}")
        assert_close_share(gfeat[..., col], want_g[..., col], 1e-2 * scale, 0.0, msg=f"col {col}")
    return got, gfeat


def _largest_K(smem_bytes, C, P):
    K = 1
    while smem_bytes(K + 1, C, P) <= tbc.SMEM_OPTIN:
        K += 1
    return K


def _edge_scene(case):
    """A scene (numpy) for one edge of the kernels' per-tile slot bound,
    warp walks and shared-memory layout."""
    C = {"C=1": 1, "C=16": 16}.get(case, 7)
    K = 64
    if case == "fwd_K_at_smem_limit":
        K = _largest_K(tbc.fwd_smem_bytes, C, 256)
    elif case == "bwd_K_at_smem_limit":
        K = _largest_K(tbc.bwd_smem_bytes, C, 256)
    NT = 2 if "limit" in case else 8
    xy, conic, opac, valid, attrs, e, pixf = make_scene(NT=NT, K=K, C=C, seed=21)
    k = np.arange(K)[None]
    if case == "empty_tiles":
        valid[::2] = False
    elif case == "non_prefix_mask":  # as slot_valid & front from the occlusion pass
        valid &= (k % 3 == 0) & (k < K - 5)
    elif case == "last_valid_slot_0":
        valid[:] = k == 0
    elif case == "last_valid_slot_K-1":
        valid &= (k % 7 == 0) | (k == K - 1)
        valid[:, K - 1] = True
    elif case == "P=100":
        pixf = pixf[:, :100]
    return xy, conic, opac, valid, attrs, e, pixf


EDGE_CASES = ["empty_tiles", "non_prefix_mask", "last_valid_slot_0", "last_valid_slot_K-1",
              "P=100", "C=1", "C=16", "fwd_K_at_smem_limit", "bwd_K_at_smem_limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", EDGE_CASES)
def test_composite_kernels_edge_cases_on_cuda(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    scene = [t(a).cuda() for a in _edge_scene(case)]
    # The forward's limit is far beyond the backward's (no partial sums).
    (accum, corr, T), gfeat = _kernels_vs_plain(scene, seed=22,
                                                bwd=case != "fwd_K_at_smem_limit")
    if case == "empty_tiles":  # a tile with no valid slot leaves at once
        assert bool((accum[::2] == 0).all()) and bool((corr[::2] == 0).all())
        assert bool((T[::2] == 1).all()) and bool((gfeat[::2] == 0).all())
    if case == "fwd_K_at_smem_limit":  # one slot more is refused before launch
        feat = tbc._pack(*scene[:6])
        K = feat.shape[1]
        more = torch.cat([feat, feat[:, :1]], 1)
        with pytest.raises(ValueError, match="shared memory"):
            tbc._launch_fwd(more, scene[6], 0.99, 1 / 255, 1e-4)
        assert K == _largest_K(tbc.fwd_smem_bytes, 7, 256)


# (K, C) of the main path's composites at P = 256: the turntable's main
# and occlusion passes (K = 96), the training step's (K = 64).
MAIN_PATH_SHAPES = [(96, 7), (96, 3), (64, 7), (64, 3)]


@pytest.mark.parametrize("P", [256, 100])
@pytest.mark.parametrize("C", [1, 3, 7, 16])
@pytest.mark.parametrize("kernel", ["composite_fwd", "composite_bwd"])
def test_smem_footprint_admits_main_path_and_refuses_one_slot_more(kernel, C, P):
    """The wrapper's footprint check, per kernel: the main path's shapes
    pass, the largest K that fits passes, one slot more raises ValueError
    (before any launch, so this runs on CPU tensors)."""
    smem = tbc.fwd_smem_bytes if kernel == "composite_fwd" else tbc.bwd_smem_bytes

    def check(K, C, P):
        return tbc._check(torch.zeros(1, K, 9 + C), torch.zeros(1, P, 2), smem, kernel)

    for K, C_path in MAIN_PATH_SHAPES:
        assert check(K, C_path, 256) == (1, K, C_path, 256)
    K = _largest_K(smem, C, P)
    assert check(K, C, P) == (1, K, C, P)
    with pytest.raises(ValueError, match="shared memory"):
        check(K + 1, C, P)
    # The bytes the C entry points ask for: rows padded to 4 floats and a
    # few ints; the backward adds every warp's partial sums of 8 + C
    # gradients per slot (30,720 B at the step's K=64, C=7, 8 warps).
    if kernel == "composite_fwd":
        assert smem(64, 7, 256) == 4 * (64 * 16 + 8)
    else:
        assert smem(64, 7, 256) == 4 * 64 * 16 + 30_720 + 64
        assert smem(96, 16, 256) == 4 * 96 * 28 + 4 * 8 * 96 * 24 + 64


TILE_FIXTURES = {
    # the three fixtures of tests/test_pallas_composite.py
    "gathered": lambda: make_gathered(),
    "sticky_stop": make_sticky_stack,
    "counts": lambda: make_gathered(seed=1, counts=[3, 0, 16, 16]),
    "count_above_K": lambda: make_gathered(seed=4, counts=[40, 16, 7, 100]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("perpix_depth", [True, False])
@pytest.mark.parametrize("fixture", sorted(TILE_FIXTURES))
def test_composite_tiles_kernel_matches_plain_on_cuda(fixture, perpix_depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    data = [t(a).cuda() for a in TILE_FIXTURES[fixture]()]
    before = ttiles.composite_tiles.launches
    got = ttiles.composite_tiles(*data, perpix_depth=perpix_depth)
    torch.cuda.synchronize()
    assert ttiles.composite_tiles.launches == before + 1
    want = tcomp.composite_tiles_plain(*data, perpix_depth=perpix_depth)
    # The same f32 arithmetic, the kernel's sequential product against the
    # plain cumprod: 1e-5 (1e-6 on the crafted sticky-stop stack), no flips
    # at these few pixels.
    atol = 1e-6 if fixture == "sticky_stop" else 1e-5
    for g, w, name in zip(got, want, ("color", "normal", "depth", "T")):
        assert g.shape == w.shape and not g.requires_grad
        assert_close_share(g, w, atol, 0.0, msg=name)


@pytest.mark.cuda
def test_composite_tiles_kernel_at_render_shapes_on_cuda():
    """NT=1024, K=96 with random per-tile counts (some above K) and int64
    counts and origins, as the rasterizer's binning hands them over."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import numpy as np

    NT, K = 1024, 96
    counts = np.random.RandomState(11).randint(0, K + 20, NT)
    data = [t(a).cuda() for a in make_gathered(NT=NT, K=K, seed=10, counts=counts)]
    data[8], data[9] = data[8].long(), data[9].long()
    got = ttiles.composite_tiles(*data)
    torch.cuda.synchronize()
    want = tcomp.composite_tiles_plain(*data)
    # 1% of the pixels may take another stop slot at the T < 1e-4 cutoff.
    for g, w, name in zip(got, want, ("color", "normal", "depth", "T")):
        assert_close_share(g, w, 1e-4, 0.01, msg=name)
    empty = data[8] == 0
    assert bool(empty.any())
    assert bool((got[3][empty] == 1.0).all()) and bool((got[0][empty] == 0.0).all())
    # A CPU tensor beside CUDA tensors is refused, not moved.
    with pytest.raises(ValueError, match="one device"):
        ttiles.composite_tiles(*data[:8], data[8].cpu(), data[9])


def _packed_views(data):
    """The tile lists as column views of one packed [NT, K, 24] array in
    the layout of ``render/tiled.py::pack_surfels`` (xy 0:2, conic 2:5,
    opacity 5, depth 6, view_dot 7, jinv 8:18, normal 18:21, colour 21:24),
    as ``gather_tile_lists`` hands them over."""
    xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts, origins = data
    packed = torch.cat([xy, conic, opac[..., None], depths[..., None],
                        torch.zeros_like(opac)[..., None], jinv, normals, colors], -1)
    return (packed[..., 0:2], packed[..., 2:5], packed[..., 5], packed[..., 21:24],
            packed[..., 18:21], packed[..., 6], packed[..., 8:18], slot_valid, counts, origins)


TILES_EDGE_CASES = ["packed_views", "int32", "int64", "counts_out_of_range",
                    "non_prefix_valid", "count_0", "tile_10", "K=61", "K_at_smem_limit"]


def _tiles_edge_lists(case):
    """CUDA tile lists (NT=64, K=96 unless the case says otherwise) for one
    edge of the tile kernel's strided reads, integer types, slot bound,
    pixel split and shared-memory records (whole groups of 8 slots)."""
    NT, K = 64, 96
    if case == "K=61":
        K = 61
    elif case == "K_at_smem_limit":
        NT, K = 4, tbc.SMEM_OPTIN // ttiles.tiles_smem_bytes(8) * 8
    tile = 10 if case == "tile_10" else 16
    rng = np.random.RandomState(31)
    counts = rng.randint(0, K + 1, NT)
    if case == "counts_out_of_range":
        counts[::3] = K + rng.randint(1, 1000, len(counts[::3]))
        counts[1::3] = -rng.randint(1, 1000, len(counts[1::3]))
    if case == "count_0":
        counts[::2] = 0
    data = [t(a).cuda() for a in make_gathered(NT=NT, K=K, tile=tile, seed=32, counts=counts)]
    k = torch.arange(K, device="cuda")[None]
    if case == "non_prefix_valid":  # as slot_valid & front from the occlusion pass
        data[7] &= (k % 3 == 0) & (k < K - 5)
    if case == "count_0":  # a tile with a count but no valid slot below it
        data[7][1] = False
    if case in ("packed_views", "int64", "counts_out_of_range"):
        data[8], data[9] = data[8].long(), data[9].long()
    if case == "packed_views":
        data = list(_packed_views(data))
    return data, tile


@pytest.mark.cuda
@pytest.mark.parametrize("perpix_depth", [True, False])
@pytest.mark.parametrize("case", TILES_EDGE_CASES)
def test_composite_tiles_kernel_edge_cases_on_cuda(case, perpix_depth):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    data, tile = _tiles_edge_lists(case)
    if case == "packed_views":  # read through the views' strides, not copied
        assert ttiles.launch_args(*data, tile=tile).copied == ()
    before = ttiles.composite_tiles.launches
    got = ttiles.composite_tiles(*data, tile=tile, perpix_depth=perpix_depth)
    again = ttiles.composite_tiles(*data, tile=tile, perpix_depth=perpix_depth)
    torch.cuda.synchronize()
    assert ttiles.composite_tiles.launches == before + 2
    for g, g2 in zip(got, again):  # two launches bit-equal
        assert torch.equal(g, g2)
    want = tcomp.composite_tiles_plain(*data, tile=tile, perpix_depth=perpix_depth)
    # As at the render's shapes: 1e-5, with 1% of the elements allowed a
    # T-cutoff flip, and none beyond 1e-2.
    NT = data[0].shape[0]
    for g, w, name in zip(got, want, ("color", "normal", "depth", "T")):
        assert g.shape == w.shape == (NT, tile * tile, 3)[:w.dim()]
        assert_close_share(g, w, 1e-5, 0.01, msg=f"{case} {name}")
        assert_close_share(g, w, 1e-2, 0.0, msg=f"{case} {name}")
    K = data[0].shape[1]
    k = torch.arange(K, device="cuda")[None]
    empty = ~(data[7] & (k < data[8][:, None])).any(1)  # no valid slot below the count
    if case == "count_0":
        assert bool(empty[::2].all()) and bool(empty[1])
    assert bool((got[3][empty] == 1).all()) and bool((got[0][empty] == 0).all())
    assert bool((got[2][empty] == 0).all()) and bool((got[1][empty] == 0).all())


def test_plain_backward_matches_finite_differences():
    """The plain backward (the kernel's oracle) against central finite
    differences in float64, at a tiny size where no pixel sits at a mask
    threshold within the step."""
    xy, conic, opac, valid, attrs, e, pixf = (
        t(a) for a in make_scene(NT=2, K=6, C=2, seed=4))
    pixf = pixf[:, ::37]  # 7 pixels a tile
    f64 = [a.double() for a in (xy, conic, opac, attrs, e)]

    def fn(xy_, conic_, opac_, attrs_, e_):
        return tcomp.composite_block_plain(xy_, conic_, opac_, valid, attrs_, e_,
                                           pixf.double())

    assert torch.autograd.gradcheck(fn, [a.requires_grad_() for a in f64], eps=1e-6,
                                    atol=1e-7, rtol=1e-5)
    g = torch.Generator().manual_seed(1)
    outs = fn(*f64)
    cots = [torch.randn(o.shape, generator=g, dtype=torch.float64) for o in outs]
    grads = torch.autograd.grad(outs, f64, cots)
    packed = tcomp.composite_block_bwd_plain(
        *(a.detach() for a in f64[:3]), valid, f64[3].detach(), f64[4].detach(),
        pixf.double(), cots[0].transpose(1, 2), cots[1], cots[2])
    want = torch.cat([grads[0], grads[1], grads[2][..., None],
                      torch.zeros_like(grads[2])[..., None], grads[4], grads[3]], -1)
    assert torch.equal(packed, want)
