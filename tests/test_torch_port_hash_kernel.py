"""The hash encoding's CUDA kernel (``csrc/hash_encode.cu``) against the
plain PyTorch version and against ``soar_tpu``'s encodings recorded on the
CPU, and which calls it takes.

This file imports neither JAX nor soar_tpu, so it also runs where only the
port is installed.  On a machine with a GPU:

    python -m pytest tests/test_torch_port_hash_kernel.py --noconftest -q

Without a GPU the ``cuda`` tests skip (a CUDA kernel has no CPU mode) and
the rest run: the plain path's counter, which calls the kernel refuses,
its launch arguments, and a plain-torch model of the kernel's backward held
against autograd of the plain version.  ``tests/data/hash_encode_jax.npz``
holds soar_tpu's forward and table gradient on the cases of
``torch_port_helpers.hash_jax_case``; ``test_torch_port_field.py`` checks
them against soar_tpu on the CPU.
"""

import numpy as np
import pytest
import torch

from soar_tpu_torch.field import hashgrid as thg
from soar_tpu_torch.field.attribute_field import (
    AttributeField,
    AttributeFieldConfig,
    attribute_field_apply,
)
from torch_port_helpers import (
    HASH_JAX_CASES,
    HASH_JAX_FILE,
    assert_table_grad_close,
    hash_jax_case,
)

SMALL = dict(num_levels=6, min_res=16, max_res=2048, log2_hashmap_size=12)
PUBLISHED = dict(num_levels=16, min_res=16, max_res=2048, log2_hashmap_size=18)


def _counts():
    """The kernel's forward and backward launches and the plain calls."""
    return thg.hash_encode.kernel, thg.hash_encode.kernel_bwd, thg.hash_encode.eager


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _table(cfg, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.num_levels, cfg.table_size, cfg.row_width)
    return (2.0 * torch.rand(shape, generator=g) - 1.0).to(device)


def _positions(n, seed, device="cpu"):
    """``n`` positions in [0, 1]^3 with the edge cases among them: the
    corner 0, the corner 1, points on a face, and points from outside the
    box, which ``normalize_positions`` sets to 0."""
    g = torch.Generator().manual_seed(seed)
    p = torch.rand((n, 3), generator=g)
    p[0], p[1], p[2, 0], p[3, 1] = 0.0, 1.0, 1.0, 0.0
    outside = 1.6 * torch.rand((8, 3), generator=g) - 0.3
    aabb = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    p[4:12] = thg.normalize_positions(outside, aabb)[0]
    return p.to(device)


# --------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("mode", ["cell", "corner"])
def test_cpu_calls_take_the_plain_path_and_count_it(mode):
    cfg = thg.HashGridConfig(**SMALL, mode=mode)
    table, pos = _table(cfg, 0), _positions(300, 1)
    before = _counts()
    got = thg.hash_encode(table, pos, cfg)
    assert _counts() == (before[0], before[1], before[2] + 1)
    assert torch.equal(got, thg.hash_encode_plain(table, pos, cfg))


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_positions_that_need_a_gradient_take_the_plain_path(device):
    """On the CPU the plain path differentiates them; on the card the
    kernel (which gives positions no gradient) refuses the call."""
    if device == "cuda":
        _cuda()
    cfg = thg.HashGridConfig(**SMALL)
    table = _table(cfg, 2, device).requires_grad_()
    pos = (_positions(200, 3, device) * 0.98 + 0.01).requires_grad_()
    before = _counts()
    if device == "cuda":
        with pytest.raises(NotImplementedError, match="positions that need a gradient"):
            thg.hash_encode(table, pos, cfg)
        assert _counts() == before
        return
    out = thg.hash_encode(table, pos, cfg)
    assert _counts() == (before[0], before[1], before[2] + 1)
    out.square().sum().backward()
    assert pos.grad is not None and float(pos.grad.abs().max()) > 0
    assert table.grad is not None


def test_which_calls_may_launch_the_kernel():
    """What a CUDA call's tensors must be (checked here on CPU tensors):
    float32, rows on 16 bytes, positions that need no gradient under
    autograd."""
    cfg = thg.HashGridConfig(**SMALL)
    table, pos = _table(cfg, 4), _positions(16, 5)
    assert thg.refusal(table, pos) is None
    grad_pos = pos.clone().requires_grad_()
    assert "gradient" in thg.refusal(table, grad_pos)
    with torch.no_grad():
        assert thg.refusal(table, grad_pos) is None
    assert "float32" in thg.refusal(table, pos.double())
    assert "float32" in thg.refusal(table.to(torch.bfloat16), pos)
    assert "16 bytes" in thg.refusal(table.reshape(-1)[1:], pos)


@pytest.mark.parametrize("kw,want", [
    (dict(), (1000, 16, 18, 0, 1)),
    (dict(mode="corner"), (1000, 16, 18, 1, 1)),
    (dict(dtype="float32", log2_hashmap_size=12), (1000, 16, 12, 0, 0)),
    (dict(dtype="float16"), "gather dtype float16"),
    (dict(features_per_level=4), "4 features a level"),
    (dict(mode="dense"), "mode 'dense'"),
])
def test_launch_args(kw, want):
    cfg = thg.HashGridConfig(**kw)
    if isinstance(want, str):
        with pytest.raises(NotImplementedError, match=want):
            thg.launch_args(1000, cfg)
    else:
        assert thg.launch_args(1000, cfg) == want


def test_launch_args_refuse_outputs_past_32_bit_indices():
    cfg = thg.HashGridConfig()
    n = 2**31 // (cfg.num_levels * cfg.features_per_level)
    assert thg.launch_args(n - 1, cfg)[0] == n - 1
    with pytest.raises(NotImplementedError, match="32 bits"):
        thg.launch_args(n, cfg)


def table_grad_model(grad_out, positions, cfg):
    """The kernel's backward in plain torch: every (point, level, corner,
    feature) cotangent ``go * w`` rounded to the gather dtype, the float32
    sum of each entry's cotangents, and that sum rounded to the gather
    dtype once."""
    L, F = cfg.num_levels, cfg.features_per_level
    gdtype = getattr(torch, cfg.dtype)
    flat_idx, cw = thg._lookup(positions.reshape(-1, 3), cfg)
    go = grad_out.reshape(-1, L, 1, F)
    contrib = (go * cw[..., None]).to(gdtype).to(torch.float32)  # [N, L, 8, F]
    flat = torch.zeros(L * cfg.table_size, cfg.row_width, device=grad_out.device)
    flat.index_add_(0, flat_idx, contrib.reshape(flat_idx.shape[0], cfg.row_width))
    return flat.to(gdtype).to(torch.float32).reshape(L, cfg.table_size, cfg.row_width)


def _plain_table_grad(table, pos, grad_out, cfg):
    table = table.detach().clone().requires_grad_()
    thg.hash_encode_plain(table, pos, cfg).backward(grad_out)
    return table.grad


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["cell", "corner"])
def test_backward_model_matches_plain_autograd_on_cpu(mode, dtype):
    """On the CPU, index_put adds a bf16 gradient in bf16 one cotangent at a
    time, where CUDA's sums each entry's run in float32 and rounds once
    (which the model does).  The two orders agree exactly while no entry
    takes more than two cotangents, so the bf16 case draws few uniform
    points on large tables and checks that; float32 adds in float32 either
    way and is checked on a crowded table (the edge cases pile points at 0),
    to float32 round-off."""
    if dtype == "bfloat16":
        cfg = thg.HashGridConfig(num_levels=4, min_res=64, max_res=512, log2_hashmap_size=16,
                                 mode=mode, dtype=dtype)
        n = 48
        pos = torch.rand((n, 3), generator=torch.Generator().manual_seed(7))
    else:
        cfg = thg.HashGridConfig(**SMALL, mode=mode, dtype=dtype)
        n = 3000
        pos = _positions(n, 7)
    table = _table(cfg, 6)
    grad_out = torch.randn((n, cfg.out_dim), generator=torch.Generator().manual_seed(8))
    want = _plain_table_grad(table, pos, grad_out, cfg)
    got = table_grad_model(grad_out, pos, cfg)
    flat_idx, _ = thg._lookup(pos, cfg)
    hits = torch.bincount(flat_idx).max()
    if dtype == "bfloat16":
        assert hits <= 2, hits
        assert torch.equal(got, want)
    else:
        assert hits > 5
        scale = _plain_table_grad(table, pos, grad_out.abs(), cfg)
        assert torch.all((got - want).abs() <= 2.0**-20 * scale)
        assert float(got.abs().max()) > 0


# --------------------------------------------------------------- on the card


def _kernel_call(table, pos, cfg):
    before = thg.hash_encode.kernel
    out = thg.hash_encode(table, pos, cfg)
    assert thg.hash_encode.kernel == before + 1
    return out


def _bf16_ulp(x):
    """One bf16 ulp at |x| (0 where x is 0)."""
    _, e = torch.frexp(x)
    return torch.where(x != 0, torch.ldexp(torch.ones_like(x), e - 8), torch.zeros_like(x))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1001, 125_664])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["cell", "corner"])
def test_kernel_forward_matches_plain(mode, dtype, n):
    """Equal to float32 round-off of the 8-term sum; N not a multiple of the
    block; the small grid and the published one."""
    dev = _cuda()
    cfg = thg.HashGridConfig(**(PUBLISHED if n > 100_000 else SMALL), mode=mode, dtype=dtype)
    table, pos = _table(cfg, 10, dev), _positions(n, 11, dev)
    got = _kernel_call(table, pos, cfg)
    want = thg.hash_encode_plain(table, pos, cfg)
    assert got.shape == want.shape == (n, cfg.out_dim) and got.dtype == torch.float32
    err = float((got - want).abs().max())
    assert err <= 2e-6, err
    # Three dimensions in front: the output keeps them.
    pos3 = pos[:1000].reshape(10, 25, 4, 3)
    assert torch.equal(_kernel_call(table, pos3, cfg), got[:1000].reshape(10, 25, 4, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,dtype", HASH_JAX_CASES)
def test_kernel_matches_soar_tpu_recorded_on_the_cpu(mode, dtype):
    """The kernel's encoding (to float32 round-off of the 8-term sum) and
    table gradient (to one bf16 ulp and float32 round-off of each entry)
    against soar_tpu's, as ``tests/data/hash_encode_jax.npz`` records them."""
    dev = _cuda()
    grid, table, pos, cot = hash_jax_case(mode, dtype)
    rec = np.load(HASH_JAX_FILE)
    key = f"{mode}_{dtype}_"
    leaf = torch.from_numpy(table).to(dev).requires_grad_()
    got = _kernel_call(leaf, torch.from_numpy(pos).to(dev), thg.HashGridConfig(**grid))
    err = float((got.detach().cpu() - torch.from_numpy(rec[key + "fwd"])).abs().max())
    assert err <= 1e-6, err
    got.backward(torch.from_numpy(cot).to(dev))
    assert_table_grad_close(leaf.grad, rec[key + "idx"], rec[key + "val"],
                            rec[key + "absval"], dtype, f"{mode} {dtype}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("mode", ["cell", "corner"])
def test_kernel_table_gradient_matches_plain_autograd(mode, dtype):
    """To one bf16 ulp of each entry (where the float32 sums, in another
    order, straddle a rounding boundary) plus float32 round-off of the sum;
    on a crowded table, so that entries take many cotangents."""
    dev = _cuda()
    cfg = thg.HashGridConfig(**SMALL, mode=mode, dtype=dtype)
    n = 20_000
    table, pos = _table(cfg, 12, dev), _positions(n, 13, dev)
    grad_out = torch.randn((n, cfg.out_dim), generator=torch.Generator().manual_seed(14)).to(dev)
    leaf = table.clone().requires_grad_()
    _kernel_call(leaf, pos, cfg).backward(grad_out)
    got = leaf.grad
    want = _plain_table_grad(table, pos, grad_out, cfg)
    scale = _plain_table_grad(table, pos, grad_out.abs(), thg.HashGridConfig(
        **SMALL, mode=mode, dtype="float32"))
    allowed = 2.0**-18 * scale
    if dtype == "bfloat16":
        allowed = allowed + torch.maximum(_bf16_ulp(want), _bf16_ulp(got))
        assert torch.equal(got, got.to(torch.bfloat16).to(torch.float32))
    assert torch.all((got - want).abs() <= allowed)
    assert float(want.abs().max()) > 0
    # The model of the backward (the CPU test's) is what the kernel computes.
    model = table_grad_model(grad_out, pos, cfg)
    assert torch.all((got - model).abs() <= allowed)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["cell", "corner"])
def test_kernel_forward_is_bit_identical_across_calls(mode):
    dev = _cuda()
    cfg = thg.HashGridConfig(**PUBLISHED, mode=mode)
    table, pos = _table(cfg, 15, dev), _positions(125_664, 16, dev)
    first = _kernel_call(table, pos, cfg)
    assert torch.equal(first, _kernel_call(table, pos, cfg))


@pytest.mark.cuda
def test_a_captured_field_query_replays_equal_to_its_eager_call():
    """A field query captured into a CUDA graph replays what the eager call
    gives, to the bit, and reads the tables in place."""
    dev = _cuda()
    cfg = AttributeFieldConfig(grid=thg.HashGridConfig(**SMALL), hidden_dim=16)
    aabb = torch.tensor([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]], device=dev)
    field = AttributeField(aabb, cfg, torch.Generator(device=dev).manual_seed(17))
    xyz = (2.0 * torch.rand((5000, 3), generator=torch.Generator().manual_seed(18)) - 1.0).to(dev)
    with torch.no_grad():
        eager = attribute_field_apply(field, xyz)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            attribute_field_apply(field, xyz)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = thg.hash_encode.kernel
        with torch.cuda.graph(graph):
            static = attribute_field_apply(field, xyz)
        assert thg.hash_encode.kernel == before + 2  # encoding and quat_encoding
        graph.replay()
        torch.cuda.synchronize()
        assert thg.hash_encode.kernel == before + 2
        assert set(static) == set(eager)
        assert all(torch.equal(static[k], eager[k]) for k in eager)
        field.encoding.mul_(-0.5)
        field.quat_encoding.add_(1e-3)
        graph.replay()
        again = attribute_field_apply(field, xyz)
        torch.cuda.synchronize()
        assert all(torch.equal(static[k], again[k]) for k in again)
        assert not torch.equal(static["shs"], eager["shs"])


@pytest.mark.cuda
def test_the_kernel_launches_on_the_current_stream_without_a_host_sync():
    dev = _cuda()
    cfg = thg.HashGridConfig(**SMALL)
    table = _table(cfg, 19, dev).requires_grad_()
    pos = _positions(4000, 20, dev)
    _kernel_call(table, pos, cfg).sum().backward()  # loads the library
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            out = _kernel_call(table, pos, cfg)
            out.sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(side)
    assert float((out.detach() - thg.hash_encode_plain(table.detach(), pos, cfg)).abs().max()) <= 2e-6
    assert np.isfinite(float(table.grad.abs().sum()))
