"""Parity of the port's hash grid and attribute field with soar_tpu.

Same tables and positions (numpy, seeded) go through both packages on the
CPU.  The bf16 cast of the table rounds to nearest-even in both, so the
gathered features are identical and the f32 trilinear sums agree to
~1e-7; the MLP heads add f32 matmuls reduced in different orders (1e-5).
On a CUDA device the port's encoding is its kernel (``csrc/hash_encode.cu``),
held against soar_tpu run on the CPU; ``tests/data/hash_encode_jax.npz``
records soar_tpu's encodings and table gradients for a card without JAX, and
is checked here against soar_tpu.  ``python tests/test_torch_port_field.py``
writes it again.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.field import attribute_field as jaf
from soar_tpu.field import hashgrid as jhg
from soar_tpu_torch.field import attribute_field as taf
from soar_tpu_torch.field import hashgrid as thg
from soar_tpu_torch.io.from_jax import field_config_from_dict
from torch_port_helpers import (
    HASH_JAX_CASES,
    HASH_JAX_FILE,
    assert_close,
    assert_table_grad_close,
    hash_jax_case,
    n,
    t,
)


def _cfgs(**kw):
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


def test_hash_matches_jax_uint32_wraparound():
    rng = np.random.RandomState(0)
    ijk = rng.randint(0, 2049, (3, 4096)).astype(np.int32)
    for mask in ((1 << 12) - 1, (1 << 18) - 1):
        want = jhg._hash3(*(jnp.asarray(a) for a in ijk), mask)
        got = thg._hash3(*(t(a).long() for a in ijk), mask)
        np.testing.assert_array_equal(n(got), n(want))


DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _device(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return device


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode", ["cell", "corner"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hash_encode_matches_jax(mode, dtype, device):
    """The plain path on the CPU, the kernel on a CUDA device."""
    dev = _device(device)
    jc, tc = _cfgs(num_levels=6, min_res=16, max_res=2048, log2_hashmap_size=12,
                   mode=mode, dtype=dtype)
    assert tc.resolutions() == jc.resolutions()
    assert (tc.table_size, tc.out_dim, tc.row_width) == (jc.table_size, jc.out_dim, jc.row_width)
    rng = np.random.RandomState(1)
    table = rng.uniform(-1, 1, (jc.num_levels, jc.table_size, jc.row_width)).astype(np.float32)
    pos = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    want = jhg.hash_encode(jnp.asarray(table), jnp.asarray(pos), jc)
    got = thg.hash_encode(t(table).to(dev), t(pos).to(dev), tc)
    assert got.dtype == torch.float32 and got.device.type == dev
    assert_close(got, want, 1e-6)


def _jax_hash_case(mode, dtype):
    """soar_tpu on a case of ``hash_jax_case``: the encoding, and at the flat
    entries ``idx`` a cotangent reaches, the table's gradient and the sum of
    |cotangent * weight| (a float32 gather of the absolute cotangents)."""
    grid, table, pos, cot = hash_jax_case(mode, dtype)
    jc = jhg.HashGridConfig(**grid)
    jc32 = dataclasses.replace(jc, dtype="float32")
    jpos = jnp.asarray(pos)
    fwd, vjp = jax.vjp(lambda tb: jhg.hash_encode(tb, jpos, jc), jnp.asarray(table))
    (grad,) = vjp(jnp.asarray(cot))
    _, vjp32 = jax.vjp(lambda tb: jhg.hash_encode(tb, jpos, jc32), jnp.asarray(table))
    (absgrad,) = vjp32(jnp.asarray(np.abs(cot)))
    absgrad = np.asarray(absgrad).reshape(-1)
    idx = np.flatnonzero(absgrad).astype(np.int32)
    return np.asarray(fwd), idx, np.asarray(grad).reshape(-1)[idx], absgrad[idx]


def record_jax_hash_encodings(path=HASH_JAX_FILE):
    """Writes soar_tpu's encodings of the ``HASH_JAX_CASES`` to ``path``."""
    arrays = {}
    for mode, dtype in HASH_JAX_CASES:
        for key, a in zip(("fwd", "idx", "val", "absval"), _jax_hash_case(mode, dtype)):
            arrays[f"{mode}_{dtype}_{key}"] = a
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("mode,dtype", HASH_JAX_CASES)
def test_recorded_jax_hash_encodings_are_soar_tpus(mode, dtype):
    """The file the kernel's card tests read holds what soar_tpu gives now,
    and its bf16 cases give no entry more than two cotangents (what lets a
    float32 sum rounded once equal soar_tpu's bf16 scatter)."""
    fwd, idx, val, absval = _jax_hash_case(mode, dtype)
    rec = np.load(HASH_JAX_FILE)
    key = f"{mode}_{dtype}_"
    assert_close(rec[key + "fwd"], fwd, 1e-6)
    np.testing.assert_array_equal(rec[key + "idx"], idx)
    np.testing.assert_allclose(rec[key + "val"], val, rtol=1e-6, atol=0)
    np.testing.assert_allclose(rec[key + "absval"], absval, rtol=1e-6, atol=0)
    if dtype == "bfloat16":
        grid, _, pos, cot = hash_jax_case(mode, dtype)
        graded = np.any(cot != 0, axis=1)
        flat_idx, _ = thg._lookup(t(pos[graded]), thg.HashGridConfig(**grid))
        assert int(torch.bincount(flat_idx).max()) <= 2


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("mode,dtype", HASH_JAX_CASES)
def test_hash_encode_table_gradient_matches_jax(mode, dtype, device):
    """The table's gradient (autograd of the plain path on the CPU, the
    kernel's backward on a CUDA device) against jax.vjp of soar_tpu's
    encoding: to one bf16 ulp and float32 round-off of each entry."""
    dev = _device(device)
    grid, table, pos, cot = hash_jax_case(mode, dtype)
    _, idx, val, absval = _jax_hash_case(mode, dtype)
    leaf = t(table).to(dev).requires_grad_()
    thg.hash_encode(leaf, t(pos).to(dev), thg.HashGridConfig(**grid)).backward(t(cot).to(dev))
    assert_table_grad_close(leaf.grad, idx, val, absval, dtype, f"{mode} {dtype} {dev}")


def test_normalize_positions_matches_jax():
    rng = np.random.RandomState(2)
    xyz = rng.uniform(-1.2, 1.2, (200, 3)).astype(np.float32)
    aabb = np.array([[-1, -1, -1], [1, 1, 1]], np.float32)
    jp, js = jhg.normalize_positions(jnp.asarray(xyz), jnp.asarray(aabb))
    tp, ts = thg.normalize_positions(t(xyz), t(aabb))
    assert_close(tp, jp, 1e-7)
    np.testing.assert_array_equal(n(ts), n(js))


def test_init_hash_grid_distribution():
    _, tc = _cfgs(num_levels=2, log2_hashmap_size=12)
    g = torch.Generator().manual_seed(3)
    tab = thg.init_hash_grid(g, tc, "cpu")
    assert tuple(tab.shape) == (2, 4096, 16) and tab.dtype == torch.float32
    assert float(tab.abs().max()) <= tc.init_scale
    # U(-s, s): mean 0, variance s^2/3 (131k draws).
    assert abs(float(tab.mean())) < 0.01 * tc.init_scale
    assert abs(float(tab.var()) / (tc.init_scale**2 / 3) - 1.0) < 0.02
    again = thg.init_hash_grid(torch.Generator().manual_seed(3), tc, "cpu")
    assert torch.equal(tab, again)


def test_attribute_field_heads_match_jax_with_carried_weights():
    import jax

    cfg = jaf.AttributeFieldConfig(
        grid=jhg.HashGridConfig(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=10),
        hidden_dim=16,
    )
    aabb = np.array([[-0.5, -0.2, -0.4], [0.5, 1.4, 0.4]], np.float32)
    jfield = jaf.init_attribute_field(jax.random.PRNGKey(0), jnp.asarray(aabb), cfg)
    # Non-zero offsets head, so that head's activation is exercised too.
    jfield["mlp_offsets"][-1]["w"] = jnp.asarray(
        np.random.RandomState(4).randn(16, 3).astype(np.float32) * 0.1
    )
    tfield = taf.AttributeField(t(aabb), field_config_from_dict(dataclasses.asdict(cfg)))
    with torch.no_grad():
        tfield.encoding.copy_(t(jfield["encoding"]))
        tfield.quat_encoding.copy_(t(jfield["quat_encoding"]))
        for head in ("mlp_shs", "mlp_scales", "mlp_quats", "mlp_offsets", "mlp_opacities"):
            for lin, layer in zip(getattr(tfield, head), jfield[head]):
                lin.weight.copy_(t(layer["w"]).T)  # JAX w is [in, out]
                lin.bias.copy_(t(layer["b"]))
    rng = np.random.RandomState(5)
    xyz = rng.uniform(-0.45, 0.45, (300, 3)).astype(np.float32)
    xyz[:, 1] += 0.6
    z = np.array([0.3, -0.2], np.float32)
    want = jaf.attribute_field_apply(jfield, jnp.asarray(xyz), jnp.asarray(z), cfg=cfg)
    with torch.no_grad():
        got = tfield(t(xyz), t(z))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], 1e-5, msg=k)
    sub = taf.attribute_field_apply(tfield, t(xyz), heads=("scales",))
    assert set(sub) == {"scales"}


if __name__ == "__main__":
    record_jax_hash_encodings()
    print(f"wrote {HASH_JAX_FILE}")
