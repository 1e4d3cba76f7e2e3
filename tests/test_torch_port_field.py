"""Parity of the port's hash grid and attribute field with soar_tpu.

Same tables and positions (numpy, seeded) go through both packages on the
CPU.  The bf16 cast of the table rounds to nearest-even in both, so the
gathered features are identical and the f32 trilinear sums agree to
~1e-7; the MLP heads add f32 matmuls reduced in different orders (1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.field import attribute_field as jaf
from soar_tpu.field import hashgrid as jhg
from soar_tpu_torch.field import attribute_field as taf
from soar_tpu_torch.field import hashgrid as thg
from soar_tpu_torch.io.from_jax import field_config_from_dict
from torch_port_helpers import assert_close, n, t


def _cfgs(**kw):
    return jhg.HashGridConfig(**kw), thg.HashGridConfig(**kw)


def test_hash_matches_jax_uint32_wraparound():
    rng = np.random.RandomState(0)
    ijk = rng.randint(0, 2049, (3, 4096)).astype(np.int32)
    for mask in ((1 << 12) - 1, (1 << 18) - 1):
        want = jhg._hash3(*(jnp.asarray(a) for a in ijk), mask)
        got = thg._hash3(*(t(a).long() for a in ijk), mask)
        np.testing.assert_array_equal(n(got), n(want))


@pytest.mark.parametrize("mode", ["cell", "corner"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_hash_encode_matches_jax(mode, dtype):
    jc, tc = _cfgs(num_levels=6, min_res=16, max_res=2048, log2_hashmap_size=12,
                   mode=mode, dtype=dtype)
    assert tc.resolutions() == jc.resolutions()
    assert (tc.table_size, tc.out_dim, tc.row_width) == (jc.table_size, jc.out_dim, jc.row_width)
    rng = np.random.RandomState(1)
    table = rng.uniform(-1, 1, (jc.num_levels, jc.table_size, jc.row_width)).astype(np.float32)
    pos = rng.uniform(0, 1, (500, 3)).astype(np.float32)
    want = jhg.hash_encode(jnp.asarray(table), jnp.asarray(pos), jc)
    got = thg.hash_encode(t(table), t(pos), tc)
    assert got.dtype == torch.float32
    assert_close(got, want, 1e-6)


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
