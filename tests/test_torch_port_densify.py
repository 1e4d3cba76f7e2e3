"""Static-capacity densification against soar_tpu on the CPU: padding,
the statistics, clone-then-split into dead slots (the split's normal draw
injected from JAX) and pruning.  Masks and alive counts are exact; floats
within 1e-6 (the same float32 arithmetic, the quaternion's rotation matrix
and the split's offset summed in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.avatar import densify as jd
from soar_tpu.avatar.state import AvatarParams as JParams
from soar_tpu_torch.avatar import densify as td
from soar_tpu_torch.avatar.state import AvatarParams
from soar_tpu_torch.field.attribute_field import AttributeField, AttributeFieldConfig
from soar_tpu_torch.field.hashgrid import HashGridConfig
from soar_tpu_torch.io.from_jax import densify_state_from_numpy
from torch_port_helpers import assert_close, n, t

FIELDS = ("xyz", "rotation", "scaling", "opacity", "colors", "occ")
TINY = AttributeFieldConfig(grid=HashGridConfig(num_levels=2, log2_hashmap_size=6), hidden_dim=4)


def _jparams(num, seed=0, big_share=0.3):
    """Random surfels: log-scales around -4.6 (1%), ``big_share`` of them
    at ~0.4 (split candidates at extent 2)."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    scaling = rng.uniform(-6.0, -4.0, (num, 1)).astype(f32)
    big = rng.rand(num) < big_share
    scaling[big, 0] = np.log(rng.uniform(0.1, 0.6, big.sum())).astype(f32)
    return JParams(
        xyz=rng.uniform(-1, 1, (num, 3)).astype(f32),
        rotation=rng.randn(num, 4).astype(f32),
        scaling=scaling,
        opacity=rng.randn(num, 1).astype(f32) * 2,
        colors=rng.randn(num, 3).astype(f32),
        occ=rng.randn(num, 1).astype(f32),
        field={},
        latent_pose=np.zeros((2, 2), f32),
    )


def _port(jp):
    field = AttributeField(torch.tensor([[-1.0] * 3, [1.0] * 3]), TINY)
    return AvatarParams(field=field, **{k: t(getattr(jp, k)) for k in FIELDS + ("latent_pose",)})


def _state_np(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _assert_state(got, want):
    np.testing.assert_array_equal(n(got.alive), np.asarray(want.alive))
    for k in ("xyz_grad_accum", "scale_grad_accum", "opac_accum", "denom"):
        assert_close(getattr(got, k), getattr(want, k), 1e-6, msg=k)


def _assert_params(got, want, alive=None):
    for k in FIELDS:
        g, w = n(getattr(got, k)), np.asarray(getattr(want, k))
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=1e-6, err_msg=k)


def test_pad_to_capacity_and_create_match_jax():
    jp = _jparams(7)
    tp = td.pad_to_capacity(_port(jp), 12)
    _assert_params(tp, jd.pad_to_capacity(jp, 12))
    assert tp.xyz.shape == (12, 3) and float(tp.xyz[8, 0].detach()) == 1e6
    assert td.pad_to_capacity(tp, 12) is tp  # already at capacity
    _assert_state(td.DensifyState.create(12, 7, device="cpu"), jd.DensifyState.create(12, 7))


def test_accumulate_stats_matches_jax():
    rng = np.random.RandomState(1)
    C = 16
    js = jd.DensifyState.create(C, 11)
    ts = td.DensifyState.create(C, 11, device="cpu")
    for _ in range(3):
        g = rng.randn(C, 3).astype(np.float32)
        gs = rng.randn(C, 1).astype(np.float32)
        op = rng.randn(C, 1).astype(np.float32)
        vis = rng.rand(C) > 0.3
        js = jd.accumulate_stats(js, jnp.asarray(g), jnp.asarray(gs), jnp.asarray(op),
                                 jnp.asarray(vis))
        ts = td.accumulate_stats(ts, t(g), t(gs), t(op), t(vis))
    _assert_state(ts, js)
    _assert_state(densify_state_from_numpy(_state_np(js), device="cpu"), js)


def _densify_inputs(num, cap, holes, seed):
    """Padded params and a state with accumulated statistics: alive slots
    with ``holes`` dead among them, high and low gradients, some scale
    gradients and opacities that veto a clone."""
    rng = np.random.RandomState(seed)
    jp = jd.pad_to_capacity(_jparams(num, seed), cap)
    alive = np.arange(cap) < num
    alive[rng.choice(num, holes, replace=False)] = False
    state = jd.DensifyState(
        alive=jnp.asarray(alive),
        xyz_grad_accum=jnp.asarray(rng.uniform(0, 3e-4, cap).astype(np.float32)),
        scale_grad_accum=jnp.asarray(np.where(rng.rand(cap) < 0.2, 1e-3, -1e-3)
                                     .astype(np.float32)),
        opac_accum=jnp.asarray(np.where(rng.rand(cap) < 0.1, 5.0, 0.5).astype(np.float32)),
        denom=jnp.asarray(rng.randint(0, 3, cap).astype(np.float32)),
    )
    return jp, state


@pytest.mark.parametrize("surface", [True, False])
@pytest.mark.parametrize("num, cap, holes", [(40, 80, 5), (60, 72, 2)])
def test_adaptive_densify_matches_jax(surface, num, cap, holes):
    """Clones first, then splits, each into the next dead slot in index
    order (3 clones and 6 splits at capacity 80); at capacity 72 the 12
    clones leave 2 slots for the splits and the others are dropped."""
    jp, js = _densify_inputs(num, cap, holes, seed=num + holes)
    key = jax.random.PRNGKey(5)
    noise = np.asarray(jax.random.normal(key, jp.xyz.shape))
    jp2, js2 = jd.adaptive_densify(jp, js, key, grad_threshold=1e-4, surface=surface)
    tp = _port(jp)
    ts = densify_state_from_numpy(_state_np(js), device="cpu")
    xyz_param = tp.xyz
    tp2, ts2 = td.adaptive_densify(tp, ts, grad_threshold=1e-4, surface=surface,
                                   noise=t(noise))
    assert tp2 is tp and tp2.xyz is xyz_param  # in place: the optimizer keeps its moments
    _assert_state(ts2, js2)
    _assert_params(tp2, jp2)
    added = int(np.asarray(js2.alive).sum() - np.asarray(js.alive).sum())
    assert added > 0
    if cap == 72:
        assert bool(np.asarray(js2.alive).all())  # every dead slot filled, the rest dropped


def test_adaptive_densify_draws_from_a_generator():
    jp, js = _densify_inputs(40, 80, 5, seed=3)
    outs = []
    for _ in range(2):
        tp = _port(jp)
        ts = densify_state_from_numpy(_state_np(js), device="cpu")
        td.adaptive_densify(tp, ts, torch.Generator().manual_seed(4), surface=False)
        outs.append(n(tp.xyz))
    np.testing.assert_array_equal(outs[0], outs[1])
    with pytest.raises(ValueError, match="generator"):
        td.adaptive_densify(_port(jp), densify_state_from_numpy(_state_np(js), device="cpu"))


def test_adaptive_prune_matches_jax():
    jp, js = _densify_inputs(50, 64, 4, seed=9)
    jp2, js2 = jd.adaptive_prune(jp, js, min_opacity=0.2)
    tp = _port(jp)
    tp2, ts2 = td.adaptive_prune(tp, densify_state_from_numpy(_state_np(js), device="cpu"),
                                 min_opacity=0.2)
    _assert_state(ts2, js2)
    _assert_params(tp2, jp2)
    pruned = np.asarray(js.alive) & ~np.asarray(js2.alive)
    assert pruned.sum() > 0 and (n(tp2.xyz)[pruned] == 1e6).all()


def test_densify_then_prune_on_one_step_matches_jax():
    """A step whose cadence runs both (``maintain`` densifies, then
    prunes): the densify resets the visibility counts that the prune reads,
    so both packages prune alike (ROADMAP Queue 3: every alive surfel)."""
    jp, js = _densify_inputs(40, 80, 5, seed=1)
    key = jax.random.PRNGKey(0)
    jp2, js2 = jd.adaptive_prune(*jd.adaptive_densify(jp, js, key))
    tp, ts = td.adaptive_densify(_port(jp), densify_state_from_numpy(_state_np(js), device="cpu"),
                                 noise=t(jax.random.normal(key, jp.xyz.shape)))
    tp2, ts2 = td.adaptive_prune(tp, ts)
    _assert_state(ts2, js2)
    _assert_params(tp2, jp2)
