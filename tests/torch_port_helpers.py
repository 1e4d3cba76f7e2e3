"""Shared helpers for the ``tests/test_torch_port_*.py`` parity tests:
numpy <-> jnp / torch conversion and flattening of ``soar_tpu`` pytrees
into the nested numpy dicts ``soar_tpu_torch.io.from_jax`` takes."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


# The suite runs in several worker processes on one host; torch's default of
# one intra-op thread per core then oversubscribes the cores, which slows
# these small-shape tests several-fold.
torch.set_num_threads(min(2, torch.get_num_threads()))


def _warm_up_vectorized_math():
    """Some CPU builds of torch (seen with 2.13.0+cpu) return the first call
    of a vectorized transcendental op in a process (exp, log, tanh, ...) with
    up to ~1e-4 relative error when that call runs on several threads; every
    later call is float32-exact.  One call of each such op the port uses, at
    a size that runs in parallel, keeps that out of the comparisons."""
    x = torch.linspace(0.01, 4.0, 1 << 17)
    for f in (torch.exp, torch.log, torch.log1p, torch.sqrt, torch.rsqrt, torch.sin,
              torch.cos, torch.tan, torch.tanh, torch.sigmoid):
        f(x)
    torch.atan2(x, x.flip(0))


_warm_up_vectorized_math()


def t(a, dtype=None):
    """numpy / jnp -> CPU torch tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def n(x):
    """torch / jnp -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def body_to_numpy(body) -> dict:
    return {
        "v_template": n(body.v_template),
        "shapedirs": n(body.shapedirs),
        "posedirs": n(body.posedirs),
        "J_regressor": n(body.J_regressor),
        "lbs_weights": n(body.lbs_weights),
        "parents": tuple(body.parents),
        "faces": n(body.faces),
        "num_betas": body.num_betas,
        **{k: None if getattr(body, k) is None else n(getattr(body, k))
           for k in ("pose_mean", "extra_joint_idxs", "lmk_faces_idx", "lmk_bary_coords",
                     "dyn_lmk_faces_idx", "dyn_lmk_bary_coords")},
    }


def avatar_to_numpy(params, model):
    """(AvatarParams, AvatarModel) of soar_tpu -> (params dict, model dict)."""
    f = params.field
    field = {
        k: ([{"w": n(l["w"]), "b": n(l["b"])} for l in v] if k.startswith("mlp_") else n(v))
        for k, v in f.items()
    }
    p = {k: n(getattr(params, k)) for k in
         ("xyz", "rotation", "scaling", "opacity", "colors", "occ", "latent_pose")}
    p["field"] = field
    m = {
        "body": body_to_numpy(model.body),
        "skin": {k: n(v) for k, v in model.skin._asdict().items()},
        "smpl_params": {k: n(v) for k, v in model.smpl_params.items()},
        "aabb": n(model.aabb),
        "original_pos": n(model.original_pos),
        "num_frames": model.num_frames,
        "field_cfg": dataclasses.asdict(model.field_cfg),
    }
    return p, m


def assert_close(got, want, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(n(got), n(want), atol=atol, rtol=rtol, err_msg=msg)


def assert_close_share(got, want, atol, max_share, msg=""):
    """All finite where the reference is, and at most ``max_share`` of the
    elements beyond ``atol`` (threshold flips at the T cutoff)."""
    got, want = n(got), n(want)
    assert got.shape == want.shape, msg
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=msg)
    bad = np.abs(got - want) > atol
    share = bad.mean() if bad.size else 0.0
    assert share <= max_share, f"{msg}: {share:.4%} of elements beyond {atol}"


def make_scene(NT=6, K=24, tile=16, C=7, seed=0, saturate=False):
    """The fixture of tests/test_block_composite.py, as numpy arrays."""
    rng = np.random.RandomState(seed)
    origins = (rng.randint(0, 4, (NT, 2)) * tile).astype(np.float32)
    xy = origins[:, None, :] + rng.uniform(0, tile, (NT, K, 2))
    conic = np.zeros((NT, K, 3), np.float32)
    conic[..., 0] = rng.uniform(0.02, 0.3, (NT, K))
    conic[..., 2] = rng.uniform(0.02, 0.3, (NT, K))
    conic[..., 1] = rng.uniform(-0.02, 0.02, (NT, K))
    if saturate:
        opac = rng.uniform(0.9, 1.0, (NT, K)).astype(np.float32)
    else:
        opac = rng.uniform(0.2, 0.9, (NT, K)).astype(np.float32)
    attrs = rng.uniform(-1, 1, (NT, K, C)).astype(np.float32)
    e = rng.uniform(-0.3, 0.3, (NT, K, 2)).astype(np.float32)
    valid = rng.rand(NT, K) > 0.15
    lx = np.tile(np.arange(tile, dtype=np.float32), tile)
    ly = np.repeat(np.arange(tile, dtype=np.float32), tile)
    pixf = np.stack(
        [origins[:, None, 0] + lx[None], origins[:, None, 1] + ly[None]], -1
    ).astype(np.float32)
    return (xy.astype(np.float32), conic, opac, valid, attrs, e, pixf)


def small_avatar(seed=0, num_frames=4, use_field_cfg=None):
    """soar_tpu's small procedural avatar (4 joints, 1 subdivision, a tiny
    hash field; no distillation), built in JAX and carried across to the
    port on the CPU.  Returns ``(jparams, jmodel, tparams, tmodel)``."""
    import jax.numpy as jnp

    from soar_tpu.avatar import init_avatar
    from soar_tpu.body import make_test_body
    from soar_tpu.field.attribute_field import AttributeFieldConfig
    from soar_tpu.field.hashgrid import HashGridConfig

    rng = np.random.RandomState(seed)
    body = make_test_body(num_joints=4, segments_per_bone=3, ring=8)
    F = num_frames
    sp = {
        "betas": np.zeros((1, body.num_betas), np.float32),
        "body_pose": (rng.randn(F, (body.num_joints - 1) * 3) * 0.08).astype(np.float32),
        "global_orient": (rng.randn(F, 3) * 0.05).astype(np.float32),
        "transl": np.tile([[0.0, 0.2, -1.8]], (F, 1)).astype(np.float32),
    }
    field_cfg = use_field_cfg or AttributeFieldConfig(
        grid=HashGridConfig(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=12),
        hidden_dim=16,
    )
    jparams, jmodel = init_avatar(body, {k: jnp.asarray(v) for k, v in sp.items()},
                                  num_subdiv=1, field_cfg=field_cfg, seed=seed,
                                  distill_steps=0)
    return (jparams, jmodel) + port_copy(jparams, jmodel)


def port_copy(jparams, jmodel):
    """A fresh CPU copy of a soar_tpu avatar in the port: (params, model)."""
    from soar_tpu_torch.io.from_jax import avatar_from_numpy

    return avatar_from_numpy(*avatar_to_numpy(jparams, jmodel), device="cpu")


def make_gathered(NT=4, K=16, tile=16, seed=0, counts=None):
    """The gathered tile lists of tests/test_pallas_composite.py
    (``make_gathered``: the same RandomState draws), as numpy arrays in the
    argument order of ``composite_tiles_pallas``.  ``counts`` replaces the
    full per-tile counts."""
    rng = np.random.RandomState(seed)
    origins = (rng.randint(0, 4, (NT, 2)) * tile).astype(np.int32)
    xy = origins[:, None, :] + rng.uniform(0, tile, (NT, K, 2))
    conic = np.zeros((NT, K, 3), np.float32)
    conic[..., 0] = rng.uniform(0.02, 0.3, (NT, K))
    conic[..., 2] = rng.uniform(0.02, 0.3, (NT, K))
    conic[..., 1] = rng.uniform(-0.02, 0.02, (NT, K))
    opac = rng.uniform(0.2, 1.0, (NT, K)).astype(np.float32)
    colors = rng.uniform(0, 1, (NT, K, 3)).astype(np.float32)
    normals = rng.uniform(-1, 1, (NT, K, 3)).astype(np.float32)
    depths = np.sort(rng.uniform(1, 4, (NT, K)), axis=-1).astype(np.float32)
    jinv = rng.uniform(-0.5, 0.5, (NT, K, 10)).astype(np.float32)
    slot_valid = rng.rand(NT, K) > 0.1
    cnt = np.full((NT,), K, np.int32) if counts is None else np.asarray(counts, np.int32)
    return (xy.astype(np.float32), conic, opac, colors, normals, depths, jinv,
            slot_valid, cnt, origins)


def make_sticky_stack():
    """The crafted one-tile stack of tests/test_pallas_composite.py's sticky
    early-stop test: T walks 1 -> 0.01 -> 0.005, the third splat violates
    (5e-5 < 1e-4), and the 0.5 splat behind it would re-pass a non-sticky
    test with weight ~2.5e-3."""
    NT, K, tile = 1, 8, 16
    origins = np.zeros((1, 2), np.int32)
    xy = np.full((NT, K, 2), tile / 2.0, np.float32)
    conic = np.zeros((NT, K, 3), np.float32)
    conic[..., 0] = conic[..., 2] = 1e-4
    opac = np.array([[0.999, 0.5, 0.999, 0.5, 0.3, 0.2, 0.1, 0.05]], np.float32)
    colors = np.ones((NT, K, 3), np.float32)
    normals = np.ones((NT, K, 3), np.float32)
    depths = np.arange(1, K + 1, dtype=np.float32)[None].repeat(NT, 0)
    jinv = np.zeros((NT, K, 10), np.float32)
    slot_valid = np.ones((NT, K), bool)
    counts = np.full((NT,), K, np.int32)
    return (xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts, origins)


def make_render_scene(n=60, seed=0, spread=0.4):
    """The surfel scene of tests/test_render.py (``make_scene``), as numpy
    arrays: means, unit quats, scales, opacities, colours."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n, 3).astype(np.float32) * spread
    quats = rng.randn(n, 4).astype(np.float32)
    quats = quats / np.maximum(np.linalg.norm(quats, axis=-1, keepdims=True), 1e-12)
    scales = np.abs(rng.randn(n, 3)).astype(np.float32) * 0.05 + 0.02
    opac = rng.uniform(0.3, 1.0, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return means, quats.astype(np.float32), scales, opac, colors


def random_flax_variables(shape_tree, seed=0, affine=True):
    """Numpy values for a flax variable tree of ``jax.ShapeDtypeStruct``s
    (``jax.eval_shape`` of an ``init``).  Every kernel is N(0, 1/fan_in), so
    no layer starts at zero (flax zeroes some output kernels) and every
    weight reaches the output.  With ``affine`` the norm scales are
    1 + 0.1 N(0, 1) and the biases 0.1 N(0, 1), so a bias or a norm carried
    to the wrong module shows in the output; without, they are flax's
    initial 1 and 0."""
    import jax

    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        if name == "scale":
            if not affine:
                return np.ones(x.shape, np.float32)
            return (1.0 + 0.1 * rng.randn(*x.shape)).astype(np.float32)
        if name == "bias":
            if not affine:
                return np.zeros(x.shape, np.float32)
            return (0.1 * rng.randn(*x.shape)).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return (rng.randn(*x.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shape_tree)


def tiny_guidance_variables(n_view=2, with_ip=False, image_size=32, seed=0, affine=True):
    """soar_tpu's tiny guidance networks (``NetworkShapes.tiny``) with
    :func:`random_flax_variables`: ``{"unet": ..., "vae": ...}`` as numpy
    trees."""
    from soar_tpu.guidance import build as jbuild

    shapes = jbuild.NetworkShapes.tiny(image_size)
    unet_shapes, vae_shapes = jbuild._mock_unet_vae_shapes(shapes, n_view, with_ip)
    return {"unet": random_flax_variables(unet_shapes, seed, affine),
            "vae": random_flax_variables(vae_shapes, seed + 1, affine)}
