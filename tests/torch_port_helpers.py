"""Shared helpers for the ``tests/test_torch_port_*.py`` parity tests:
numpy <-> jnp / torch conversion and flattening of ``soar_tpu`` pytrees
into the nested numpy dicts ``soar_tpu_torch.io.from_jax`` takes."""

from __future__ import annotations

import dataclasses
import os

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


# soar_tpu's hash encodings recorded on the CPU, so that the port's CUDA
# kernel can be held against them on a card where JAX is not installed.
# ``python tests/test_torch_port_field.py`` writes the file, and
# test_torch_port_field.py checks it against soar_tpu.
HASH_JAX_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                             "hash_encode_jax.npz")
HASH_JAX_CASES = [(mode, dtype) for mode in ("cell", "corner")
                  for dtype in ("bfloat16", "float32")]


def hash_jax_case(mode, dtype):
    """Grid keywords, table [L, T, W], positions [1001, 3] and cotangent
    [1001, 2 L] (numpy) of a recorded case.  The positions hold 0, 1,
    points on a face and points from outside the box, which
    ``normalize_positions`` sets to 0.  float32: 2^8 rows a level, which
    the points crowd, so entries of the table's gradient sum many
    cotangents.  bfloat16: 2^16 rows a level, and only 48 uniform points
    have a cotangent, so no entry sums more than two: soar_tpu's bf16
    scatter, which adds one cotangent at a time in bf16, and a float32 sum
    rounded once then agree to the bit."""
    if dtype == "float32":
        grid = dict(num_levels=4, min_res=16, max_res=512, log2_hashmap_size=8)
    else:
        grid = dict(num_levels=4, min_res=64, max_res=512, log2_hashmap_size=16)
    grid.update(mode=mode, dtype=dtype)
    rng = np.random.RandomState(31)
    pos = rng.uniform(0, 1, (1001, 3)).astype(np.float32)
    pos[0], pos[1], pos[2, 0], pos[3, 1] = 0.0, 1.0, 1.0, 0.0
    outside = rng.uniform(-0.3, 1.3, (8, 3)).astype(np.float32)
    pos[4:12] = outside * np.all((outside > 0) & (outside < 1), axis=1, keepdims=True)
    L = grid["num_levels"]
    width = 2 * (8 if mode == "cell" else 1)
    table = rng.uniform(-1, 1, (L, 1 << grid["log2_hashmap_size"], width)).astype(np.float32)
    cot = rng.standard_normal((1001, 2 * L)).astype(np.float32)
    if dtype == "bfloat16":
        cot[:12] = 0.0
        cot[60:] = 0.0
    return grid, table, pos, cot


# soar_tpu's surfel preprocess recorded on the CPU (its outputs, and
# jax.grad of a cotangent-weighted sum of them for the means, quaternions
# and scales), so that the port's CUDA kernel can be held against it on a
# card where JAX is not installed.  ``python tests/test_torch_port_render.py``
# writes the file, and test_torch_port_render.py checks it against soar_tpu.
PREP_JAX_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                             "preprocess_jax.npz")
# RasterConfig keywords of each recorded case: the SOAR cells' surfels with
# per-pixel depth, the front-face cull, surfels without per-pixel depth, and
# the dreamer's volume Gaussians.
PREP_JAX_CASES = {
    "default": {},
    "front": {"render_front": True},
    "no_perpix": {"perpix_depth": False},
    "dreamer": {"surface": False, "perpix_depth": False},
}
PREP_FIELDS = ("xy", "depth", "conic", "normal_view", "view_dot", "jinv")
PREP_CAMERA = ("fovx", "fovy", "w2c", "full_proj", "campos", "prcppoint")
# The recorded camera: c2w the identity (view z = -world z), fovx = fovy,
# an off-centre principal point; the image is (H, W).
PREP_FOV, PREP_PRCP, PREP_SIZE = 0.8, (0.47, 0.53), (96, 80)
# Forward: float fields within float32 round-off of the chain (each entry
# to PREP_RTOL of its column's largest magnitude, the conic's times its
# conditioning (a c + b^2) / det); valid and radius equal.  Gradients: each
# input's relative L2 within PREP_GRAD_RTOL, and each entry within
# PREP_GRAD_RTOL of its column's largest magnitude times the conditioning.
PREP_RTOL, PREP_GRAD_RTOL = 1e-5, 1e-4


def prep_jax_case():
    """The recorded surfels and cotangents (numpy float32): ``means`` [600,
    3], unit ``quats`` [600, 4], ``scales`` [600, 3] and one cotangent a
    field, ``cot[field]``.  Most surfels sit 1 to 4 in front of the camera,
    some beyond the frustum's border; row 0 is on the camera's plane, row 1
    in front of the near plane, row 2 behind the camera, and rows 3-8 face
    the camera beyond the EWA clamp's 1.3 tan(fov / 2) but inside the
    border."""
    N = 600
    rng = np.random.RandomState(41)
    tan = np.tan(PREP_FOV / 2)
    z = rng.uniform(1.0, 4.0, N)
    lateral = rng.uniform(-1.5, 1.5, (N, 2)) * (z * tan)[:, None]
    z[0:3] = (0.0, 0.05, -1.0)
    lateral[0:3] = (0.2, -0.1)
    k = np.arange(3, 9)
    lateral[k, 0] = np.where(k % 2 == 0, 1.35, -1.35) * z[k] * tan
    lateral[k, 1] = 0.2 * z[k]
    means = np.stack([lateral[:, 0], -lateral[:, 1], -z], -1).astype(np.float32)
    quats = rng.standard_normal((N, 4))
    quats[3:9] = (1.0, 0.1, -0.1, 0.05)  # facing the camera
    quats = (quats / np.linalg.norm(quats, axis=-1, keepdims=True)).astype(np.float32)
    scales = np.exp(np.log(0.03) + 0.5 * rng.standard_normal((N, 3))).astype(np.float32)
    widths = {"xy": 2, "depth": 1, "conic": 3, "normal_view": 3, "view_dot": 1, "jinv": 10}
    cot = {f: rng.standard_normal((N, w) if w > 1 else (N,)).astype(np.float32)
           for f, w in widths.items()}
    return means, quats, scales, cot


def prep_masked_cot(cot, valid):
    """The cotangents zero on the culled surfels, as the renderer's gathers
    hand them back."""
    valid = np.asarray(valid)
    return {f: c * valid.reshape(-1, *([1] * (c.ndim - 1))) for f, c in cot.items()}


def prep_conditioning(conic):
    """(a c + b^2) / det of each surfel's cov2d, from its conic, at least 1."""
    c0, c1, c2 = (np.asarray(conic, np.float64)[:, k] for k in range(3))
    with np.errstate(divide="ignore", invalid="ignore"):
        cond = (c0 * c2 + c1 * c1) / np.abs(c0 * c2 - c1 * c1)
    return np.maximum(np.nan_to_num(cond, nan=1.0, posinf=1.0), 1.0)


def assert_preprocess_matches_record(pre, grads, rec, case, msg=""):
    """A port's ``Preprocessed`` and its (means, quats, scales) gradients
    for ``prep_masked_cot`` against soar_tpu's as ``rec`` holds them for
    ``case``: the tolerances of ``PREP_RTOL`` and ``PREP_GRAD_RTOL``.  A
    culled surfel's gradient rows are 0 (soar_tpu's may be NaN there: at
    view z = 0 it divides by the depth)."""
    key = case + "_"
    valid = rec[key + "valid"]
    np.testing.assert_array_equal(n(pre.valid), valid, err_msg=f"{msg} valid")
    np.testing.assert_array_equal(n(pre.radius)[valid], rec[key + "radius"][valid],
                                  err_msg=f"{msg} radius")
    cond = prep_conditioning(rec[key + "conic"][valid])
    for f in PREP_FIELDS:
        got, want = n(getattr(pre, f))[valid], rec[key + f][valid]
        scale = np.maximum(np.abs(want).max(0), 1e-30)
        tol = PREP_RTOL * scale * (cond[:, None] if f == "conic" else 1.0)
        err = np.abs(got - want)
        assert np.all(err <= tol), f"{msg} {f}: {float((err / scale).max()):.3g} of its scale"
    for name, got in zip(("means3d", "quats", "scales"), grads):
        got, want = n(got), rec[key + "grad_" + name]
        assert np.isfinite(got).all() and not np.any(got[~valid]), f"{msg} {name} on culled"
        got, want = got[valid], want[valid]
        rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
        assert rel <= PREP_GRAD_RTOL, f"{msg} {name}: relative L2 {rel:.3g}"
        tol = PREP_GRAD_RTOL * np.abs(want).max(0) * cond[:, None]
        assert np.all(np.abs(got - want) <= tol), f"{msg} {name}: an entry beyond"


def assert_table_grad_close(got, idx, val, absval, dtype, msg=""):
    """A table's gradient ``got`` (any shape) against a reference given at
    its flat entries ``idx`` (every entry a cotangent reaches): the value
    ``val`` and ``absval``, the sum of the entry's |cotangent * weight|.
    Every other entry is 0; at ``idx`` the two agree to float32 round-off of
    the sum (2^-18 of ``absval``) and, in bf16, one bf16 ulp of the larger
    (where sums taken in another order straddle a rounding boundary)."""
    got = n(got).reshape(-1)
    rest = np.ones(got.shape, bool)
    rest[idx] = False
    assert not np.any(got[rest]), f"{msg}: {int(np.count_nonzero(got[rest]))} entries off idx"
    g = got[idx]
    allowed = 2.0**-18 * absval
    if dtype == "bfloat16":
        big = np.maximum(np.abs(g), np.abs(val))
        allowed = allowed + np.where(big > 0, np.ldexp(1.0, np.frexp(big)[1] - 8), 0.0)
    excess = np.abs(g - val) - allowed
    assert np.all(excess <= 0), (
        f"{msg}: {int(np.sum(excess > 0))} entries beyond the tolerance, worst "
        f"|got - want| {float(np.abs(g - val).max()):.3g}")


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
