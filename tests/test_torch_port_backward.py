"""Gradients of the port's render stack against soar_tpu on the CPU: the
composite's backward (the plain version of the CUDA kernel), the
gradients of ``rasterize_with_occ`` and ``rasterize_front_back``, and the
values of the ``both_faces`` render.

Tolerances, each with its reason:
- the composite's backward against JAX: per-array absolute tolerance scaled
  to the gradient's own magnitude, as ``tests/test_block_composite.py``
  holds the Pallas backward against the XLA chain (1/(1 - alpha) amplifies
  the float32 rounding of the saturated scene up to 100x);
- the rasterizer's gradients go through preprocess (~1e-6 relative between
  the packages), the gather's scatter-add and the composite, and a pixel
  near a splat's alpha or T threshold can flip: per surfel-gradient
  entries are held to 1e-3 of the array's largest magnitude, with a stated
  share allowed beyond it;
- bf16: the [tiles, pixels, K] chain rounds to 8 bits of mantissa in both
  packages, at different places (torch's and XLA's bf16 cumprod), so the
  bf16 case is held to 2e-2 of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.avatar import RenderSettings as JSettings
from soar_tpu.avatar import render_view as jrender_view
from soar_tpu.render import composite as jcomp
from soar_tpu.render import tiled as jtiled
from soar_tpu.render import types as jtypes
from soar_tpu.render.block_composite import composite_block as jcomposite_block
from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
from soar_tpu_torch.core import camera as tcam
from soar_tpu_torch.render import block_composite as tbc
from soar_tpu_torch.render import composite as tcomp
from soar_tpu_torch.render import tiled as ttiled
from soar_tpu_torch.render import types as ttypes
from torch_port_helpers import assert_close, assert_close_share, make_scene, n, small_avatar, t


def _xla_composite(xy, conic, opac, valid, attrs, e, pixf):
    d = xy[:, None, :, :] - pixf[:, :, None, :]
    alpha = jcomp.splat_alpha(d, conic[:, None], opac[:, None], valid[:, None])
    weights, t_final = jcomp.composite_weights(alpha)
    accum = jnp.einsum("npk,nkc->npc", weights, attrs)
    corr = jnp.sum(weights * (d[..., 0] * e[:, None, :, 0] + d[..., 1] * e[:, None, :, 1]), -1)
    return accum, corr, t_final


def _cotangents(NT, P, C, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(NT, C, P).astype(np.float32), rng.randn(NT, P).astype(np.float32),
            rng.randn(NT, P).astype(np.float32))


def _jax_gfeat(fn, scene, cots):
    xy, conic, opac, valid, attrs, e, pixf = (jnp.asarray(a) for a in scene)
    gacc, gcorr, gT = (jnp.asarray(a) for a in cots)
    _, vjp = jax.vjp(lambda a, b, c, d, f: fn(a, b, c, valid, d, f, pixf), xy, conic, opac, attrs, e)
    gxy, gconic, gop, gattrs, ge = vjp((gacc.transpose(0, 2, 1), gcorr, gT))
    return np.concatenate([gxy, gconic, gop[..., None], np.zeros_like(gop)[..., None], ge, gattrs], -1)


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("C", [7, 3])
def test_composite_bwd_plain_matches_jax(saturate, C):
    scene = make_scene(NT=6, K=24, C=C, seed=11, saturate=saturate)
    cots = _cotangents(6, 256, C, seed=12)
    got = n(tcomp.composite_block_bwd_plain(*(t(a) for a in scene), *(t(a) for a in cots)))
    assert got.shape == (6, 24, 9 + C)
    assert np.all(got[..., 6] == 0)
    for name, fn in (("xla", _xla_composite),
                     ("pallas", lambda *a: jcomposite_block(*a, block=2, interpret=True))):
        want = _jax_gfeat(fn, scene, cots)
        for col in range(9 + C):
            scale = float(np.abs(want[..., col]).max())
            np.testing.assert_allclose(got[..., col], want[..., col],
                                       atol=max(4e-5 * scale, 1e-7), rtol=5e-4,
                                       err_msg=f"{name} column {col}")
    # On CPU tensors the wrapper's backward is the plain version, through
    # autograd, and composite_block_bwd is the same function.
    leaves = [t(scene[i]).requires_grad_() for i in (0, 1, 2, 4, 5)]
    out = tbc.composite_block(leaves[0], leaves[1], leaves[2], t(scene[3]), leaves[3],
                              leaves[4], t(scene[6]))
    gacc, gcorr, gT = (t(a) for a in cots)
    torch.autograd.backward(out, (gacc.transpose(1, 2), gcorr, gT))
    via = torch.cat([leaves[0].grad, leaves[1].grad, leaves[2].grad[..., None],
                     torch.zeros_like(leaves[2].grad)[..., None], leaves[4].grad,
                     leaves[3].grad], -1)
    assert_close(via, got, 0)
    assert_close(tbc.composite_block_bwd(*(t(a) for a in scene), gacc, gcorr, gT), got, 0)


def _gaussians(n_pts, seed, C=3):
    rng = np.random.RandomState(seed)
    means = (rng.randn(n_pts, 3) * 0.3).astype(np.float32)
    q = rng.randn(n_pts, 4).astype(np.float32)
    quats = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s = (np.abs(rng.randn(n_pts, 1)) * 0.03 + 0.02).astype(np.float32)
    scales = np.concatenate([s, s, np.zeros_like(s)], -1)
    colors = rng.uniform(0, 1, (n_pts, C)).astype(np.float32)
    occ = rng.uniform(0, 1, (n_pts, 3)).astype(np.float32)
    return means, quats, scales, np.ones(n_pts, np.float32), colors, occ


def _camera():
    pos = np.array([0.6, 0.4, 2.6], np.float32)
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 1.0, 0.0]); right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, up, -fwd], -1)
    c2w[:3, 3] = pos
    fov = np.float32(np.deg2rad(40.0))
    from soar_tpu.core import camera as jcam

    return (jcam.camera_from_c2w(jnp.asarray(c2w), jnp.asarray(fov), jnp.asarray(fov)),
            tcam.camera_from_c2w(t(c2w), fov, fov))


def _loss_weights(size, seed):
    rng = np.random.RandomState(seed)
    H, W = size
    return {k: rng.randn(*shape).astype(np.float32) for k, shape in
            (("color", (H, W, 3)), ("normal", (H, W, 3)), ("opac", (H, W)),
             ("depth", (H, W)), ("occ", (H, W, 3)))}


def _loss(outs, occ, r, mask, xp):
    tot = 0.0
    for o in outs:
        tot = tot + xp.sum(o.color * r["color"]) + xp.sum(o.normal * r["normal"])
        tot = tot + xp.sum(o.opac * r["opac"]) + xp.sum(o.depth * mask * r["depth"])
    return tot + xp.sum(occ.color * r["occ"])


# (function, composite_dtype, tolerance as a share of each gradient's
# largest magnitude, share of entries allowed beyond it)
RASTER_CASES = {
    "with_occ_f32": ("with_occ", "f32", 1e-3, 0.01),
    "front_back_f32": ("front_back", "f32", 1e-3, 0.01),
    "front_back_bf16": ("front_back", "bf16", 2e-2, 0.02),
}


@pytest.mark.parametrize("case", sorted(RASTER_CASES))
def test_rasterizer_gradients_match_jax(case):
    fn_name, dtype, tol, share = RASTER_CASES[case]
    size = (48, 64)
    means, quats, scales, opac, colors, occ = _gaussians(1500, seed=21)
    jc, tc = _camera()
    bg = np.array([0.3, 0.6, 0.9], np.float32)
    jcfg = jtypes.RasterConfig(composite="xla", composite_dtype=dtype, max_per_tile=48, dup_side=3)
    tcfg = ttypes.RasterConfig(composite="plain", composite_dtype=dtype, max_per_tile=48,
                               dup_side=3)
    r = _loss_weights(size, seed=22)

    def run_j(m, q, s, c, o):
        g = jtypes.GaussianInputs(m, q, s, jnp.asarray(opac), c)
        if fn_name == "with_occ":
            main, occ_out = jtiled.rasterize_with_occ(g, o, jc, size, jnp.asarray(bg), jcfg)
            return (main,), occ_out
        f, b, occ_out = jtiled.rasterize_front_back(g, o, jc, size, jnp.asarray(bg), jcfg)
        return (f, b), occ_out

    def run_t(m, q, s, c, o):
        g = ttypes.GaussianInputs(m, q, s, t(opac), c)
        if fn_name == "with_occ":
            main, occ_out = ttiled.rasterize_with_occ(g, o, tc, size, t(bg), tcfg)
            return (main,), occ_out
        f, b, occ_out = ttiled.rasterize_front_back(g, o, tc, size, t(bg), tcfg)
        return (f, b), occ_out

    inputs = (means, quats, scales, colors, occ)
    j_outs, _ = run_j(*(jnp.asarray(a) for a in inputs))
    mask = (n(j_outs[0].opac) > 0.5).astype(np.float32)
    assert mask.mean() > 0.05
    jr = {k: jnp.asarray(v) for k, v in r.items()}
    jgrads = jax.grad(lambda *a: _loss(*run_j(*a), jr, jnp.asarray(mask), jnp),
                      argnums=(0, 1, 2, 3, 4))(*(jnp.asarray(a) for a in inputs))
    leaves = [t(a).requires_grad_() for a in inputs]
    t_outs, t_occ = run_t(*leaves)
    _loss(t_outs, t_occ, {k: t(v) for k, v in r.items()}, t(mask), torch).backward()
    for name, leaf, jg in zip(("means", "quats", "scales", "colors", "occ"), leaves, jgrads):
        jg = np.asarray(jg)
        scale = float(np.abs(jg).max())
        assert scale > 0, name
        assert_close_share(leaf.grad, jg, tol * scale, share, msg=f"{case} d/d{name}")
    # The values too, before the gradients reach them.
    for got, want in zip(t_outs, j_outs):
        assert_close_share(got.color, want.color, 1e-4 if dtype == "f32" else 2e-2, share,
                           msg=f"{case} color")


def test_both_faces_render_view_matches_jax():
    jparams, jmodel, tparams, tmodel = small_avatar()
    size = (64, 64)
    # The synthetic sequence's camera (no rotation, fov of focal 1.2 x
    # size), moved to z = -0.8: the body stands at z = -1.8.
    fov = np.float32(2 * np.arctan(0.5 / 1.2))
    c2w = np.eye(4, dtype=np.float32)
    c2w[2, 3] = -0.8
    from soar_tpu.core import camera as jcam

    jc = jcam.camera_from_c2w(jnp.asarray(c2w), jnp.asarray(fov), jnp.asarray(fov))
    tc = tcam.camera_from_c2w(t(c2w), fov, fov)
    jset = JSettings(both_faces=True, raster=jtypes.RasterConfig(composite="xla", max_per_tile=64))
    tset = RenderSettings(both_faces=True, raster=ttypes.RasterConfig(max_per_tile=64))
    jf, jbk = jrender_view(jparams, jmodel, jc, size, jnp.ones(3), jnp.asarray(1), jset)
    tf, tbk = render_view(tparams, tmodel, tc, size, torch.ones(3), 1, tset)
    for label, got, want in (("front", tf, jf), ("back", tbk, jbk)):
        for k in ("render", "normal", "mask", "occ"):
            assert_close_share(got[k], want[k], 1e-4, 0.01, msg=f"{label} {k}")
        inside = n(want["mask"]) > 0.5
        assert inside.sum() > 100  # the thin procedural body covers ~4%
        assert_close_share(n(got["depth"])[inside], n(want["depth"])[inside], 1e-3, 0.01,
                           msg=f"{label} depth")
        np.testing.assert_array_equal(n(got["overflow"]), n(want["overflow"]))
    # The back surface is another image than the front one, and the occ
    # image is shared.
    assert float((tf["normal"] - tbk["normal"]).abs().max()) > 0.1
    assert torch.equal(tf["occ"], tbk["occ"])
