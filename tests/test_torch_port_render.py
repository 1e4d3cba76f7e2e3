"""Parity of the port's render stack with soar_tpu: tile grid, preprocess,
binning and sort, the composite (plain version and kernel wrapper),
rasterize / rasterize_with_occ and the post ops.  ``tests/data/preprocess_jax.npz``
records soar_tpu's preprocess, forward and gradients, for the port's CUDA
kernel (tests/test_torch_port_preprocess_kernel.py); ``python
tests/test_torch_port_render.py`` writes it, and a test here checks it.

Tolerances:
- integer outputs (sort order, tile ranges, overflow canaries, culling
  masks) must be equal;
- float32 with the same arithmetic agrees to ~1e-6 at these magnitudes, so
  1e-5 absolute unless stated;
- the JAX Pallas composite computes T as ``exp(cumsum(log1p(-alpha)))``,
  ~1e-6 relative from the sequential product; where that flips the
  T < 1e-4 early stop for a pixel, the pixel's outputs differ by up to one
  splat's weight.  Such pixels are counted and held to a stated share.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.core import camera as jcam
from soar_tpu.core.transforms import quat_normalize
from soar_tpu.render import composite as jcomp
from soar_tpu.render import postprocess as jpost
from soar_tpu.render import preprocess as jpre
from soar_tpu.render import tiled as jtiled
from soar_tpu.render import tilegrid as jtg
from soar_tpu.render import types as jtypes
from soar_tpu.render.block_composite import composite_block as jcomposite_block
from soar_tpu_torch.core import camera as tcam
from soar_tpu_torch.render import block_composite as tbc
from soar_tpu_torch.render import composite as tcomp
from soar_tpu_torch.render import postprocess as tpost
from soar_tpu_torch.render import preprocess as tpre
from soar_tpu_torch.render import tiled as ttiled
from soar_tpu_torch.render import tilegrid as ttg
from soar_tpu_torch.render import types as ttypes
from torch_port_helpers import (
    PREP_CAMERA,
    PREP_FIELDS,
    PREP_FOV,
    PREP_JAX_CASES,
    PREP_JAX_FILE,
    PREP_PRCP,
    PREP_SIZE,
    assert_close,
    assert_close_share,
    assert_preprocess_matches_record,
    make_scene,
    n,
    prep_jax_case,
    prep_masked_cot,
    t,
)


# ------------------------------------------------------------------ tile grid


def test_tilegrid_matches_jax():
    rng = np.random.RandomState(0)
    ntx, NT = 5, 20
    mnx = rng.randint(0, 5, 50).astype(np.int32)
    mny = rng.randint(0, 4, 50).astype(np.int32)
    mxx = np.minimum(mnx + rng.randint(0, 4, 50), 5).astype(np.int32)
    mxy = np.minimum(mny + rng.randint(0, 4, 50), 4).astype(np.int32)
    ok = rng.rand(50) > 0.2
    want = jtg.slot_tiles(3, *(jnp.asarray(a) for a in (mnx, mny, mxx, mxy, ok)), ntx, NT)
    got = ttg.slot_tiles(3, *(t(a).long() for a in (mnx, mny, mxx, mxy)), t(ok), ntx, NT)
    np.testing.assert_array_equal(n(got), n(want))

    st = np.sort(rng.randint(0, NT + 1, 300)).astype(np.int32)
    js, jc = jtg.tile_ranges(jnp.asarray(st), NT)
    ts, tc = ttg.tile_ranges(t(st).long(), NT)
    np.testing.assert_array_equal(n(ts), n(js))
    np.testing.assert_array_equal(n(tc), n(jc))

    for NTx in (1, 64, 1024, 4095):
        assert ttg.depth_bits_for(NTx) == jtg.depth_bits_for(NTx)
    assert ttg.cdiv(513, 16) == jtg.cdiv(513, 16) == 33

    depth = rng.uniform(0.5, 3.0, 1000).astype(np.float32)
    valid = rng.rand(1000) > 0.1
    # db = 25 > 24: f32 rounds 2^db - 1 up, which the clamp after the cast
    # must catch; db = 12 is the coarse case.
    for db in (12, 21, 25):
        want = jtg.quantize_depth(jnp.asarray(depth), jnp.asarray(valid), db)
        got = ttg.quantize_depth(t(depth), t(valid), db)
        np.testing.assert_array_equal(n(got).astype(np.int64), n(want).astype(np.int64))
        assert int(got.max()) <= 2**db - 1

    img = rng.rand(20, 256, 3).astype(np.float32)
    assert_close(ttg.untile(t(img), 3, 5, 4, 16, 60, 70),
                 jtg.untile(jnp.asarray(img), 3, 5, 4, 16, 60, 70), 0)


# ---------------------------------------------------------------- composite


def xla_composite(xy, conic, opac, valid, attrs, e, pixf):
    """tests/test_block_composite.py's reference: the XLA chain."""
    d = xy[:, None, :, :] - pixf[:, :, None, :]
    alpha = jcomp.splat_alpha(d, conic[:, None], opac[:, None], valid[:, None])
    weights, t_final = jcomp.composite_weights(alpha)
    accum = jnp.einsum("npk,nkc->npc", weights, attrs)
    corr = jnp.sum(
        weights * (d[..., 0] * e[:, None, :, 0] + d[..., 1] * e[:, None, :, 1]),
        axis=-1,
    )
    return accum, corr, t_final


@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("C", [7, 3])
def test_composite_block_plain_matches_jax(saturate, C):
    scene = make_scene(NT=8, K=32, C=C, seed=1, saturate=saturate)
    got = tcomp.composite_block_plain(*(t(a) for a in scene))
    jin = tuple(jnp.asarray(a) for a in scene)
    # The XLA chain is the same cumprod arithmetic: 1e-5 everywhere.
    for g, w, name in zip(got, xla_composite(*jin), ("accum", "corr", "T")):
        assert_close(g, w, 1e-5, msg=f"xla {name}")
    # Pallas (interpret): log-space T; allow 1% of pixels a cutoff flip.
    pallas = jcomposite_block(*jin, block=1, interpret=True)
    for g, w, name in zip(got, pallas, ("accum", "corr", "T")):
        assert_close_share(g, w, 1e-5, 0.01, msg=f"pallas {name}")
    # On a CPU tensor the wrapper is the plain version.
    via = tbc.composite_block(*(t(a) for a in scene))
    for g, w in zip(via, got):
        assert torch.equal(g, w)


def test_composite_pieces_match_jax():
    rng = np.random.RandomState(2)
    d = rng.uniform(-8, 8, (4, 9, 10, 2)).astype(np.float32)
    conic = rng.uniform(0.02, 0.3, (4, 1, 10, 3)).astype(np.float32)
    op = rng.uniform(0.2, 1.0, (4, 1, 10)).astype(np.float32)
    valid = rng.rand(4, 1, 10) > 0.2
    ja = jcomp.splat_alpha(*(jnp.asarray(a) for a in (d, conic, op, valid)))
    ta = tcomp.splat_alpha(t(d), t(conic), t(op), t(valid))
    assert_close(ta, ja, 1e-6)
    jw, jT = jcomp.composite_weights(ja)
    tw, tT = tcomp.composite_weights(t(np.asarray(ja)))
    assert_close(tw, jw, 1e-6)
    assert_close(tT, jT, 1e-6)
    cols = rng.rand(4, 9, 10, 3).astype(np.float32)
    nrm = rng.rand(4, 9, 10, 3).astype(np.float32)
    dep = rng.rand(4, 9, 10).astype(np.float32)
    bg = np.array([0.2, 0.5, 1.0], np.float32)
    for surface in (True, False):
        for nd in (True, False):
            want = jcomp.finalize(jw, jT, jnp.asarray(cols), jnp.asarray(nrm),
                                  jnp.asarray(dep), jnp.asarray(bg), surface, nd)
            got = tcomp.finalize(tw, tT, t(cols), t(nrm), t(dep), t(bg), surface, nd)
            for g, w in zip(got, want):
                assert_close(g, w, 1e-4)
    acc_c, acc_n, acc_d = cols[..., 0, :], nrm[..., 0, :], dep[..., 0]
    want = jcomp.finalize_accum(jnp.asarray(acc_c), jnp.asarray(acc_n), jnp.asarray(acc_d),
                                jT, jnp.asarray(bg), True)
    got = tcomp.finalize_accum(t(acc_c), t(acc_n), t(acc_d), tT, t(bg), True)
    for g, w in zip(got, want):
        assert_close(g, w, 1e-4)


# ------------------------------------------------------- preprocess / sort


def make_gaussians(n_pts=300, seed=0, spread=0.4, C=3):
    rng = np.random.RandomState(seed)
    means = (rng.randn(n_pts, 3) * spread).astype(np.float32)
    quats = np.asarray(quat_normalize(jnp.asarray(rng.randn(n_pts, 4).astype(np.float32))))
    scales = (np.abs(rng.randn(n_pts, 3)) * 0.05 + 0.02).astype(np.float32)
    opac = rng.uniform(0.3, 1.0, n_pts).astype(np.float32)
    colors = rng.uniform(0, 1, (n_pts, C)).astype(np.float32)
    arrs = (means, quats, scales, opac, colors)
    return (jtypes.GaussianInputs(*(jnp.asarray(a) for a in arrs)),
            ttypes.GaussianInputs(*(t(a) for a in arrs)))


def make_cameras(dist=3.0, fov_deg=40.0, azim=0.3, elev=0.2):
    pos = np.array([dist * np.cos(elev) * np.sin(azim), dist * np.sin(elev),
                    dist * np.cos(elev) * np.cos(azim)], np.float32)
    c2w = np.asarray(jcam.look_at_c2w(jnp.asarray(pos), jnp.zeros(3),
                                      jnp.array([0.0, 1.0, 0.0])))
    fov = np.float32(np.deg2rad(fov_deg))
    prcp = np.array([0.48, 0.52], np.float32)
    return (jcam.camera_from_c2w(jnp.asarray(c2w), jnp.asarray(fov), jnp.asarray(fov),
                                 prcppoint=jnp.asarray(prcp)),
            tcam.camera_from_c2w(t(c2w), fov, fov, prcppoint=t(prcp)))


CFGS = {
    "default": dict(),
    # fat_budget < N: the two-tier slot budget with a capped surfel, and a
    # small K so the dropped canary fires.
    "two_tier": dict(fat_budget=6, max_per_tile=24),
    "front_desc": dict(render_front=True, sort_descending=True, dup_side=3),
}


def _cfg_pair(name, **extra):
    kw = dict(CFGS[name], **extra)
    tkw = dict(kw)
    if "composite" in tkw:
        tkw["composite"] = "plain"
    return jtypes.RasterConfig(**kw), ttypes.RasterConfig(**tkw)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_preprocess_and_bin_and_sort_match_jax(name):
    jg, tg = make_gaussians(400, seed=3)
    jc, tc = make_cameras()
    jcfg, tcfg = _cfg_pair(name)
    size = (96, 80)
    jp = jpre.preprocess(jg, jc, size, jcfg)
    tp = tpre.preprocess(tg, tc, size, tcfg)
    np.testing.assert_array_equal(n(tp.valid), n(jp.valid))
    v = n(jp.valid)
    for f in ("xy", "depth", "conic", "normal_view", "view_dot", "jinv"):
        assert_close(n(getattr(tp, f))[v], n(getattr(jp, f))[v], 1e-4, 1e-5, msg=f)
    np.testing.assert_array_equal(n(tp.radius)[v], n(jp.radius)[v])

    # Binning and sort from the SAME preprocessed input must be exact.
    tp_same = ttypes.Preprocessed(*(t(a) for a in jp))
    out_j = jtiled.bin_and_sort(jp, size, jcfg)
    out_t = ttiled.bin_and_sort(tp_same, size, tcfg)
    for g, w, what in zip(out_t, out_j, ("sorted_idx", "starts", "counts", "grid", "overflow")):
        if what == "grid":
            assert g == w
        else:
            np.testing.assert_array_equal(n(g).astype(np.int64), n(w).astype(np.int64), err_msg=what)
    if name == "two_tier":
        assert n(out_t[4])[0] > 0 and n(out_t[4])[1] > 0, n(out_t[4])


def test_preprocess_gradient_is_finite_with_a_splat_on_the_camera_plane():
    """A splat at view-space z = 0 is culled, and its footprint divides by
    z.  In the JAX package its zero cotangent times the NaN footprint makes
    its gradient NaN (a shared parameter such as the field would take it);
    the port clamps a culled splat's depth in those terms, so every gradient
    is finite and the kept splats' values and gradients are JAX's."""
    rng = np.random.RandomState(4)
    N = 12
    means = (rng.randn(N, 3) * 0.3).astype(np.float32)
    means[:, 2] -= 3.0
    means[0] = [0.5, 0.2, 0.0]  # on the plane of the identity camera
    means[1] = [0.1, -0.3, 0.05]  # in front of the near plane
    quats = np.asarray(quat_normalize(jnp.asarray(rng.randn(N, 4).astype(np.float32))))
    rest = (np.full((N, 3), 0.05, np.float32), np.full(N, 0.5, np.float32),
            rng.rand(N, 3).astype(np.float32))
    c2w, fov, size = np.eye(4, dtype=np.float32), np.float32(0.8), (64, 64)
    jc = jcam.camera_from_c2w(jnp.asarray(c2w), jnp.asarray(fov), jnp.asarray(fov))
    tc = tcam.camera_from_c2w(t(c2w), fov, fov)

    def jloss(m):
        g = jtypes.GaussianInputs(m, jnp.asarray(quats), *(jnp.asarray(a) for a in rest))
        p = jpre.preprocess(g, jc, size, jtypes.RasterConfig())
        kept = p.valid[:, None]
        return jnp.sum(jnp.where(kept, p.conic, 0.0)) + jnp.sum(jnp.where(kept, p.jinv, 0.0)), p

    (_, jp), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(means))
    m = t(means).requires_grad_(True)
    tp = tpre.preprocess(ttypes.GaussianInputs(m, t(quats), *(t(a) for a in rest)), tc, size,
                         ttypes.RasterConfig())
    kept = tp.valid[:, None]
    (torch.where(kept, tp.conic, 0.0).sum() + torch.where(kept, tp.jinv, 0.0).sum()).backward()
    v = n(jp.valid)
    assert not v[0] and not v[1] and v[2:].sum() >= 8
    np.testing.assert_array_equal(n(tp.valid), v)
    assert not np.isfinite(np.asarray(jgrad)[0]).all()  # the JAX package's NaN
    assert bool(torch.isfinite(m.grad).all())
    assert not bool(m.grad[:2].any())  # culled splats get no gradient
    for f in ("conic", "jinv", "radius"):
        assert_close(n(getattr(tp, f))[v], n(getattr(jp, f))[v], 1e-4, 1e-5, msg=f)
    assert_close(m.grad[2:], np.asarray(jgrad)[2:], 1e-4, 1e-4)


def _jax_preprocess_case(case):
    """soar_tpu's preprocess of ``prep_jax_case``'s surfels under
    ``PREP_JAX_CASES[case]``: its camera's arrays, the outputs, and jax.grad
    of sum(output * cotangent), the cotangents zero on the culled surfels,
    for the means, quaternions and scales (numpy, keyed as the file is)."""
    means, quats, scales, cot = prep_jax_case()
    N = means.shape[0]
    cam = jcam.camera_from_c2w(jnp.eye(4), jnp.asarray(PREP_FOV, jnp.float32),
                               jnp.asarray(PREP_FOV, jnp.float32),
                               prcppoint=jnp.asarray(PREP_PRCP, jnp.float32))
    cfg = jtypes.RasterConfig(**PREP_JAX_CASES[case])
    rest = (jnp.ones((N,)), jnp.zeros((N, 3)))

    def run(m, q, s):
        return jpre.preprocess(jtypes.GaussianInputs(m, q, s, *rest), cam, PREP_SIZE, cfg)

    pre = run(*(jnp.asarray(a) for a in (means, quats, scales)))
    masked = prep_masked_cot(cot, n(pre.valid))

    def loss(m, q, s):
        p = run(m, q, s)
        return sum(jnp.sum(getattr(p, f) * masked[f]) for f in PREP_FIELDS)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (means, quats, scales)))
    out = {f"camera_{k}": n(getattr(cam, k)) for k in PREP_CAMERA}
    out.update({f"{case}_{f}": n(getattr(pre, f)) for f in PREP_FIELDS + ("valid", "radius")})
    out.update({f"{case}_grad_{k}": n(g) for k, g in zip(("means3d", "quats", "scales"), grads)})
    return out


def record_jax_preprocess(path=PREP_JAX_FILE):
    """Writes soar_tpu's preprocess of the ``PREP_JAX_CASES`` to ``path``."""
    arrays = {}
    for case in PREP_JAX_CASES:
        arrays.update(_jax_preprocess_case(case))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **arrays)


@pytest.mark.parametrize("case", list(PREP_JAX_CASES))
def test_recorded_jax_preprocess_is_soar_tpus_and_the_ports(case):
    """The file the kernel's card tests read holds what soar_tpu gives now,
    and the port's plain path on the CPU matches it: the forward, and the
    means', quaternions' and scales' gradients against jax.grad."""
    want = _jax_preprocess_case(case)
    rec = np.load(PREP_JAX_FILE)
    for k, a in want.items():
        np.testing.assert_allclose(rec[k], a, rtol=1e-6, atol=1e-6, err_msg=k)
    valid = rec[f"{case}_valid"]
    assert not valid[:3].any() and valid[3:9].any() and 0.3 * len(valid) < valid.sum()
    assert not np.isfinite(rec[f"{case}_grad_means3d"][0]).all()  # the JAX package's NaN
    means, quats, scales, cot = prep_jax_case()
    cam = tcam.Camera(*(t(rec[f"camera_{k}"]) for k in PREP_CAMERA))
    leaves = [t(a).requires_grad_() for a in (means, quats, scales)]
    g = ttypes.GaussianInputs(*leaves, torch.ones(len(means)), torch.zeros(len(means), 3))
    pre = tpre.preprocess_plain(g, cam, PREP_SIZE, ttypes.RasterConfig(**PREP_JAX_CASES[case]))
    masked = prep_masked_cot(cot, valid)
    loss = sum((getattr(pre, f) * t(masked[f])).sum() for f in PREP_FIELDS
               if getattr(pre, f).requires_grad)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, grads)]
    assert_preprocess_matches_record(pre, grads, rec, case, case)


# --------------------------------------------------------------- rasterize


@pytest.mark.parametrize("composite", ["pallas", "xla"])
@pytest.mark.parametrize("name", ["default", "two_tier"])
def test_rasterize_with_occ_matches_jax(composite, name):
    jg, tg = make_gaussians(500, seed=4, spread=0.35)
    jc, tc = make_cameras(azim=0.7)
    jcfg, tcfg = _cfg_pair(name, composite=composite)
    size = (64, 80)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    occ = np.random.RandomState(5).rand(500, 3).astype(np.float32)
    jmain, jocc = jtiled.rasterize_with_occ(jg, jnp.asarray(occ), jc, size, jnp.asarray(bg), jcfg)
    tmain, tocc = ttiled.rasterize_with_occ(tg, t(occ), tc, size, t(bg), tcfg)
    tonly = ttiled.rasterize(tg, tc, size, t(bg), tcfg)
    # Preprocess agrees to ~1e-6 relative, so a pixel near a splat's
    # alpha/T threshold may flip: allow 1% of pixels, 1e-4 elsewhere.
    share = 0.01
    for f in ("color", "normal", "opac", "transmittance"):
        assert_close_share(getattr(tmain, f), getattr(jmain, f), 1e-4, share, msg=f)
        assert torch.equal(getattr(tonly, f), getattr(tmain, f))
    # Depth is normalized by 1 - T, which amplifies errors where coverage
    # is thin: compare inside the mask (opacity > 0.5) at 1e-3.
    m = n(jmain.opac) > 0.5
    assert m.mean() > 0.05
    assert_close_share(n(tmain.depth)[m], n(jmain.depth)[m], 1e-3, share, msg="depth")
    np.testing.assert_array_equal(n(tmain.overflow), n(jmain.overflow))
    np.testing.assert_array_equal(n(tmain.visible), n(jmain.visible))
    for f in ("color", "opac", "transmittance"):
        assert_close_share(getattr(tocc, f), getattr(jocc, f), 1e-4, share, msg=f"occ {f}")


# -------------------------------------------------------------- postprocess


def test_postprocess_matches_jax():
    rng = np.random.RandomState(6)
    H, W = 24, 20
    depth = rng.uniform(1.0, 2.0, (H, W)).astype(np.float32)
    mask = rng.rand(H, W) > 0.3
    normal = rng.randn(H, W, 3).astype(np.float32)
    jc, tc = make_cameras()
    assert_close(tpost.depth2normal(t(depth), t(mask), tc, (H, W)),
                 jpost.depth2normal(jnp.asarray(depth), jnp.asarray(mask), jc, (H, W)), 1e-5)
    assert_close(tpost.normal2curv(t(normal), t(mask)),
                 jpost.normal2curv(jnp.asarray(normal), jnp.asarray(mask)), 1e-5)


if __name__ == "__main__":
    record_jax_preprocess()
    print(f"wrote {PREP_JAX_FILE}")
