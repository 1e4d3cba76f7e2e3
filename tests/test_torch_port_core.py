"""Parity of the port's core, body and avatar-state modules with soar_tpu.

Inputs are made with numpy from a seed and fed to the JAX function and to
its ``soar_tpu_torch`` counterpart on the CPU.  Tolerances: float32 with
the same arithmetic in both packages agrees to ~1e-6 absolute at these
magnitudes (the two libraries reduce and fuse in different orders), so
1e-5 is used unless a comment says otherwise; numpy-only code must match
exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.avatar import state as jstate
from soar_tpu.body import model as jbody
from soar_tpu.body import skinning as jskin
from soar_tpu.body import template as jtpl
from soar_tpu.core import camera as jcam
from soar_tpu.core import transforms as jtf
from soar_tpu.render import types as jtypes
from soar_tpu_torch.avatar import state as tstate
from soar_tpu_torch.body import model as tbody
from soar_tpu_torch.body import skinning as tskin
from soar_tpu_torch.body import template as ttpl
from soar_tpu_torch.core import camera as tcam
from soar_tpu_torch.core import transforms as ttf
from soar_tpu_torch.render import types as ttypes
from torch_port_helpers import assert_close, body_to_numpy, n, t

REPO = Path(__file__).resolve().parents[1]


def _rand_rotmats(rng, m):
    q = rng.randn(m, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jtf.quat_to_rotmat(jnp.asarray(q)))


# ---------------------------------------------------------------- transforms


def test_transforms_match_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(64, 4).astype(np.float32)
    v = rng.randn(64, 3).astype(np.float32)
    assert_close(ttf.quat_normalize(t(q)), jtf.quat_normalize(jnp.asarray(q)), 1e-6)
    assert_close(ttf.safe_normalize(t(v)), jtf.safe_normalize(jnp.asarray(v)), 1e-6)
    assert_close(ttf.quat_to_rotmat(t(q)), jtf.quat_to_rotmat(jnp.asarray(q)), 1e-5)
    R = _rand_rotmats(rng, 64)
    assert_close(ttf.rotmat_to_quat(t(R)), jtf.rotmat_to_quat(jnp.asarray(R)), 1e-6)
    assert_close(ttf.batch_rodrigues(t(v)), jtf.batch_rodrigues(jnp.asarray(v)), 1e-6)
    Rv = t(R)
    assert_close(ttf.transform_mat(Rv, t(v)), jtf.transform_mat(jnp.asarray(R), jnp.asarray(v)), 0)


@pytest.mark.parametrize("angle", [0.0, 1e-7, 0.5, np.pi - 1e-4, np.pi])
def test_rotmat_to_rotvec_matches_jax_including_pi(angle):
    rng = np.random.RandomState(1)
    axes = rng.randn(16, 3).astype(np.float32)
    axes = np.concatenate([np.eye(3, dtype=np.float32), axes])
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    rv = (axes * angle).astype(np.float32)
    R = np.asarray(jtf.batch_rodrigues(jnp.asarray(rv)))
    got = ttf.rotmat_to_rotvec(t(R))
    want = jtf.rotmat_to_rotvec(jnp.asarray(R))
    # At pi the axis sign is a convention: both packages pick w >= 0 and
    # the same candidate, so they agree elementwise.
    assert_close(got, want, 1e-5)
    assert_close(ttf.batch_rodrigues(got), R, 1e-5)


# ------------------------------------------------------------------- camera


def test_camera_chain_matches_jax():
    rng = np.random.RandomState(2)
    R = _rand_rotmats(rng, 1)[0]
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R
    c2w[:3, 3] = rng.randn(3)
    # convert_pose's flips are exact sign changes.
    assert_close(tcam.convert_pose(t(c2w)), jcam.convert_pose(jnp.asarray(c2w)), 0)
    fovx, fovy = np.float32(0.7), np.float32(0.6)
    prcp = np.array([0.47, 0.53], np.float32)
    jc = jcam.camera_from_c2w(jnp.asarray(c2w), jnp.asarray(fovx), jnp.asarray(fovy),
                              prcppoint=jnp.asarray(prcp))
    tc = tcam.camera_from_c2w(t(c2w), fovx, fovy, prcppoint=t(prcp))
    for name in jc._fields:
        assert_close(getattr(tc, name), getattr(jc, name), 1e-5, msg=name)
    # Principal point inside the projection (the normal camera's form).
    jc2 = jcam.camera_from_c2w(jnp.asarray(c2w), jnp.asarray(fovx), jnp.asarray(fovy),
                               cxcy=(jnp.asarray(250.0), jnp.asarray(262.0)),
                               img_wh=(512, 512))
    tc2 = tcam.camera_from_c2w(t(c2w), fovx, fovy, cxcy=(250.0, 262.0), img_wh=(512, 512))
    assert_close(tc2.full_proj, jc2.full_proj, 1e-5)
    assert_close(tcam.focal_from_fov(torch.tensor(0.7), 512),
                 jcam.focal_from_fov(jnp.asarray(0.7), 512), 1e-4)
    v = rng.uniform(-1, 1, 32).astype(np.float32)
    assert_close(tcam.ndc2pix(t(v), 512, 0.47), jcam.ndc2pix(jnp.asarray(v), 512, 0.47), 1e-4)


# --------------------------------------------------------------------- body


def _bodies(**kw):
    return jbody.make_test_body(**kw), tbody.make_test_body(**kw, device="cpu")


def test_make_test_body_is_exact():
    jb, tb = _bodies(num_joints=5, segments_per_bone=3, ring=7)
    want = body_to_numpy(jb)
    got = body_to_numpy(tb)
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights", "faces"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["parents"] == want["parents"] and got["num_betas"] == want["num_betas"]
    # The CLI's "test:J,S,R" body spec builds the same body.
    from soar_tpu.cli.common import load_body_model as jload
    from soar_tpu_torch.cli.common import load_body_model as tload

    via = body_to_numpy(tload("test:5,3,7", device="cpu"))
    jvia = body_to_numpy(jload("test:5,3,7"))
    for k in ("v_template", "lbs_weights", "faces"):
        np.testing.assert_array_equal(via[k], jvia[k], err_msg=k)
    # Any other name is a model file, read as in the JAX package.
    for load in (jload, lambda m: tload(m, device="cpu")):
        with pytest.raises(FileNotFoundError):
            load("model.npz")


def test_lbs_and_smplx_forward_match_jax():
    jb, tb = _bodies(num_joints=5, segments_per_bone=3, ring=7)
    rng = np.random.RandomState(3)
    F = 3
    params = {
        "betas": rng.randn(1, jb.num_betas).astype(np.float32),
        "body_pose": (rng.randn(F, 12) * 0.3).astype(np.float32),
        "global_orient": (rng.randn(F, 3) * 0.3).astype(np.float32),
        "transl": rng.randn(F, 3).astype(np.float32),
    }
    jo = jbody.smplx_forward(jb, {k: jnp.asarray(v) for k, v in params.items()})
    to = tbody.smplx_forward(tb, {k: t(v) for k, v in params.items()})
    for name in ("vertices", "joints", "A"):
        assert_close(getattr(to, name), getattr(jo, name), 1e-5, msg=name)


# ----------------------------------------------------------------- template


def test_template_init_matches_jax():
    jb, _ = _bodies(num_joints=4, segments_per_bone=3, ring=8)
    v0, f0 = np.asarray(jb.v_template), np.asarray(jb.faces)
    jv, jf = jtpl.subdivide_n(v0, f0, 2)
    tv, tf = ttpl.subdivide_n(v0, f0, 2)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(ttpl.vertex_normals(tv, tf), jtpl.vertex_normals(jv, jf))
    np.testing.assert_array_equal(
        ttpl.vertex_area_radius(tv, tf), jtpl.vertex_area_radius(jv, jf)
    )
    jq, js, jo = jtpl.init_qso_on_mesh(jv, jf, seed=5)
    tq, ts, to = ttpl.init_qso_on_mesh(tv, tf, seed=5)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(to, jo)
    # Same float32 rotmat_to_quat arithmetic; 1e-6 covers the norm's sqrt.
    np.testing.assert_allclose(tq, jq, atol=1e-6)


# ---------------------------------------------------------------- skinning


def test_knn_and_skinning_match_jax_on_random_points():
    rng = np.random.RandomState(4)
    pts = rng.randn(300, 3).astype(np.float32)
    ref = rng.randn(80, 3).astype(np.float32)
    lw = rng.rand(80, 5).astype(np.float32)
    lw /= lw.sum(-1, keepdims=True)
    # Random points have no distance ties, so the neighbour sets agree.
    assert_close(
        tskin.knn_idw_weights(t(pts), t(ref), t(lw), k=30),
        jskin.knn_idw_weights(jnp.asarray(pts), jnp.asarray(ref), jnp.asarray(lw), k=30),
        1e-5,
    )
    assert_close(
        tskin.mean_knn_sq_dist(t(pts), k=3),
        jskin.mean_knn_sq_dist(jnp.asarray(pts), k=3),
        1e-5,
    )
    # Chunking must not change the result.
    neg_a, idx_a = tskin._chunked_topk_neg_dist2(t(pts), t(ref), 7, chunk=64)
    neg_b, idx_b = tskin._chunked_topk_neg_dist2(t(pts), t(ref), 7)
    assert torch.equal(idx_a, idx_b) and torch.equal(neg_a, neg_b)

    A = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    A[:, :3, :3] = _rand_rotmats(rng, 5)
    A[:, :3, 3] = rng.randn(5, 3)
    live = A.copy()
    live[:, :3, 3] += rng.randn(5, 3).astype(np.float32) * 0.1
    jsd = jskin.make_skinning_data(jnp.asarray(lw), jnp.asarray(A), jnp.asarray(ref),
                                   jnp.asarray(pts), k=30)
    tsd = tskin.make_skinning_data(t(lw), t(A), t(ref), t(pts), k=30)
    assert_close(tsd.inv_mats, jsd.inv_mats, 1e-4)
    jm = jskin.point_skinning_mats(jsd, jnp.asarray(live))
    tm = tskin.point_skinning_mats(tsd, t(live))
    assert_close(tm, jm, 1e-4)
    assert_close(tskin.apply_point_mats(tm, t(pts)),
                 jskin.apply_point_mats(jm, jnp.asarray(pts)), 1e-4)


# ------------------------------------------------------------ avatar state


def _smpl_params(F=4, J=4, seed=6):
    rng = np.random.RandomState(seed)
    return {
        "betas": np.zeros((1, 4), np.float32),
        "body_pose": (rng.randn(F, (J - 1) * 3) * 0.1).astype(np.float32),
        "global_orient": (rng.randn(F, 3) * 0.1).astype(np.float32),
        "transl": np.tile([[0.0, 0.2, -1.8]], (F, 1)).astype(np.float32),
    }


def test_init_avatar_matches_jax_on_its_deterministic_parts():
    jb, tb = _bodies(num_joints=4, segments_per_bone=3, ring=8)
    sp = _smpl_params()
    jp, jm = jstate.init_avatar(jb, {k: jnp.asarray(v) for k, v in sp.items()},
                                num_subdiv=1, distill_steps=0)
    tp, tm = tstate.init_avatar(tb, sp, num_subdiv=1, distill_steps=0, device="cpu")
    # xyz comes from LBS (float32, 1e-6) then exact numpy subdivision.
    assert_close(tp.xyz, jp.xyz, 1e-6)
    assert_close(tp.rotation, jp.rotation, 1e-5)
    # scaling = 0.5*log(d2) with d2 ~ 1e-3 from |p|^2 - 2p.r + |r|^2 on
    # |p|^2 ~ 1: the cancellation leaves ~4e-7 absolute on d2, i.e. up to
    # ~2e-4 on the log.
    assert_close(tp.scaling, jp.scaling, 5e-4)
    for name in ("opacity", "colors", "occ", "latent_pose"):
        assert_close(getattr(tp, name), getattr(jp, name), 0, msg=name)
    assert_close(tm.aabb, jm.aabb, 1e-6)
    assert_close(tm.skin.inv_mats, jm.skin.inv_mats, 1e-5)
    assert_close(tm.skin.cano_vertices, jm.skin.cano_vertices, 1e-6)
    # The procedural body is rotationally symmetric: a tie at the 30th
    # neighbour may pick a different vertex, so the blended weights are
    # compared loosely here and carried across in the slice tests.
    assert_close(tm.skin.point_weights, jm.skin.point_weights, 5e-2)
    # The field is drawn from a torch.Generator: shapes and distribution.
    cfg = tm.field_cfg.grid
    enc = tp.field.encoding.detach()
    assert tuple(enc.shape) == tuple(jp.field["encoding"].shape)
    assert float(enc.abs().max()) <= cfg.init_scale
    assert abs(float(enc.mean())) < 0.05 * cfg.init_scale
    w = tp.field.mlp_shs[0].weight.detach()
    assert float(w.abs().max()) <= 1.0 / w.shape[1] ** 0.5
    assert float(tp.field.mlp_offsets[-1].weight.detach().abs().max()) == 0.0
    # Activation getters on the deterministic parameters (scaling carries
    # the 2e-4 above through exp of a ~1e-2 scale).
    for name in ("get_rotation", "get_normal", "get_scaling", "get_opacity", "get_colors",
                 "get_occ"):
        assert_close(getattr(tstate, name)(tp), getattr(jstate, name)(jp), 1e-5, msg=name)
    # distill_steps > 0 distils the field: its result is JAX's reset_field
    # from the same field on the same points (full batch, so no draws).
    # Adam's first steps move each entry by ~lr whatever |g|, so an entry
    # whose gradient is rounding noise may move the other way: 1% of the
    # entries may differ by more than 1e-5.
    from soar_tpu.field.attribute_field import AttributeFieldConfig as JFieldConfig
    from soar_tpu.field.attribute_field import reset_field as jreset_field
    from soar_tpu.field.hashgrid import HashGridConfig as JGridConfig
    from soar_tpu_torch.field.attribute_field import AttributeFieldConfig
    from soar_tpu_torch.field.hashgrid import HashGridConfig

    small = dict(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=12)
    tcfg = AttributeFieldConfig(grid=HashGridConfig(**small), hidden_dim=16)
    jcfg = JFieldConfig(grid=JGridConfig(**small), hidden_dim=16)
    tp0, _ = tstate.init_avatar(tb, sp, num_subdiv=1, field_cfg=tcfg, distill_steps=0,
                                device="cpu")
    tp10, _ = tstate.init_avatar(tb, sp, num_subdiv=1, field_cfg=tcfg, distill_steps=10,
                                 device="cpu")
    assert_close(tp10.xyz, tp0.xyz, 0)
    f0 = tp0.field
    jfield = {"aabb": jnp.asarray(n(f0.aabb)), "encoding": jnp.asarray(n(f0.encoding)),
              "quat_encoding": jnp.asarray(n(f0.quat_encoding))}
    for head in ("mlp_shs", "mlp_scales", "mlp_quats", "mlp_offsets", "mlp_opacities"):
        jfield[head] = [{"w": jnp.asarray(n(lin.weight).T), "b": jnp.asarray(n(lin.bias))}
                        for lin in getattr(f0, head)]
    with torch.no_grad():
        pts = tp0.xyz
        pts2 = torch.cat([pts, pts + 0.001 * tstate.get_normal(tp0)])
        N2 = pts2.shape[0]
        targets = (np.full((N2, 3), 0.5, np.float32),
                   n(torch.cat([tstate.get_scaling(tp0)] * 2)),
                   n(torch.cat([tstate.get_rotation(tp0)] * 2)))
    jf, _ = jreset_field(jfield, jnp.asarray(n(pts2)), *(jnp.asarray(a) for a in targets),
                         cfg=jcfg, steps=10)
    f10 = tp10.field
    for name, got, want in [("encoding", f10.encoding, jf["encoding"]),
                            ("quat_encoding", f10.quat_encoding, jf["quat_encoding"])] + [
            (f"{head}{i}", lin.weight.T, jf[head][i]["w"])
            for head in ("mlp_shs", "mlp_scales", "mlp_quats", "mlp_offsets")
            for i, lin in enumerate(getattr(f10, head))]:
        diff = np.abs(n(got) - np.asarray(want))
        assert np.mean(diff > 1e-5) <= 0.01, (name, float(diff.max()))
    assert float((f10.encoding - f0.encoding).detach().abs().max()) > 1e-4  # it moved


def test_frame_params_and_live_affines_match_jax():
    jb, tb = _bodies(num_joints=4, segments_per_bone=3, ring=8)
    sp = _smpl_params()
    jp, jm = jstate.init_avatar(jb, {k: jnp.asarray(v) for k, v in sp.items()},
                                num_subdiv=0, distill_steps=0)
    tp, tm = tstate.init_avatar(tb, sp, num_subdiv=0, distill_steps=0, device="cpu")
    ov = {"global_orient": np.array([np.pi, 0.0, 0.1], np.float32)}
    for frame, zero_root, override in ((1, False, None), (6, True, None), (2, False, ov)):
        j_ov = t_ov = None
        if override is not None:
            j_ov = {k: jnp.asarray(v) for k, v in override.items()}
            t_ov = {k: t(v) for k, v in override.items()}
        jo = jstate.frame_params(jm, jnp.asarray(frame), zero_root, j_ov)
        to = tstate.frame_params(tm, frame, zero_root, t_ov)
        assert set(to) == set(jo)
        for k in jo:
            assert_close(to[k], jo[k], 0, msg=k)
        assert_close(
            tstate.live_affines(tm, frame, zero_root, t_ov),
            jstate.live_affines(jm, jnp.asarray(frame), zero_root, j_ov),
            1e-5,
        )
    cp_j = jstate.canonical_pose_params(jb, jnp.zeros((1, 4)))
    cp_t = tstate.canonical_pose_params(tb, torch.zeros((1, 4)))
    for k in cp_j:
        assert_close(cp_t[k], cp_j[k], 0, msg=k)


# ---------------------------------------------------------- config / guard


def test_raster_config_defaults_match_jax():
    jc, tc = jtypes.RasterConfig(), ttypes.RasterConfig()
    for f in jc.__dataclass_fields__:
        if f == "composite":
            continue  # "xla"/"pallas" in JAX; "kernel"/"plain" in the port
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.composite == "kernel"
    with pytest.raises(ValueError):
        ttypes.RasterConfig(composite="xla")
    with pytest.raises(ValueError):
        ttypes.RasterConfig(composite_dtype="f16")
    # bf16 constructs, and the plain chain's bf16 output is JAX's XLA bf16
    # chain's (``tiled.py:425-430, 534-546``): alpha rounded to bf16 after
    # the splat set is decided in f32, channels and the per-pixel-slot
    # plane-corrected depth rounded to bf16, sums accumulated in f32.  Both
    # round to 8 bits of mantissa at different places (XLA's and torch's
    # bf16 cumprod), so 2e-2, with 2% of the pixels allowed a T-cutoff flip.
    assert ttypes.RasterConfig(composite_dtype="bf16").composite_dtype == "bf16"
    from soar_tpu.render import composite as jcomp
    from soar_tpu_torch.render import composite as tcomp
    from torch_port_helpers import assert_close_share, make_scene

    xy, conic, opac, valid, attrs, e, pixf = make_scene(NT=6, K=24, C=7, seed=3)
    bf = jnp.bfloat16
    d = jnp.asarray(xy)[:, None] - jnp.asarray(pixf)[:, :, None]
    alpha = jcomp.splat_alpha(d, jnp.asarray(conic)[:, None], jnp.asarray(opac)[:, None],
                              jnp.asarray(valid)[:, None]).astype(bf)
    w, T = jcomp.composite_weights(alpha)
    dif_z = d[..., 0] * jnp.asarray(e)[:, None, :, 0] + d[..., 1] * jnp.asarray(e)[:, None, :, 1]
    depth_k = (jnp.asarray(attrs)[:, None, :, -1] - dif_z).astype(bf)
    want_acc = jnp.einsum("npk,nkc->npc", w, jnp.asarray(attrs).astype(bf),
                          preferred_element_type=jnp.float32)
    want_depth = jnp.einsum("npk,npk->np", w, depth_k, preferred_element_type=jnp.float32)
    acc, corr, tT = tcomp.composite_block_plain(
        *(t(a) for a in (xy, conic, opac, valid, attrs, e, pixf)), compute_dtype=torch.bfloat16)
    assert acc.dtype == corr.dtype == tT.dtype == torch.float32
    assert_close_share(acc[..., :-1], want_acc[..., :-1], 2e-2, 0.02, msg="bf16 accum")
    assert_close_share(acc[..., -1] - corr, want_depth, 2e-2, 0.02, msg="bf16 depth")
    assert_close_share(tT, T.astype(jnp.float32), 2e-2, 0.02, msg="bf16 T")


def test_port_imports_neither_jax_nor_soar_tpu():
    mods = sorted(
        "soar_tpu_torch." + ".".join(p.relative_to(REPO / "soar_tpu_torch").with_suffix("").parts)
        for p in (REPO / "soar_tpu_torch").rglob("*.py")
        if p.name != "__init__.py"
    )
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'soar_tpu', 'cv2', 'PIL', 'yaml'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr

    import re

    files = list((REPO / "soar_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                              REPO / "composite_ab.py"]
    offenders = []
    for p in files:
        src = p.read_text()
        # Mentions inside docstrings and comments name the reference module;
        # only import statements matter.
        for m in re.finditer(r"^\s*(?:import|from)\s+(\S+)", src, re.M):
            mod = m.group(1)
            # The card has no JAX, OpenCV, Pillow or PyYAML.
            if mod.split(".")[0] in ("jax", "soar_tpu", "cv2", "PIL", "yaml"):
                offenders.append(f"{p.relative_to(REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders
