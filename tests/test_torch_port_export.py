"""Parity of the port's inference/export modules with soar_tpu: spherical
harmonics, PLY I/O, the OBJ loader, the Gaussian density field, the
isosurface / cleaning / decimation, Poisson reconstruction and the mesh
export CLI.

Tolerances: SH evaluation is the same polynomial in f32 (1e-6); the density
field sums a few hundred exp() terms whose arguments XLA and eager PyTorch
associate and contract differently (1e-5 relative to the field's maximum);
the host-side numpy code is a copy of the JAX package's, so on the same
input it returns identical arrays; the CLI's OBJ has a vertex count within
2% of the JAX CLI's on the same parameters (a grid point within rounding of
the level can move an isosurface cell).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.core import sh as jsh
from soar_tpu.io import meshing as jmesh
from soar_tpu.io import objmesh as jobj
from soar_tpu.io import ply as jply
from soar_tpu_torch.core import sh as tsh
from soar_tpu_torch.io import meshing as tmesh
from soar_tpu_torch.io import objmesh as tobj
from soar_tpu_torch.io import ply as tply
from torch_port_helpers import assert_close, n, port_copy, small_avatar, t

# ------------------------------------------------------------------------ SH


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_matches_jax(deg):
    rng = np.random.RandomState(deg)
    sh = rng.randn(50, 16, 3).astype(np.float32)
    means = rng.randn(50, 3).astype(np.float32)
    campos = np.array([0.3, -0.2, 2.0], np.float32)
    dirs = means - campos
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    assert_close(tsh.eval_sh(deg, t(sh), t(dirs)), jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)),
                 1e-6, 1e-6)
    got = tsh.eval_sh_color(deg, t(sh), t(means), t(campos))
    want = jsh.eval_sh_color(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(campos))
    assert_close(got, want, 1e-6, 1e-6)
    assert float(got.min()) >= 0.0
    # fewer coefficients than 16 are enough for the active degree
    k = tsh.num_sh_coeffs(deg)
    assert k == jsh.num_sh_coeffs(deg) == (deg + 1) ** 2
    assert torch.equal(tsh.eval_sh(deg, t(sh[:, :k]), t(dirs)), tsh.eval_sh(deg, t(sh), t(dirs)))


def test_sh_rgb_conversions_match_jax():
    rgb = np.random.RandomState(0).rand(20, 3).astype(np.float32)
    assert_close(tsh.rgb_to_sh(t(rgb)), jsh.rgb_to_sh(jnp.asarray(rgb)), 1e-6)
    assert_close(tsh.sh_to_rgb(tsh.rgb_to_sh(t(rgb))), rgb, 1e-6)
    assert (tsh.C0, tsh.C1, tsh.C2, tsh.C3) == (jsh.C0, jsh.C1, jsh.C2, jsh.C3)


# ----------------------------------------------------------------------- PLY


def test_ply_round_trip(tmp_path):
    rng = np.random.RandomState(0)
    props = {k: rng.randn(37).astype(np.float32) for k in ("x", "y", "z", "opacity", "rot_0")}
    path = str(tmp_path / "a.ply")
    tply.write_ply(path, props)
    got = tply.read_ply(path)
    assert list(got) == list(props)
    for k in props:
        np.testing.assert_array_equal(got[k], props[k])
    # the JAX package reads the same columns from the port's file
    for k, v in jply.read_ply(path).items():
        np.testing.assert_array_equal(v, props[k])


def test_avatar_ply_reads_across_packages(tmp_path):
    """The same avatar exported by either package gives the same file
    (property order of soar_tpu/io/ply.py), and each package loads the
    other's file into its own params."""
    jparams, jmodel, tparams, tmodel = small_avatar(seed=1)
    pj, pt = str(tmp_path / "jax.ply"), str(tmp_path / "torch.ply")
    jply.avatar_to_ply(pj, jparams)
    tply.avatar_to_ply(pt, tparams)
    a, b = jply.read_ply(pj), tply.read_ply(pt)
    assert list(a) == list(b)
    assert list(a)[:6] == ["x", "y", "z", "nx", "ny", "nz"] and list(a)[-1] == "occ"
    for k in a:
        assert_close(b[k], a[k], 1e-6, msg=k)

    # JAX's file into the port: perturb first, so loading has to restore.
    fresh, _ = port_copy(jparams, jmodel)
    with torch.no_grad():
        for p in (fresh.xyz, fresh.colors, fresh.scaling, fresh.rotation, fresh.opacity, fresh.occ):
            p.add_(1.0)
    field_before = fresh.field.encoding.detach().clone()
    loaded = tply.ply_to_avatar(pj, fresh)
    assert loaded is fresh
    for k in ("xyz", "colors", "scaling", "rotation", "opacity", "occ"):
        assert isinstance(getattr(loaded, k), torch.nn.Parameter)
        assert_close(getattr(loaded, k), getattr(jparams, k), 1e-6, msg=k)
    assert torch.equal(loaded.field.encoding, field_before)
    # ... and the port's file into JAX.
    back = jply.ply_to_avatar(pt, jparams._replace(xyz=jparams.xyz + 1.0))
    for k in ("xyz", "colors", "scaling", "rotation", "opacity", "occ"):
        assert_close(getattr(back, k), getattr(jparams, k), 1e-6, msg=k)


# ----------------------------------------------------------------------- OBJ

_CUBE = """\
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
v 0 0 1
v 1 0 1
v 1 1 1
v 0 1 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
f 5/1 8/4 7/3 6/2
f 1/1 5/2 6/3 2/4
f 2/1 6/2 7/3 3/4
f 3/1 7/2 8/3 4/4
f 4/1 8/2 5/3 1/4
"""


def test_load_obj_mesh_matches_jax(tmp_path):
    p = tmp_path / "cube.obj"
    p.write_text(_CUBE)
    v, f = tobj.load_obj_mesh(str(p))
    assert v.shape == (8, 3) and f.shape == (12, 3)  # 6 quads fan-triangulated
    got = tobj.load_obj_mesh(str(p), with_texture=True)
    want = jobj.load_obj_mesh(str(p), with_texture=True)
    assert got[2].shape == (4, 2) and got[3].shape == (12, 3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert_close(tobj.compute_normal(v, f), jobj.compute_normal(v, f), 1e-6)
    assert np.allclose(np.linalg.norm(tobj.compute_normal(v, f), axis=-1), 1.0, atol=1e-5)
    np.testing.assert_array_equal(tobj.compute_tangent(*got), jobj.compute_tangent(*want))


# ------------------------------------------------------------------- meshing


def _gaussians(n_pts=300, seed=0):
    """A blob of anisotropic Gaussians dense enough to cross level 0.8."""
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(n_pts, 3) * [0.25, 0.4, 0.2]).astype(np.float32)
    scales = rng.uniform(0.05, 0.12, (n_pts, 3)).astype(np.float32)
    quats = rng.randn(n_pts, 4).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.0, 1.0, n_pts).astype(np.float32)
    opac[:10] = 0.001  # below opacity_min: dropped
    return xyz, scales, quats, opac


def test_gaussian_3d_coeff_matches_jax():
    rng = np.random.RandomState(1)
    A = rng.randn(64, 3, 3).astype(np.float32) * 0.2
    cov = A @ A.transpose(0, 2, 1) + 0.01 * np.eye(3, dtype=np.float32)
    cov6 = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2],
                     cov[:, 2, 2]], -1)
    d = (rng.randn(20, 64, 3) * 0.2).astype(np.float32)
    got = tmesh.gaussian_3d_coeff(t(d), t(cov6)[None])
    want = jmesh.gaussian_3d_coeff(jnp.asarray(d), jnp.asarray(cov6)[None])
    assert_close(got, want, 1e-6, 1e-5)
    iso = tmesh.gaussian_3d_coeff(torch.tensor([[0.2, 0.0, 0.0]]),
                                  torch.tensor([[0.04, 0.0, 0.0, 0.04, 0.0, 0.04]]))
    assert_close(iso, np.exp(-0.5), 1e-6)


@pytest.mark.parametrize("resolution", [24, 32])
def test_density_field_and_isosurface_match_jax(resolution, monkeypatch):
    xyz, scales, quats, opac = _gaussians()
    want, jc, jscale = jmesh.extract_density_field(xyz, scales, quats, opac, resolution=resolution)
    got, tc, tscale = tmesh.extract_density_field(xyz, scales, quats, opac, resolution=resolution,
                                                  device="cpu")
    assert got.shape == (resolution,) * 3 and got.dtype == np.float32
    np.testing.assert_array_equal(tc, jc)
    assert tscale == jscale
    assert want.max() > 2.0
    assert_close(got, want, 1e-5 * float(want.max()), 1e-5)
    # the sum at a grid point does not depend on the chunk: tensors in, a
    # chunk of 1000 points, and a chunk capped from N (17 points)
    a, _, _ = tmesh.extract_density_field(t(xyz), t(scales), t(quats), t(opac),
                                          resolution=resolution, chunk=1000, device="cpu")
    monkeypatch.setattr(tmesh, "CHUNK_ELEMENTS", 17 * 290)
    b, _, _ = tmesh.extract_density_field(xyz, scales, quats, opac, resolution=resolution,
                                          device="cpu")
    assert_close(a, got, 1e-6)
    assert_close(b, got, 1e-6)

    # Isosurface, cleaning and decimation: numpy copies of the JAX
    # package's, identical on the same field.
    jv, jf = jmesh.marching_tetrahedra(want, 0.8)
    tv, tf = tmesh.marching_tetrahedra(want, 0.8)
    assert len(tv) > 100 and len(tf) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    for a, b in zip(tmesh.clean_mesh(tv, tf), jmesh.clean_mesh(jv, jf)):
        np.testing.assert_array_equal(a, b)
    target = len(tf) // 5
    dv, df = tmesh.decimate_mesh(tv, tf, target)
    assert len(df) < len(tf) // 2
    for a, b in zip((dv, df), jmesh.decimate_mesh(jv, jf, target)):
        np.testing.assert_array_equal(a, b)
    # On the port's own field the surface has the same size to 2%.
    pv, pf = tmesh.marching_tetrahedra(got, 0.8)
    assert abs(len(pv) - len(jv)) <= 0.02 * len(jv)


def test_write_obj_reads_back(tmp_path):
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.5]], np.float32)
    faces = np.asarray([[0, 1, 2], [0, 2, 3]])
    pj, pt = str(tmp_path / "j.obj"), str(tmp_path / "t.obj")
    tmesh.write_obj(pt, verts, faces)
    jmesh.write_obj(pj, verts, faces)
    assert open(pt).read() == open(pj).read()
    v, f = tobj.load_obj_mesh(pt)
    np.testing.assert_array_equal(v, verts)
    np.testing.assert_array_equal(f, faces)


def test_poisson_reconstruct_sphere_matches_jax():
    """The sphere fixture of tests/test_meshing.py at 3000 points: radius 1
    within half a grid cell, and the arrays the JAX package returns."""
    rng = np.random.RandomState(0)
    v = rng.randn(3000, 3)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    c = np.array([0.3, -0.2, 0.1])
    verts, faces = tmesh.poisson_reconstruct(v + c, v, depth=6)
    assert len(verts) > 500 and len(faces) > 500
    r = np.linalg.norm(verts - c, axis=1)
    assert abs(r.mean() - 1.0) < 0.02 and r.std() < 0.02
    jv, jf = jmesh.poisson_reconstruct(v + c, v, depth=6)
    np.testing.assert_array_equal(verts, jv)
    np.testing.assert_array_equal(faces, jf)


# ----------------------------------------------------------------------- CLI


def _obj_counts(path):
    lines = open(path).read().splitlines()
    return sum(l.startswith("v ") for l in lines), sum(l.startswith("f ") for l in lines)


@pytest.mark.parametrize("field_attrs", [False, True])
def test_export_mesh_cli_matches_jax(field_attrs, tmp_path, monkeypatch):
    """``--synthetic --resolution 32`` in both packages on the same
    parameters (the JAX avatar carried across).  At the default level 0.8
    the fresh avatar's explicit logits (opacity 0.1) give an empty mesh in
    both; ``--density-thresh 0.3`` crosses it."""
    import soar_tpu.cli.common as jcommon
    import soar_tpu_torch.cli.common as tcommon
    from soar_tpu.cli import export_mesh as jcli
    from soar_tpu_torch.cli import export_mesh as tcli

    jparams, jmodel, tparams, tmodel = small_avatar(seed=0)
    monkeypatch.setattr(jcommon, "synthetic_setup", lambda **kw: (None, jparams, jmodel))
    monkeypatch.setattr(tcommon, "synthetic_setup",
                        lambda **kw: (None,) + port_copy(jparams, jmodel))
    flags = ["--synthetic", "--resolution", "32", "--density-thresh", "0.3"]
    flags += ["--field-attrs"] if field_attrs else []
    pj, pt = str(tmp_path / "j.obj"), str(tmp_path / "t.obj")
    jcli.main(flags + ["--out", pj])
    stats = tcli.main(flags + ["--out", pt, "--device", "cpu"])
    (jv, jf), (tv, tf) = _obj_counts(pj), _obj_counts(pt)
    assert (stats["verts"], stats["faces"]) == (tv, tf)
    assert jv > 100 and jf > 100
    assert abs(tv - jv) <= 0.02 * jv and abs(tf - jf) <= 0.02 * jf
    if not field_attrs:
        # default level: empty in both packages, and the OBJ is written
        jcli.main(flags[:3] + ["--out", pj])
        tcli.main(flags[:3] + ["--out", pt, "--device", "cpu"])
        assert _obj_counts(pj) == _obj_counts(pt) == (0, 0)


def test_export_mesh_cli_refuses_unported_inputs(tmp_path):
    from soar_tpu_torch.cli import export_mesh as tcli

    # --smpl-model / --num-subdiv only shape a real-capture run: they are not
    # defined until real captures are ported, so they are refused, not ignored.
    for flags in (["--dataroot", "/nonexistent"], [], ["--synthetic", "--ckpt", "ref.ckpt"],
                  ["--synthetic", "--num-subdiv", "3"], ["--synthetic", "--smpl-model", "x"]):
        with pytest.raises(SystemExit) as e:
            tcli.main(flags + ["--device", "cpu", "--out", str(tmp_path / "x.obj")])
        assert e.value.code == 2
