"""The reference-checkpoint import against soar_tpu on the CPU: tcnn's grid
layout, its packed hash grid and MLPs, the imported field in both
nerfstudio layouts, the Lightning ``.ckpt`` importers, and the two CLIs
that take a ``.ckpt``.

Tolerances: the layouts and unpacked matrices are exact; the packed grid
is a gather and an 8-term weighted sum in float32, summed in another order
(1e-6); the field adds two small MLPs and the activations (1e-5); the
turntable PNGs are held as in ``test_torch_port_render_rot.py::
test_run_turntable_writes_what_jax_writes`` (at most one level apart, on
under 0.2% of the values).
"""

import os

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from soar_tpu.cli import common as jcommon
from soar_tpu.cli import render_rot as jrender_rot
from soar_tpu.field import reference_import as jri
from soar_tpu.io import checkpoint as jckpt
from soar_tpu_torch.cli import common as tcommon
from soar_tpu_torch.cli import render_rot as trender_rot
from soar_tpu_torch.cli import train as ttrain
from soar_tpu_torch.field import reference_import as tri
from soar_tpu_torch.io import checkpoint as tckpt
from tests.test_reference_field import _make_field_sd
from torch_port_helpers import assert_close, n, port_copy, t

LAYOUTS = {"hashed": (4, 16, 128, 10), "dense": (3, 2, 8, 10), "mixed": (3, 4, 16, 10)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tcnn_grid_layout_matches_jax(layout):
    got, want = tri.tcnn_grid_layout(*LAYOUTS[layout]), jri.tcnn_grid_layout(*LAYOUTS[layout])
    for f in ("resolutions", "scales", "row_offsets", "dense", "features_per_level"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tcnn_hash_encode_matches_jax(layout):
    """Dense, hashed and mixed levels; points on the faces of the unit cube
    reach the top boundary cell, where dense indexing wraps."""
    import jax.numpy as jnp

    lay = tri.tcnn_grid_layout(*LAYOUTS[layout])
    rng = np.random.RandomState(7)
    params = rng.randn(lay.row_offsets[-1] * 2).astype(np.float32)
    pos = rng.uniform(0.0, 1.0, (257, 3)).astype(np.float32)
    pos[:8] = np.array([[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.999, 1, 0], [0.5, 0.5, 1],
                        [1e-7, 0.9999999, 0.5], [0.25, 0.75, 1], [1, 1, 0]], np.float32)
    want = np.asarray(jri.tcnn_hash_encode(jnp.asarray(params), jnp.asarray(pos),
                                           jri.tcnn_grid_layout(*LAYOUTS[layout])))
    got = tri.tcnn_hash_encode(t(params), t(pos), lay)
    assert got.shape == (257, 2 * len(lay.resolutions))
    assert_close(got, want, 1e-6)


@pytest.mark.parametrize("in_dim, out_dim, layers", [(32, 3, 2), (34, 3, 2), (8, 4, 3),
                                                     (24, 1, 2)])
def test_unpack_tcnn_mlp_matches_jax(in_dim, out_dim, layers):
    """Exact, the ones-padded input columns folded into the first bias."""
    rng = np.random.RandomState(in_dim)
    pad16 = lambda k: -(-k // 16) * 16  # noqa: E731
    size = 64 * pad16(in_dim) + 64 * 64 * (layers - 2) + pad16(out_dim) * 64
    packed = rng.randn(size).astype(np.float32)
    got = tri.unpack_tcnn_mlp(packed, in_dim, 64, out_dim, layers)
    want = jri.unpack_tcnn_mlp(packed, in_dim, 64, out_dim, layers)
    assert len(got) == len(want) == layers
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_array_equal(g[k], w[k])
    if in_dim % 16:
        assert np.abs(got[0]["b"]).max() > 0  # the padding bias
    for mod in (tri, jri):
        with pytest.raises(ValueError, match="packed MLP size"):
            mod.unpack_tcnn_mlp(packed[:-1], in_dim, 64, out_dim, layers)


@pytest.mark.parametrize("layout", ["torch", "tcnn"])
def test_reference_field_apply_matches_jax(layout):
    import jax.numpy as jnp

    rng = np.random.RandomState(3)
    sd = _make_field_sd(rng, layout)
    rf_j = jri.import_reference_field(sd)
    rf_t = tri.import_reference_field(sd, device="cpu")
    assert rf_t.tcnn == rf_j.tcnn == (layout == "tcnn")
    xyz = rng.uniform(-1.2, 1.2, (300, 3)).astype(np.float32)  # some outside the AABB
    z = np.array([0.3, -0.7], np.float32)
    for zz in (None, z):
        want = jri.reference_field_apply(rf_j, jnp.asarray(xyz),
                                         None if zz is None else jnp.asarray(zz))
        got = tri.reference_field_apply(rf_t, t(xyz), None if zz is None else t(zz))
        assert set(got) == set(want)
        for k in want:
            assert_close(got[k], want[k], 1e-5, msg=k)


def _reference_ckpt(path, n_surfels, seed=11, layout="tcnn", with_field=True, like=None):
    """A Lightning-layout checkpoint: the explicit surfel tensors (near
    ``like``'s when given) and, with ``with_field``, a reference attribute
    field; written with ``torch.save`` as Lightning writes it."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    if like is not None:
        xyz = n(like.xyz) + 0.01 * rng.randn(n_surfels, 3).astype(f32)
    else:
        xyz = rng.uniform(-0.5, 0.5, (n_surfels, 3)).astype(f32)
    sd = {
        "geometry._xyz": xyz,
        "geometry._rotation": rng.randn(n_surfels, 4).astype(f32),
        "geometry._scaling": (np.log(0.01) + 0.1 * rng.randn(n_surfels, 1)).astype(f32),
        "geometry._opacity": rng.randn(n_surfels, 1).astype(f32),
        "geometry._colors": rng.randn(n_surfels, 3).astype(f32),
        "geometry._occ": rng.randn(n_surfels, 1).astype(f32),
        "geometry.latent_pose": 0.1 * rng.randn(8, 2).astype(f32),
    }
    if with_field:
        sd.update(_make_field_sd(rng, layout))
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    state["geometry._rotation"] = state["geometry._rotation"].half()  # fp16 in the file
    torch.save({"state_dict": state, "global_step": 0, "epoch": 3,
                "hyper_parameters": {"cfg": {"name": "x"}}}, path)


@pytest.mark.parametrize("layout", ["torch", "tcnn"])
def test_ckpt_importers_read_one_file_like_jax(tmp_path, layout):
    import jax.numpy as jnp

    path = str(tmp_path / "ref.ckpt")
    _reference_ckpt(path, 50, layout=layout)
    sd = tckpt.load_reference_state_dict(path)
    assert "geometry._xyz" in sd and "global_step" not in sd
    got = tckpt.import_reference_ckpt(path, state_dict=sd)
    want = jckpt.import_reference_ckpt(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    rf_t = tckpt.import_reference_field_from_ckpt(path, device="cpu")
    rf_j = jckpt.import_reference_field_from_ckpt(path)
    xyz = want["xyz"][:20]
    g = tri.reference_field_apply(rf_t, t(xyz))
    w = jri.reference_field_apply(rf_j, jnp.asarray(xyz))
    for k in w:
        assert_close(g[k], w[k], 1e-5, msg=k)


def test_ckpt_import_shape_check_and_no_field(tmp_path):
    from soar_tpu_torch.avatar.state import AvatarParams
    from soar_tpu_torch.field.attribute_field import AttributeField

    path = str(tmp_path / "ref.ckpt")
    _reference_ckpt(path, 50, with_field=False)
    assert tckpt.import_reference_field_from_ckpt(path, device="cpu") is None
    assert jckpt.import_reference_field_from_ckpt(path) is None
    from soar_tpu.avatar.state import AvatarParams as JParams
    from soar_tpu_torch.field.attribute_field import AttributeFieldConfig
    from soar_tpu_torch.field.hashgrid import HashGridConfig

    shapes = dict(xyz=(40, 3), rotation=(40, 4), scaling=(40, 1), opacity=(40, 1),
                  colors=(40, 3), occ=(40, 1), latent_pose=(8, 2))
    tiny = AttributeFieldConfig(grid=HashGridConfig(num_levels=2, log2_hashmap_size=8),
                                hidden_dim=8)
    field = AttributeField(torch.tensor([[-1.0] * 3, [1.0] * 3]), tiny)
    like = AvatarParams(field=field, **{k: torch.zeros(v) for k, v in shapes.items()})
    jlike = JParams(field={}, **{k: np.zeros(v, np.float32) for k, v in shapes.items()})
    with pytest.raises(ValueError, match="xyz.*num-subdiv"):
        tckpt.import_reference_ckpt(path, like=like)
    with pytest.raises(ValueError, match="xyz.*num-subdiv"):
        jckpt.import_reference_ckpt(path, like=jlike)
    # load_avatar does not read a reference file: it names the importers.
    with pytest.raises(ValueError, match="import_reference_ckpt"):
        tckpt.load_avatar(path, like)


@pytest.fixture(scope="module")
def synthetic_avatar():
    """soar_tpu's synthetic avatar (the CLIs' ``--synthetic``), built once."""
    return jcommon.synthetic_setup(distill_steps=0)


def test_render_rot_reads_a_reference_ckpt_like_jax(synthetic_avatar, tmp_path, monkeypatch,
                                                    capsys):
    """``render_rot --synthetic --ckpt x.ckpt`` in both packages on the same
    avatar (the port's CLI gets a copy of soar_tpu's, so the kNN skinning is
    the same): the same PNGs within the turntable test's tolerance, and the
    field-less checkpoint's fallback to explicit attributes."""
    ds, params, model = synthetic_avatar
    monkeypatch.setattr(jcommon, "synthetic_setup", lambda **kw: synthetic_avatar)
    monkeypatch.setattr(tcommon, "synthetic_setup",
                        lambda **kw: (ds,) + port_copy(params, model))
    for with_field in (True, False):
        ckpt = str(tmp_path / f"ref_{with_field}.ckpt")
        _reference_ckpt(ckpt, params.xyz.shape[0], with_field=with_field, like=params)
        jdir, tdir = tmp_path / f"jax_{with_field}", tmp_path / f"torch_{with_field}"
        jrender_rot.main(["--synthetic", "--ckpt", ckpt, "--num-views", "2", "--out",
                          str(jdir), "--composite", "pallas"])
        trender_rot.main(["--synthetic", "--ckpt", ckpt, "--num-views", "2", "--out",
                          str(tdir), "--device", "cpu"])
        out = capsys.readouterr().out
        assert ("imported reference attribute field (tcnn layout)" in out) == with_field
        assert ("no attribute field; rendering with explicit params" in out) != with_field
        names = sorted(f for f in os.listdir(jdir) if f.endswith(".png"))
        assert sorted(os.listdir(tdir)) == names and len(names) == 8
        for name in names:
            a = imageio.imread(jdir / name).astype(np.int32)
            b = imageio.imread(tdir / name).astype(np.int32)
            diff = np.abs(a - b)
            assert diff.max() <= 1 and (diff > 0).mean() < 0.002, name
        if with_field:
            mask = imageio.imread(tdir / "mask_000.png")
            assert mask.mean() > 1.0, "the imported avatar covers some pixels"


def test_train_import_ckpt_warm_starts_and_round_trips(tmp_path, monkeypatch, capsys):
    """``cli.train --synthetic --import-ckpt x.ckpt``: the explicit tensors
    by name, the reference field distilled into the hash field (1000 steps;
    the field then predicts the reference's colours), one step, a
    checkpoint that ``render_rot`` reads back; under ``--use-explicit``
    JAX's warning.  The avatar's hash field is narrowed (4 levels of 2^10
    rows, hidden 16) so the CPU distils in seconds."""
    from soar_tpu_torch.avatar import state as tstate
    from soar_tpu_torch.field.attribute_field import AttributeFieldConfig, attribute_field_apply
    from soar_tpu_torch.field.hashgrid import HashGridConfig

    init = tstate.init_avatar
    tiny = AttributeFieldConfig(grid=HashGridConfig(num_levels=4, min_res=4, max_res=64,
                                                    log2_hashmap_size=10), hidden_dim=16)
    monkeypatch.setattr(tstate, "init_avatar",
                        lambda *a, **k: init(*a, **dict(k, field_cfg=tiny)))
    _, tparams, _ = tcommon.synthetic_setup(device="cpu")
    ckpt = str(tmp_path / "ref.ckpt")
    _reference_ckpt(ckpt, tparams.xyz.shape[0], like=tparams)

    names = ttrain.import_reference_warm_start(ckpt, tparams, False, "cpu")
    assert names == sorted(["xyz", "rotation", "scaling", "opacity", "colors", "occ",
                            "latent_pose"])
    assert "distilled reference attribute field" in capsys.readouterr().out
    ref = jckpt.import_reference_ckpt(ckpt)
    for k in names:
        np.testing.assert_array_equal(n(getattr(tparams, k)), ref[k])
    rf = tckpt.import_reference_field_from_ckpt(ckpt, device="cpu")
    with torch.no_grad():
        want = tri.reference_field_apply(rf, tparams.xyz)
        got = attribute_field_apply(tparams.field, tparams.xyz)
    for k, tol in (("shs", 1e-3), ("scales", 1e-6)):
        err = float(torch.mean((got[k] - want[k]) ** 2))
        assert err < tol, (k, err)

    out = str(tmp_path / "run")
    ttrain.main(["--synthetic", "--import-ckpt", ckpt, "--stage", "0", "--steps", "1",
                 "--log-every", "1", "--dump-every", "0", "--val-every", "0", "--device",
                 "cpu", "--out", out])
    text = capsys.readouterr().out
    assert "distilled reference attribute field" in text and "imported reference ckpt" in text
    assert os.path.exists(os.path.join(out, "stage0", "avatar.pt"))
    trender_rot.main(["--synthetic", "--ckpt", os.path.join(out, "stage0"), "--num-views",
                      "1", "--out", str(tmp_path / "rot"), "--device", "cpu"])
    assert len(os.listdir(tmp_path / "rot")) == 4
    ttrain.main(["--synthetic", "--import-ckpt", ckpt, "--use-explicit", "--stage", "0",
                 "--steps", "1", "--dump-every", "0", "--val-every", "0", "--device", "cpu",
                 "--out", str(tmp_path / "explicit")])
    assert "--use-explicit ignores the checkpoint's attribute-field" in capsys.readouterr().out
