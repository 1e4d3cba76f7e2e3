"""The turntable slice as a whole: soar_tpu's synthetic avatar is built in
JAX, carried across with ``soar_tpu_torch.io.from_jax``, and rendered by
both packages on the CPU.

Tolerances: the renders agree to ~1e-6 where the arithmetic is the same
(checked at 1e-4 to leave room for the preprocess's float32 ordering);
depth is normalized by 1 - T and compared inside the mask; the derived
maps (curvature, depth normals) difference neighbouring pixels, so a pixel
that flips at a threshold moves its neighbours too — a stated share of
pixels may differ there.
"""

import os

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.avatar import RenderSettings as JSettings
from soar_tpu.avatar import render_view as jrender_view
from soar_tpu.cli.common import synthetic_setup as jsynthetic_setup
from soar_tpu.cli.render_rot import run_turntable as jrun_turntable
from soar_tpu.core.transforms import batch_rodrigues, rotmat_to_rotvec
from soar_tpu.render.types import RasterConfig as JRasterConfig
from soar_tpu.train.trainer import make_gt_batch
from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
from soar_tpu_torch.cli import render_rot as trr
from soar_tpu_torch.cli.common import synthetic_setup
from soar_tpu_torch.data.dataset import make_synthetic_sequence
from soar_tpu_torch.io.from_jax import avatar_from_numpy
from soar_tpu_torch.render.block_composite import composite_block
from soar_tpu_torch.train.evaluate import save_png
from torch_port_helpers import assert_close, assert_close_share, avatar_to_numpy, n, t

NUM_VIEWS = 8
ANGLES = (0, 3)  # turntable steps i of NUM_VIEWS


@pytest.fixture(scope="module")
def slice_setup():
    ds, params, model = jsynthetic_setup(distill_steps=0)
    tparams, tmodel = avatar_from_numpy(*avatar_to_numpy(params, model), device="cpu")
    return ds, params, model, tparams, tmodel


def _override(i):
    """render_rot's per-view global_orient, built in JAX."""
    angle = 2.0 * np.pi * i / NUM_VIEWS
    c, s = np.cos(angle), np.sin(angle)
    Ry = jnp.asarray(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32))
    return rotmat_to_rotvec(batch_rodrigues(jnp.zeros((1, 3)))[0] @ Ry)


def test_gt_camera_matches_jax(slice_setup):
    ds, _, model, _, _ = slice_setup
    jcam = make_gt_batch(ds, model, 0)["gt_cam"]
    tcam = trr.gt_camera(ds, 0, "cpu")
    for f in jcam._fields:
        assert_close(getattr(tcam, f), getattr(jcam, f), 1e-6, msg=f)


@pytest.mark.parametrize("composite", ["pallas", "xla"])
def test_render_view_matches_jax_on_two_turntable_angles(slice_setup, composite):
    ds, params, model, tparams, tmodel = slice_setup
    H, W = ds.image_size
    jcam = make_gt_batch(ds, model, 0)["gt_cam"]
    tcam = trr.gt_camera(ds, 0, "cpu")
    jset = JSettings(raster=JRasterConfig(composite=composite))
    render = jax.jit(lambda p, ov: jrender_view(
        p, model, jcam, (H, W), jnp.ones(3), jnp.asarray(0), jset, smpl_override=ov))
    for i in ANGLES:
        ov = _override(i)
        want = render(params, {"global_orient": ov})
        with torch.no_grad():
            got = render_view(tparams, tmodel, tcam, (H, W), torch.ones(3), 0,
                              RenderSettings(), smpl_override={"global_orient": t(ov)})
        assert set(got) == set(want)
        np.testing.assert_array_equal(n(got["overflow"]), n(want["overflow"]))
        np.testing.assert_array_equal(n(got["visible"]), n(want["visible"]))
        mask = n(want["mask"]) > 1e-5
        assert mask.mean() > 0.01, "the avatar must cover some pixels"
        for k in ("render", "normal", "mask", "occ"):
            assert_close_share(got[k], want[k], 1e-4, 0.002, msg=f"view {i} {k}")
        inner = n(want["mask"]) > 0.5
        assert_close_share(n(got["depth"])[inner], n(want["depth"])[inner], 1e-3, 0.002,
                           msg=f"view {i} depth")
        # Neighbour-difference maps: 1e-3, 2% of pixels near the silhouette.
        for k in ("curv", "pred_normal"):
            assert_close_share(got[k], want[k], 1e-3, 0.02, msg=f"view {i} {k}")


def test_run_turntable_writes_what_jax_writes(slice_setup, tmp_path):
    ds, params, model, tparams, tmodel = slice_setup
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jrun_turntable(str(jdir), ds, params, model, False, 2, composite="pallas")
    before = composite_block.launches
    outs = trr.run_turntable(str(tdir), ds, tparams, tmodel, False, 2, device="cpu")
    # CPU tensors take the plain composite: no kernel launch.
    assert composite_block.launches == before and len(outs) == 2
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for name in sorted(os.listdir(jdir)):
        if not name.endswith(".png"):
            continue
        a = imageio.imread(jdir / name).astype(np.int32)
        b = imageio.imread(tdir / name).astype(np.int32)
        assert a.shape == b.shape, name
        # u8 quantization: a value within 1e-6 of a rounding edge may land
        # one level apart.
        diff = np.abs(a - b)
        assert diff.max() <= 1 and (diff > 0).mean() < 0.002, name


def test_synthetic_sequence_and_setup_match_jax(slice_setup):
    ds, params, _, _, _ = slice_setup
    tds, _ = make_synthetic_sequence(num_frames=8, image_size=(128, 128), device="cpu")
    for k in ds.smpl_params:
        np.testing.assert_array_equal(tds.smpl_params[k], ds.smpl_params[k], err_msg=k)
    for k in ("w2c", "Ks", "normal_Ks"):
        np.testing.assert_array_equal(getattr(tds, k), getattr(ds, k), err_msg=k)
    assert (tds.train_idx, tds.val_idx, tds.test_idx) == (ds.train_idx, ds.val_idx, ds.test_idx)
    assert tds.image_size == ds.image_size
    fj, ft = ds.frame_fovs(0), tds.frame_fovs(0)
    assert fj.keys() == ft.keys() and all(np.isclose(fj[k], ft[k]) for k in fj)
    # The port's own init re-derives the kNN skinning of a symmetric body,
    # where a tie at the 30th neighbour can pick another vertex: the images
    # agree on the mask up to a few silhouette pixels.
    assert np.mean(tds.masks != ds.masks) < 0.01
    assert_close_share(tds.images, ds.images, 2e-2, 0.01, msg="images")
    # cv2.remap (JAX package) vs numpy bilinear: 1/32-pixel fixed-point
    # weights vs float weights.
    assert_close_share(tds.images_crop, ds.images_crop, 5e-2, 0.02, msg="crops")

    _, tparams, tmodel = synthetic_setup(device="cpu")
    assert tuple(tparams.xyz.shape) == tuple(params.xyz.shape)
    assert tuple(tparams.field.encoding.shape) == tuple(params.field["encoding"].shape)
    assert tmodel.num_frames == 8


def test_save_png_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    for shape in ((5, 7, 3), (6, 4), (3, 5, 1), (4, 4, 4)):
        img = rng.rand(*shape).astype(np.float32)
        save_png(str(tmp_path / "x.png"), img)
        back = imageio.imread(tmp_path / "x.png")
        want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(back, want.reshape(back.shape))


def test_render_rot_cli_synthetic_on_cpu(tmp_path):
    trr.main(["--synthetic", "--num-views", "2", "--out", str(tmp_path), "--device", "cpu"])
    names = set(os.listdir(tmp_path))
    for i in range(2):
        for k in ("rgb", "normal", "occ", "mask"):
            assert f"{k}_{i:03d}.png" in names
    with pytest.raises(SystemExit):
        trr.main(["--num-views", "1", "--device", "cpu"])
