"""The port's real-capture path against soar_tpu on the CPU: the PNG decoder
against OpenCV, the capture loaders (standard, insav_wild and few-shot
layouts, ``params.pth`` readers), captures written by the JAX package's
``scripts/make_mock_capture.py --blob`` and by the port's
``data.mock_capture``, ``cli.common.real_setup``, one guidance-free train
step on a capture with the JAX draws injected, and the three CLIs'
``--dataroot`` round trip.

Tolerances, each with its reason:
- PNG decoding and every array made from 8-bit PNG data (images, masks,
  normal maps, normal masks): equal, since both packages divide the same
  bytes by 255 in float32;
- parameters, cameras, splits and the few-shot rig: equal (the same numpy
  code on the same arrays);
- the 512² crops: the JAX package resamples with ``cv2.remap`` (1/32-pixel
  fixed-point weights), the port in float: the bound of
  ``test_torch_port_render_rot.py``'s synthetic crops (at most 2% of the
  values beyond 5e-2);
- the few-shot normal maps resized to 512²: OpenCV's float bilinear
  against PyTorch's on the same grid, 1e-5;
- ``real_setup``: the deterministic parts of the avatar as
  ``test_torch_port_core.py::test_init_avatar_matches_jax_on_its_
  deterministic_parts`` holds them (its kNN-tie bound on the skinning
  weights);
- the train step: ``test_torch_port_train.py::test_train_step_matches_jax``'s
  tolerances (losses 1e-4 relative, gradients 1e-3 relative L2, hash
  tables 1e-2).
"""

import json
import os
import struct
import subprocess
import sys
import zlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.avatar import init_avatar as jinit_avatar
from soar_tpu.cli import common as jcommon
from soar_tpu.data import dataset as jds
from soar_tpu.field.attribute_field import AttributeFieldConfig as JFieldConfig
from soar_tpu.field.hashgrid import HashGridConfig as JGridConfig
from soar_tpu.render.types import RasterConfig as JRasterConfig
from soar_tpu.train import background as jbg
from soar_tpu.train import trainer as jtr
from soar_tpu.train.config import StageConfig as JStageConfig
from soar_tpu.train.config import TrainConfig as JTrainConfig
from soar_tpu_torch.avatar import state as tstate
from soar_tpu_torch.cli import common as tcommon
from soar_tpu_torch.cli import export_mesh as texport
from soar_tpu_torch.cli import render_rot as trot
from soar_tpu_torch.cli import train as tcli
from soar_tpu_torch.data import dataset as tds
from soar_tpu_torch.data import mock_capture
from soar_tpu_torch.field.attribute_field import AttributeFieldConfig
from soar_tpu_torch.field.hashgrid import HashGridConfig
from soar_tpu_torch.io.from_jax import background_from_numpy
from soar_tpu_torch.io.png import read_png
from soar_tpu_torch.render.types import RasterConfig
from soar_tpu_torch.train import config as tconfig
from soar_tpu_torch.train import trainer as ttr
from soar_tpu_torch.train.evaluate import _to_u8, save_png
from test_torch_port_train import _grab_grads, _jax_draws, _rel_l2, jax_leaves, port_leaves
from torch_port_helpers import assert_close, assert_close_share, n, port_copy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UINT8_FIELDS = ("images", "masks", "normal_F", "normal_B", "normal_mask")
SMALL_GRID = dict(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=12)

# ------------------------------------------------------------------- PNG


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(
        ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def write_png_filtered(path, img, color_type, filt, depth=8, interlace=0):
    """A tiny PNG encoder that uses scanline filter ``filt`` on every row."""
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    H, W = img.shape[:2]
    rows = img.reshape(H, W * ch).astype(np.int32)
    prev = np.zeros(W * ch, np.int32)
    out = []
    for y in range(H):
        r = rows[y]
        left = np.concatenate([np.zeros(ch, np.int32), r[:-ch]])
        upleft = np.concatenate([np.zeros(ch, np.int32), prev[:-ch]])
        pred = [np.zeros_like(r), left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft)][filt]
        out.append(np.concatenate([[filt], (r - pred) & 0xFF]).astype(np.uint8))
        prev = r
    ihdr = struct.pack(">IIBBBBB", W, H, depth, color_type, 0, 0, interlace)
    extra = _chunk(b"PLTE", bytes(range(6))) if color_type == 3 else b""
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
                + _chunk(b"IDAT", zlib.compress(np.stack(out).tobytes()))
                + _chunk(b"IEND", b""))


def cv2_read_rgb(path):
    """cv2.imread(IMREAD_UNCHANGED) with BGR(A) turned into RGB(A)."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3]] if img.shape[-1] == 4 else img[..., ::-1]
    return img


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("color_type", [0, 2, 4, 6])
def test_read_png_matches_cv2(tmp_path, color_type, filt):
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    rng = np.random.RandomState(10 * color_type + filt)
    shape = (13, 17) if ch == 1 else (13, 17, ch)
    # Random values, plus smooth ramps where the predictors are close.
    img = rng.randint(0, 256, shape).astype(np.uint8)
    img[:6] = (np.arange(17)[None, :, None] * 15 + np.arange(6)[:, None, None] * 7
               ).reshape((6, 17) + (() if ch == 1 else (1,))).astype(np.uint8)
    path = str(tmp_path / "x.png")
    write_png_filtered(path, img, color_type, filt)
    got = read_png(path)
    want = cv2_read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if color_type == 4:  # gray + alpha comes back as (g, g, g, a), as OpenCV's
        np.testing.assert_array_equal(got[..., :3], np.repeat(img[..., :1], 3, -1))
        np.testing.assert_array_equal(got[..., 3], img[..., 1])


@pytest.mark.parametrize("writer", ["cv2", "save_png"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_read_png_reads_cv2_and_save_png_files(tmp_path, writer, channels):
    rng = np.random.RandomState(channels)
    shape = (31, 45) if channels == 1 else (31, 45, channels)
    path = str(tmp_path / "x.png")
    if writer == "cv2":
        img = rng.randint(0, 256, shape).astype(np.uint8)
        bgr = img if channels == 1 else img[..., [2, 1, 0, 3][:channels]]
        assert cv2.imwrite(path, bgr)
    else:
        f = rng.rand(*shape).astype(np.float32)
        save_png(path, f)
        img = _to_u8(f)
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(read_png(path), cv2_read_rgb(path))


@pytest.mark.parametrize("kind", ["16-bit", "palette", "interlaced", "crc"])
def test_read_png_refuses_other_files(tmp_path, kind):
    path = str(tmp_path / "x.png")
    img = np.random.RandomState(0).randint(0, 6, (8, 8)).astype(np.uint8)
    if kind == "16-bit":
        assert cv2.imwrite(path, (img.astype(np.uint16) * 4000)[..., None].repeat(3, -1))
        match = "bit depth 16"
    elif kind == "palette":
        write_png_filtered(path, img, 3, 0)
        match = "colour type 3"
    elif kind == "interlaced":
        write_png_filtered(path, img, 0, 0, interlace=1)
        match = "interlace"
    else:
        write_png_filtered(path, img, 0, 0)
        data = bytearray(open(path, "rb").read())
        data[-20] ^= 0xFF  # a byte of the IDAT payload
        open(path, "wb").write(bytes(data))
        match = "CRC"
    with pytest.raises(ValueError, match=match):
        read_png(path)


# --------------------------------------------------------------- captures


def _ellipse(H, W, i):
    yy, xx = np.mgrid[0:H, 0:W]
    return ((xx - W / 2 - 3 * i) ** 2 / (0.3 * W) ** 2 + (yy - H / 2) ** 2 / (0.4 * H) ** 2) < 1


def write_capture_cv2(root, variant, F=6, H=48, W=64, NR=64, seed=0, body_joints=4,
                      transl=(0.0, -0.4, 2.0)):
    """A capture in the standard layout written with OpenCV: non-square
    images (RGBA, or RGB with 3-channel mask PNGs whose blue channel is the
    mask and whose red is not), RGBA normal maps of NR², an off-centre K,
    normal_Ks != Ks, a w2c with a translation, [F, J, 3] body poses and a
    numpy ``img_wh``.  Returns the parameters written."""
    rng = np.random.RandomState(seed)
    for sub in ("images", "masks", "normal_F", "normal_B", "smplx"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(F):
        m = _ellipse(H, W, i)
        rgb = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        if variant == "rgba":
            alpha = np.where(m, rng.randint(1, 256, (H, W)), 0).astype(np.uint8)
            cv2.imwrite(os.path.join(root, f"images/{i:05d}.png"),
                        np.dstack([rgb[..., ::-1], alpha]))
        else:
            cv2.imwrite(os.path.join(root, f"images/{i:05d}.png"), rgb[..., ::-1])
            mask_rgb = np.dstack([~m * 255, rng.randint(0, 256, (H, W)), m * 200]).astype(np.uint8)
            cv2.imwrite(os.path.join(root, f"masks/{i:05d}.png"), mask_rgb[..., ::-1])
        for sub in ("normal_F", "normal_B"):
            nrm = rng.randint(0, 256, (NR, NR, 4)).astype(np.uint8)
            nrm[..., 3] = np.where(rng.rand(NR, NR) < 0.3, 0, nrm[..., 3])
            cv2.imwrite(os.path.join(root, f"{sub}/{i:05d}.png"), nrm[..., [2, 1, 0, 3]])
    focal = 1.3 * W
    K = np.array([[focal, 0, W / 2 + 2.5], [0, focal * 1.02, H / 2 - 1.5], [0, 0, 1]],
                 np.float32)
    nK = np.array([[1.3 * NR, 0, NR / 2 - 1], [0, 1.3 * NR, NR / 2 + 1], [0, 0, 1]], np.float32)
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, 3] = [0.02, -0.03, 0.05]
    params = {
        "betas": torch.from_numpy(rng.randn(1, 4).astype(np.float32) * 0.1),
        "body_pose": torch.from_numpy(
            (rng.randn(F, body_joints - 1, 3) * 0.1).astype(np.float32)),
        "global_orient": torch.from_numpy((rng.randn(F, 3) * 0.05).astype(np.float32)),
        "transl": torch.from_numpy(np.tile(np.float32(transl), (F, 1))),
        "w2c": torch.from_numpy(w2c),
        "Ks": torch.from_numpy(np.tile(K[None], (F, 1, 1))),
        "normal_Ks": torch.from_numpy(np.tile(nK[None], (F, 1, 1))),
        "img_wh": np.array([W, H]),
    }
    torch.save(params, os.path.join(root, "smplx", "params.pth"))
    return params


def assert_datasets_match(got, want, crops=True):
    for k in UINT8_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in ("w2c", "Ks", "normal_Ks"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert got.smpl_params.keys() == want.smpl_params.keys()
    for k in want.smpl_params:
        np.testing.assert_array_equal(got.smpl_params[k], want.smpl_params[k], err_msg=k)
    assert (got.train_idx, got.val_idx, got.test_idx) == (want.train_idx, want.val_idx,
                                                          want.test_idx)
    for i in range(want.num_frames):
        fg, fw = got.frame_fovs(i), want.frame_fovs(i)
        assert fg.keys() == fw.keys() and all(fg[k] == fw[k] for k in fw)
    if crops:
        assert_close_share(got.images_crop, want.images_crop, 5e-2, 0.02, msg="images_crop")
        assert_close_share(got.masks_crop, want.masks_crop, 5e-2, 0.02, msg="masks_crop")


@pytest.mark.parametrize("variant", ["rgba", "masks"])
def test_load_sequence_matches_jax(tmp_path, variant):
    root = str(tmp_path / "cap")
    write_capture_cv2(root, variant)
    got, want = tds.load_sequence(root), jds.load_sequence(root)
    assert_datasets_match(got, want)
    assert got.image_size == (48, 64) and got.normal_F.shape[1:] == (64, 64, 3)
    # The w2c flip, baked in once, and the [F, J, 3] poses flattened.
    assert got.w2c[1, 1] == -1 and got.w2c[2, 2] == -1 and got.w2c[0, 0] == 1
    assert got.smpl_params["body_pose"].shape == (6, 9)
    if variant == "masks":  # the mask is the PNG's blue channel
        np.testing.assert_array_equal(got.masks[0], _ellipse(48, 64, 0).astype(np.float32))
    with pytest.raises(FileNotFoundError):
        tds.load_sequence(str(tmp_path / "absent"))


def test_params_pth_loaders_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    F = 4
    path = str(tmp_path / "params.pth")
    data = {"betas": torch.from_numpy(rng.randn(1, 10).astype(np.float32)),
            "body_pose": torch.from_numpy(rng.randn(F, 21, 3).astype(np.float32)),
            "img_wh": np.array([640, 480]), "scale": [1.0, 2.0], "name": np.float32(3.5)}
    torch.save(data, path)
    got, want = tds._load_params_pth(path), jds._load_params_pth(path)
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["body_pose"].shape == (F, 21, 3)

    seq = tmp_path / "insav"
    (seq / "train").mkdir(parents=True)
    torch.save({"beta": torch.from_numpy(rng.randn(1, 12).astype(np.float32)),
                "body_pose": torch.from_numpy(rng.randn(F, 72).astype(np.float32)),
                "trans": rng.randn(F, 3).astype(np.float32)},
               str(seq / "train" / "smpl_parms.pth"))
    got, want = tds.load_insav_smpl_params(str(seq)), jds.load_insav_smpl_params(str(seq))
    assert got.keys() == want.keys() == {"betas", "global_orient", "body_pose", "transl"}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["betas"].shape == (1, 10) and got["body_pose"].shape == (F, 69)
    # A pose that is not SMPL-24 is refused, here at <seq>/smpl_parms.pth.
    bad = tmp_path / "bad"
    bad.mkdir()
    torch.save({"beta": torch.zeros(1, 10), "body_pose": torch.zeros(F, 69),
                "trans": torch.zeros(F, 3)}, str(bad / "smpl_parms.pth"))
    for mod in (tds, jds):
        with pytest.raises(ValueError, match="72"):
            mod.load_insav_smpl_params(str(bad))


def test_load_fs_sequence_and_circle_poses_match_jax(tmp_path):
    rng = np.random.RandomState(6)
    F, S = 8, 96
    NR = S  # a normal map without alpha takes the image mask, so the sizes agree
    root = tmp_path / "fs"
    for sub in ("basecolor", "mask", "normal"):
        (root / sub).mkdir(parents=True)
    for i in range(F):
        m = _ellipse(S, S, i % 3)
        rgb = rng.randint(0, 256, (S, S, 3)).astype(np.uint8)
        # RGBA images, and RGB images with 3-channel masks (written for
        # every frame: both loaders index the mask list by position).
        if i % 2:
            cv2.imwrite(str(root / f"basecolor/{i:03d}.png"),
                        np.dstack([rgb[..., ::-1], m * 255]).astype(np.uint8))
        else:
            cv2.imwrite(str(root / f"basecolor/{i:03d}.png"), rgb[..., ::-1])
        cv2.imwrite(str(root / f"mask/{i:03d}.png"),
                    np.dstack([m * 255, rng.randint(0, 256, (S, S)), ~m * 255]).astype(np.uint8))
        nrm = rng.randint(0, 256, (NR, NR, 4 if i % 3 else 3)).astype(np.uint8)
        cv2.imwrite(str(root / f"normal/{i:03d}.png"), nrm)
    got, want = tds.load_fs_sequence(str(root)), jds.load_fs_sequence(str(root))
    for k in ("images", "masks"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    # The world-space maps rotated into each camera and resized 96 -> 512.
    assert got.normal_F.shape == (F, 512, 512, 3) and got.normal_mask.shape == (F, 512, 512)
    assert_close(got.normal_F, want.normal_F, 1e-5)
    assert_close(got.normal_mask, want.normal_mask, 1e-5)
    assert got.normal_B.shape == want.normal_B.shape == (F, 0, 0, 3)
    for k in ("w2c", "Ks", "normal_Ks"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=k)
    assert (got.train_idx, got.val_idx, got.test_idx) == (want.train_idx, want.val_idx,
                                                          want.test_idx) == ([0, 4], [5, 6, 7],
                                                                             [1, 2, 3])
    assert got.smpl_params == {}
    assert_close_share(got.images_crop, want.images_crop, 5e-2, 0.02, msg="images_crop")
    # The rig: negative azimuth steps, det = -1 on every frame.
    th, ph = np.full(5, 70.0), -np.arange(5) * 72.0
    c2w = tds.circle_poses(np.full(5, 2.5), th, ph)
    np.testing.assert_array_equal(c2w, jds.circle_poses(np.full(5, 2.5), th, ph))
    np.testing.assert_allclose(np.linalg.det(c2w[:, :3, :3]), -1.0, atol=1e-5)
    # The resize alone against OpenCV's INTER_LINEAR on float input, up and down.
    img = rng.rand(37, 53, 3).astype(np.float32)
    for size in ((512, 512), (20, 31)):
        assert_close(tds.resize_bilinear(img, size),
                     cv2.resize(img, size[::-1], interpolation=cv2.INTER_LINEAR), 1e-5)
        assert_close(tds.resize_bilinear(img[..., 0], size),
                     cv2.resize(img[..., 0], size[::-1], interpolation=cv2.INTER_LINEAR), 1e-5)


def test_jax_blob_capture_loads_identically(tmp_path):
    root = str(tmp_path / "blob")
    subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_mock_capture.py"),
                    "--out", root, "--frames", "5", "--size", "64", "--blob"],
                   check=True, capture_output=True, timeout=300, cwd=REPO)
    assert_datasets_match(tds.load_sequence(root), jds.load_sequence(root))


@pytest.mark.parametrize("blob", [False, True])
def test_port_mock_capture_loads_identically(tmp_path, blob):
    root = str(tmp_path / "cap")
    written = {}
    info = mock_capture.make_capture(root, frames=5, size=64, joints=4, segments=3, ring=8,
                                     blob=blob, device="cpu", written=written)
    assert len(written) == 20
    for path, u8 in written.items():
        np.testing.assert_array_equal(read_png(path), u8, err_msg=path)
    got, want = tds.load_sequence(root), jds.load_sequence(root)
    assert_datasets_match(got, want)
    if not blob:
        # The GT renders passed the overflow check (make_capture raises
        # otherwise), cover the body, and sit in the loader's GT camera.
        assert min(info["coverage"]) > 0.05 and info["transl_z"] > 0
        assert got.masks.mean() > 0.05 and got.normal_mask.mean() > 0.05
        np.testing.assert_array_equal(got.masks, got.normal_mask)


# ----------------------------------------------------------- real_setup


def _assert_avatars_match(tp, tm, jp, jm):
    assert tuple(tp.xyz.shape) == tuple(jp.xyz.shape)
    assert_close(tp.xyz, jp.xyz, 1e-6)
    assert_close(tp.rotation, jp.rotation, 1e-5)
    # scaling = 0.5*log(d2), d2 from |p|^2 - 2p.r + |r|^2: the core test's
    # 5e-4 holds at |p|^2 ~ 1 and the cancellation grows with |p|^2 (the
    # 24-joint tube of the insav case is 6 units tall).
    sq = max(1.0, float((n(tp.xyz) ** 2).sum(-1).max()))
    assert_close(tp.scaling, jp.scaling, 5e-4 * sq)
    for name in ("opacity", "colors", "occ", "latent_pose"):
        assert_close(getattr(tp, name), getattr(jp, name), 0, msg=name)
    assert_close(tm.aabb, jm.aabb, 1e-6)
    assert_close(tm.skin.inv_mats, jm.skin.inv_mats, 1e-5)
    assert_close(tm.skin.cano_vertices, jm.skin.cano_vertices, 1e-6)
    # The tube bodies are symmetric: a tie at the 30th neighbour may pick
    # another vertex (5e-2, as the core test), and on the 6-vertex rings of
    # the insav body a few surfels' weights move further (at most 1%).
    assert_close_share(tm.skin.point_weights, jm.skin.point_weights, 5e-2, 0.01)
    assert tm.num_frames == jm.num_frames
    assert tm.smpl_params.keys() == jm.smpl_params.keys()
    for k in jm.smpl_params:
        assert_close(tm.smpl_params[k], jm.smpl_params[k], 0, msg=k)
    assert tuple(tp.field.encoding.shape) == tuple(jp.field["encoding"].shape)
    assert tm.field_cfg.grid.log2_hashmap_size == jm.field_cfg.grid.log2_hashmap_size == 18


@pytest.mark.parametrize("layout", ["standard", "insav"])
def test_real_setup_matches_jax(tmp_path, layout):
    seq = tmp_path / "seq"
    if layout == "standard":
        write_capture_cv2(str(seq), "rgba")
        body = "test:4,3,8"
    else:
        # insav_wild: SMPL-24 parameters pose the avatar; the images sit
        # under train/ with their own smplx/params.pth.
        write_capture_cv2(str(seq / "train"), "masks", body_joints=24)
        rng = np.random.RandomState(8)
        torch.save({"beta": torch.from_numpy(rng.randn(1, 10).astype(np.float32) * 0.1),
                    "body_pose": torch.from_numpy(rng.randn(6, 72).astype(np.float32) * 0.1),
                    "trans": torch.from_numpy(np.tile(np.float32([0, -0.2, 2.0]), (6, 1)))},
                   str(seq / "train" / "smpl_parms.pth"))
        body = "test:24,1,6"
    tds_, tp, tm = tcommon.real_setup(str(seq), body, num_subdiv=1, distill_steps=0,
                                      device="cpu")
    jds_, jp, jm = jcommon.real_setup(str(seq), body, num_subdiv=1, distill_steps=0)
    assert_datasets_match(tds_, jds_)
    _assert_avatars_match(tp, tm, jp, jm)
    if layout == "insav":
        assert tm.smpl_params["body_pose"].shape == (6, 69)
        np.testing.assert_array_equal(n(tm.smpl_params["betas"]).shape, (1, 10))


# -------------------------------------------------------------- train step


def test_train_step_on_a_capture_matches_jax(tmp_path):
    root = str(tmp_path / "cap")
    write_capture_cv2(root, "rgba", F=5, H=48, W=64, NR=48, transl=(0.0, -0.3, 2.0))
    jdata, tdata = jds.load_sequence(root), tds.load_sequence(root)
    assert_datasets_match(tdata, jdata)
    from soar_tpu.body import make_test_body as jmake_body

    grid = dict(SMALL_GRID)
    jp, jm = jinit_avatar(jmake_body(num_joints=4, segments_per_bone=3, ring=8),
                          {k: jnp.asarray(v) for k, v in jdata.smpl_params.items()},
                          num_subdiv=1, distill_steps=0,
                          field_cfg=JFieldConfig(grid=JGridConfig(**grid), hidden_dim=16))
    tparams, tmodel_ = port_copy(jp, jm)
    nv, gen_size = 2, (32, 32)
    size, nsize = tdata.image_size, (48, 48)
    jcfg, tcfg = JTrainConfig(n_views=nv), tconfig.TrainConfig(n_views=nv)
    stage_j, stage_t = JStageConfig(sds_start=0), tconfig.StageConfig(sds_start=0)
    assert stage_t.loss.normal_F > 0 and stage_t.loss.normal_B > 0
    jraster = JRasterConfig(composite="xla", composite_dtype="f32", max_per_tile=48, dup_side=3)
    traster = RasterConfig(max_per_tile=48, dup_side=3)

    key = jax.random.PRNGKey(12)
    bg = jbg.init_background(jax.random.PRNGKey(7))
    grab = _grab_grads()
    jstep = jax.jit(jtr.make_train_step(
        jm, jcfg, stage_j, grab, gen_size=gen_size, gt_size=size, normal_size=nsize,
        raster=jraster, has_normals=True, has_normal_B=True))
    jbatch = jtr.make_gt_batch(jdata, jm, 1)
    jstate = jtr.TrainState(params=jp, bg_params=bg, opt_state=grab.init(jp),
                            step=jnp.asarray(3, jnp.int32))
    jnew, jmetrics = jstep(jstate, jbatch, key)
    jgrads = jax_leaves(jnew.opt_state)

    state, opt = ttr.init_train_state(tparams, tcfg, stage=stage_t)
    state.bg_params = background_from_numpy(jax.tree_util.tree_map(np.asarray, bg), "cpu")
    state.step = 3
    step = ttr.make_train_step(tmodel_, tcfg, stage_t, opt, gen_size=gen_size, gt_size=size,
                               normal_size=nsize, raster=traster, has_normals=True,
                               has_normal_B=True)
    tbatch = ttr.make_gt_batch(tdata, tmodel_, 1, device="cpu")
    for k in ("gt_rgb", "gt_mask", "gt_normal_F", "gt_normal_B", "gt_normal_mask"):
        assert_close(tbatch[k], jbatch[k], 0, msg=k)
    loss, metrics, _ = step.loss_fn(tparams, state.bg_params, tbatch,
                                    _jax_draws(key, jcfg, nv), state.step)
    opt.zero_grad()
    loss.backward()
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        assert_close(metrics[k], jmetrics[k], 1e-7, 1e-4, msg=k)
    # The body is in view and the normal terms are live.
    for k in ("loss_normal_F", "loss_normal_B", "loss_recon"):
        assert float(metrics[k].detach()) > 0, k
    assert float(jnp.sum(jmetrics["raster_dropped"])) >= 0
    for k, jg in jgrads.items():
        jg = np.asarray(jg)
        v = port_leaves(tparams)[k]
        tg = v.grad if v.is_leaf else (None if v._base.grad is None else v._base.grad.T)
        if not np.any(jg):
            assert tg is None or not bool(tg.any()), k
            continue
        tol = 1e-2 if k.endswith("encoding") else 1e-3
        assert _rel_l2(tg, jg) <= tol, (k, _rel_l2(tg, jg))
    assert np.any(np.asarray(jgrads["xyz"])) and np.any(np.asarray(jgrads["field/encoding"]))


# ---------------------------------------------------------------- the CLIs


def test_cli_dataroot_round_trip(tmp_path, monkeypatch):
    """cli.train --dataroot through both stages with --eval, then
    cli.render_rot and cli.export_mesh on its checkpoint with the same
    capture flags.  The full field's 1000 distillation steps take minutes
    on a CPU, so the avatar is built with a narrow field here."""
    small = AttributeFieldConfig(grid=HashGridConfig(**SMALL_GRID), hidden_dim=16)
    init = tstate.init_avatar
    monkeypatch.setattr(tstate, "init_avatar",
                        lambda *a, **k: init(*a, **dict(k, field_cfg=small)))
    cap = str(tmp_path / "cap")
    mock_capture.make_capture(cap, frames=5, size=64, joints=4, segments=3, ring=8,
                              device="cpu")
    out = str(tmp_path / "run")
    flags = ["--dataroot", cap, "--smpl-model", "test:4,3,8", "--num-subdiv", "1",
             "--device", "cpu"]
    tcli.main(flags + ["--gen-res", "32", "--stage", "both", "--steps", "2", "--eval",
                       "--log-every", "1", "--out", out])
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [(r["step"], r["stage"]) for r in rows] == [(0, 0), (1, 0), (2, 1), (3, 1)]
    for r in rows:
        assert all(np.isfinite(r[k]) for k in ("loss", "loss_normal_F", "loss_normal_B"))
        assert r["loss_normal_F"] > 0
    avg = open(os.path.join(out, "test", "average.txt")).read().split()
    assert len(avg) == 3 and np.isfinite(float(avg[0])) and avg[2] == "nan"
    rot = str(tmp_path / "rot")
    trot.main(flags + ["--ckpt", os.path.join(out, "stage1"), "--num-views", "2",
                       "--out", rot])
    pngs = sorted(f for f in os.listdir(rot) if f.endswith(".png"))
    assert len(pngs) == 8 and read_png(os.path.join(rot, pngs[0])).shape == (64, 64, 3)
    obj = str(tmp_path / "mesh.obj")
    stats = texport.main(flags + ["--ckpt", os.path.join(out, "stage1"), "--field-attrs",
                                  "--resolution", "32", "--out", obj])
    assert stats["verts"] > 100 and stats["faces"] > 100
    # A checkpoint of another subdivision does not fit the rebuilt avatar.
    with pytest.raises(RuntimeError, match="size mismatch"):
        trot.main(flags[:5] + ["0", "--device", "cpu", "--ckpt", os.path.join(out, "stage1"),
                               "--num-views", "1", "--out", rot])
