"""The preprocessing helpers of ``soar_tpu_torch.preproc`` against
``soar_tpu.preproc`` on the CPU.

- ECON's NormalNet, tiny (ngf 8, ECON's 4 downsamples and 9 blocks), with
  random flax weights carried across (``io.from_jax.normalnet_from_flax``)
  and the port's ECON-keyed ``state_dict`` carried back through JAX's
  ``convert_normalnet_params``: outputs within 2e-4 (each package is
  ~5e-5 from float64 after 25 float32 convolutions and instance norms).
- ``cleanup_mask`` (scipy.ndimage) bit-equal to the JAX package's OpenCV
  version on random masks, blobs touching the border and equal-area
  components.
- ``transform_K_by_bbox``, ``crop_grid`` and ``mask_bbox`` exactly.
- The crop's float bilinear sampling against ``cv2.remap``: OpenCV
  quantizes the bilinear weights to 1/32 px, so the two differ by at most
  1/32 of the largest step between neighbouring source pixels.
- ``load_keypoints``, ``compute_prompt``, and ``extract_frames``' OpenCV
  branch on a video the test writes.
"""

import functools
import json
import os
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.preproc import compute_normal as Jcn
from soar_tpu.preproc import normal_net as Jnn
from soar_tpu_torch.io.from_jax import normalnet_from_flax
from soar_tpu_torch.preproc import compute_normal as Tcn
from soar_tpu_torch.preproc import normal_net as Tnn
from torch_port_helpers import n, t

NN_TOL = 2e-4


@pytest.fixture(scope="module")
def tiny_normalnet():
    """The JAX NormalNet with its generators at ngf 8 (the module looks the
    generator class up when it is applied)."""
    gen = functools.partial(Jnn.GlobalGenerator, ngf=8)
    orig = Jnn.GlobalGenerator
    Jnn.GlobalGenerator = gen
    try:
        net = Jnn.NormalNet()
        x = jnp.zeros((1, 64, 64, 3))
        v = net.init(jax.random.PRNGKey(0), x, x, x)
        leaves, td = jax.tree_util.tree_flatten(v)
        key = jax.random.PRNGKey(1)
        drawn = []
        for leaf in leaves:
            key, k = jax.random.split(key)
            drawn.append(jax.random.normal(k, leaf.shape) * 0.2)
        v = jax.tree_util.tree_unflatten(td, drawn)
        rng = np.random.RandomState(0)
        img = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
        img[:, :9] = 0.0  # background rows: masked out
        tf, tb = (rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32) for _ in range(2))
        want = net.apply(v, *(jnp.asarray(z) for z in (img, tf, tb)))
        yield net, v, (img, tf, tb), [np.asarray(w) for w in want]
    finally:
        Jnn.GlobalGenerator = orig


def _nchw(x):
    return t(x).permute(0, 3, 1, 2)


def test_normalnet_from_flax_matches(tiny_normalnet):
    _, v, inputs, want = tiny_normalnet
    tnet = Tnn.NormalNet(ngf=8)
    tnet.load_state_dict(normalnet_from_flax(jax.tree_util.tree_map(np.asarray, v)), strict=True)
    with torch.no_grad():
        got = tnet(*(_nchw(z) for z in inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(n(g.permute(0, 2, 3, 1)), w, atol=NN_TOL)
        assert np.all(w[:, :9] == 0.0) and np.all(n(g)[:, :, :9] == 0.0)
    norms = np.linalg.norm(want[0][:, 9:], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)


def test_normalnet_econ_keys_through_the_jax_converter(tiny_normalnet):
    net, _, inputs, _ = tiny_normalnet
    tnet = Tnn.NormalNet(ngf=8)
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in tnet.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.2)
    sd = tnet.state_dict()
    assert "netF.model.1.weight" in sd and "netB.model.38.weight" in sd
    assert "netF.model.16.conv_block.5.weight" in sd and "netF.model.25.weight" in sd
    ckpt = {"state_dict": {**{k: v for k, v in sd.items()}, "other.head.weight": torch.ones(1)}}
    assert Tnn.econ_state_dict(ckpt).keys() == sd.keys()
    variables = Jnn.convert_normalnet_params({k: v.numpy() for k, v in sd.items()})
    want = net.apply(variables, *(jnp.asarray(z) for z in inputs))
    with torch.no_grad():
        got = tnet(*(_nchw(z) for z in inputs))
    for gg, w in zip(got, want):
        np.testing.assert_allclose(n(gg.permute(0, 2, 3, 1)), np.asarray(w), atol=NN_TOL)


def test_normalnet_full_shape_keys_are_econs():
    with torch.device("meta"):
        net = Tnn.NormalNet()
    sd = net.state_dict()
    assert len(sd) == 2 * (2 * (1 + 4 + 2 * 9 + 4 + 1))
    assert tuple(sd["netF.model.1.weight"].shape) == (64, 6, 7, 7)
    assert tuple(sd["netF.model.25.weight"].shape) == (1024, 512, 3, 3)
    assert tuple(sd["netB.model.38.weight"].shape) == (3, 64, 7, 7)
    assert sum(p.numel() for p in net.netF.parameters()) == 182_452_675


def _random_masks():
    rng = np.random.RandomState(0)
    out = []
    for i in range(60):
        H, W = rng.randint(16, 80, 2)
        m = np.zeros((H, W), np.uint8)
        if i % 3 == 0:
            m = ((rng.rand(H, W) > 0.55) * 255).astype(np.uint8)
        elif i % 3 == 1:  # rectangles, some through the border
            for _ in range(rng.randint(1, 8)):
                y, x = rng.randint(-6, H), rng.randint(-6, W)
                h, w = rng.randint(2, 20, 2)
                m[max(y, 0):y + h, max(x, 0):x + w] = 255
        else:  # equal-area squares, 7 px or more apart: ties for the largest
            H, W = max(H, 48), max(W, 48)
            m = np.zeros((H, W), np.uint8)
            cols = W // 16
            for c in rng.permutation((H // 16) * cols)[:3]:
                y, x = (c // cols) * 16 + rng.randint(3, 6), (c % cols) * 16 + rng.randint(3, 6)
                m[y:y + 7, x:x + 7] = 255
        out.append(m)
    big = np.zeros((512, 384), np.uint8)
    for y, x in ((0, 0), (1, 100), (300, 200), (507, 380)):
        big[y:y + 25, x:x + 25] = 255
    return out + [big]


def test_cleanup_mask_bit_equal_to_opencv():
    from soar_tpu.preproc.compute_kp_and_mask import cleanup_mask as jclean
    from soar_tpu_torch.preproc.compute_kp_and_mask import cleanup_mask as tclean

    import cv2

    ties = 0
    for m in _random_masks():
        np.testing.assert_array_equal(tclean(m), jclean(m))
        k = np.ones((5, 5), np.uint8)
        opened = cv2.morphologyEx(cv2.morphologyEx(m, cv2.MORPH_OPEN, k), cv2.MORPH_CLOSE, k)
        area = np.sort(cv2.connectedComponentsWithStats(opened, connectivity=8)[2][1:, 4])
        ties += len(area) > 1 and area[-1] == area[-2]
    assert ties >= 10, ties


def test_crop_geometry_matches_jax():
    rng = np.random.RandomState(1)
    for _ in range(5):
        m = np.zeros((120, 90), bool)
        y, x = rng.randint(0, 60), rng.randint(0, 45)
        m[y:y + rng.randint(10, 60), x:x + rng.randint(5, 45)] = True
        bb_j, bb_t = Jcn.mask_bbox(m), Tcn.mask_bbox(m)
        assert bb_t == bb_j
        K = np.array([[300.0, 0, 44.7], [0, 310.0, 61.2], [0, 0, 1]], np.float32)
        np.testing.assert_array_equal(Tcn.transform_K_by_bbox(K, bb_t, (512, 512)),
                                      Jcn.transform_K_by_bbox(K, bb_j, (512, 512)))
        for a, b in zip(Tcn.crop_grid(bb_t, (512, 512)), Jcn.crop_grid(bb_j, (512, 512))):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        Jcn.mask_bbox(np.zeros((8, 8), bool))
    with pytest.raises(ValueError):
        Tcn.mask_bbox(np.zeros((8, 8), bool))


@pytest.mark.parametrize("channels", [3, 1])
def test_crop_against_cv2_remap(channels):
    import cv2

    rng = np.random.RandomState(2)
    img = rng.rand(70, 50, channels).astype(np.float32)
    mask = np.zeros((70, 50), bool)
    mask[5:66, 2:49] = True  # a bbox whose crop runs past the frame
    mx, my = Jcn.crop_grid(Jcn.mask_bbox(mask), (512, 512))
    want = cv2.remap(img, mx, my, cv2.INTER_LINEAR)
    want = want.reshape(want.shape[:2] + (channels,))
    got = n(Tcn.remap_bilinear(t(img), t(mx), t(my)))
    step = max(np.abs(np.diff(img, axis=0)).max(), np.abs(np.diff(img, axis=1)).max(),
               img.max())  # the border counts as 0
    assert np.abs(got - want).max() <= step / 32 + 1e-6
    assert (mx < 0).any() and (mx > 49).any()


def test_load_keypoints_and_compute_prompt(tmp_path):
    from soar_tpu.preproc.compute_prompt import main as jprompt
    from soar_tpu.preproc.keypoints import load_keypoints as jload
    from soar_tpu_torch.preproc.compute_prompt import main as tprompt
    from soar_tpu_torch.preproc.keypoints import load_keypoints as tload

    rng = np.random.RandomState(3)
    kp = tmp_path / "kp"
    kp.mkdir()
    for i in range(4):
        people = [] if i == 2 else [{
            "pose_keypoints_2d": rng.rand(75).tolist(),
            "hand_left_keypoints_2d": rng.rand(63).tolist(),
            "hand_right_keypoints_2d": rng.rand(63).tolist(),
            "face_keypoints_2d": rng.rand(210).tolist()}]
        (kp / f"{i:05d}_keypoints.json").write_text(json.dumps({"people": people}))
    got, want = tload(str(kp)), jload(str(kp))
    assert got.shape == (4, 137, 3)
    np.testing.assert_array_equal(got, want)
    assert not got[2].any()

    for main, sub in ((jprompt, "j"), (tprompt, "t")):
        (tmp_path / sub).mkdir()
        main(["--data-dir", str(tmp_path / sub), "--prompt", "  a person in a red coat \n"])
    assert ((tmp_path / "t" / "prompt.txt").read_text()
            == (tmp_path / "j" / "prompt.txt").read_text() == "a person in a red coat\n")
    with pytest.raises(SystemExit):
        tprompt(["--data-dir", str(tmp_path)])


def test_extract_frames_opencv_branch(tmp_path, monkeypatch):
    import cv2

    from soar_tpu.preproc.extract_frames import main as jmain
    from soar_tpu_torch.io.png import read_png
    from soar_tpu_torch.preproc import extract_frames as T

    vid = osp.join(str(tmp_path), "seq.mp4")
    vw = cv2.VideoWriter(vid, cv2.VideoWriter_fourcc(*"mp4v"), 10, (64, 48))
    if not vw.isOpened():
        pytest.skip("no mp4 encoder in this OpenCV build")
    for i in range(12):
        vw.write(np.full((48, 64, 3), (i * 20, 255 - i * 20, 90), np.uint8))
    vw.release()
    # The OpenCV branch runs where no ffmpeg binary is on the path.
    monkeypatch.setattr(T.shutil, "which", lambda name: None)
    monkeypatch.setattr("soar_tpu.preproc.extract_frames.shutil.which", lambda name: None)
    args = ["--video-path", vid, "--skip-time", "3", "--height", "24"]
    jmain(args + ["--data-root", str(tmp_path / "j")])
    T.main(args + ["--data-root", str(tmp_path / "t")])
    names = sorted(os.listdir(tmp_path / "t" / "seq" / "images"))
    assert names == sorted(os.listdir(tmp_path / "j" / "seq" / "images"))
    assert len(names) == 4  # every third of 12
    for f in names:
        a = read_png(str(tmp_path / "t" / "seq" / "images" / f))
        b = read_png(str(tmp_path / "j" / "seq" / "images" / f))
        assert a.shape == (24, 32, 3)
        np.testing.assert_array_equal(a, b)
    assert osp.islink(tmp_path / "t" / "seq" / "video.mp4")
    T.main(args + ["--data-root", str(tmp_path / "t")])  # frames exist: skipped
