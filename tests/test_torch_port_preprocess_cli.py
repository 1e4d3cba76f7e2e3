"""``soar_tpu_torch.preproc.preprocess_custom`` against
``soar_tpu.preproc.preprocess_custom`` on the CPU, on one small capture.

The capture: a small 55-joint mock SMPL-X body
(``data.mock_capture.mock_smplx_body(55, 1, 8)``, 448 vertices) written as
an ``.npz`` without landmark tables, so both packages fit the 67 body and
hand columns on kinematic joints (the 137-column fit at SMPL-X's vertex
count is held in ``test_torch_port_smplify.py`` and on the card; the JAX
package takes over a minute to compile it here); two 96-px frames rendered
from its mesh with the mask in alpha; the external tools' outputs
synthesized from the true parameters (``write_tool_outputs``: OpenPose
JSON, SMPLer-X results perturbed by 0.1 rad).  Both CLIs run the ``alpha``
mask backend, SMPLify (cut to 5 body steps and no hand stage in both
packages: each stage is one more minute-long JAX compile, and the
iterates part after a few float32 steps, so the two-stage fit is compared
on its keypoint loss in ``test_torch_port_smplify.py``) and the
template-normal fallback.

Held: the ``params.pth`` keys and shapes equal; the masks equal; the fitted
parameters within 2e-3 (absolute, radians and scene units); ``normal_Ks``
exactly; the normal PNGs within one level on at least 99% of their pixels.
The port's ``bbox`` backend exits naming the other backends when OpenCV
cannot be imported.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from soar_tpu_torch.body.model import save_smplx_npz
from soar_tpu_torch.data import mock_capture as mc
from soar_tpu_torch.data.dataset import _load_params_pth
from soar_tpu_torch.io.png import read_png
from soar_tpu_torch.train.evaluate import save_png

PARAM_TOL = 2e-3
PNG_SHARE = 0.99
SIZE, FRAMES = 96, 2


def _short_smplify(monkeypatch, module):
    cfg = module.SMPLifyConfig

    def short(**kw):
        return cfg(**{"body_steps": 5, "hand_steps": 0, **kw})

    monkeypatch.setattr(module, "SMPLifyConfig", short)


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """Frames of the posed mesh in the capture's camera (w2c the identity,
    the body at +z), RGBA with the silhouette in alpha; the render's own
    truncation at this size is part of the input, the same for both."""
    from soar_tpu_torch.body.model import smplx_forward
    from soar_tpu_torch.render.mesh_raster import get_proj_mat, render_mesh

    root = tmp_path_factory.mktemp("pre")
    seq = root / "seq"
    os.makedirs(seq / "images")
    body = mc.mock_smplx_body(55, 1, 8, device="cpu")
    save_smplx_npz(str(root / "body.npz"), body._replace(
        lmk_faces_idx=None, lmk_bary_coords=None, dyn_lmk_faces_idx=None,
        dyn_lmk_bary_coords=None))
    v = body.v_template.numpy()
    y0, y1 = float(v[:, 1].min()), float(v[:, 1].max())
    focal = 1.1 * SIZE
    rng = np.random.RandomState(0)
    sp = {"betas": np.zeros((1, 10), np.float32),
          "body_pose": (rng.randn(FRAMES, 54 * 3) * 0.05).astype(np.float32),
          "global_orient": np.zeros((FRAMES, 3), np.float32),
          "transl": np.tile([[0.0, -(y0 + y1) / 2, focal * (y1 - y0) / (0.75 * SIZE)]],
                            (FRAMES, 1)).astype(np.float32)}
    K = np.array([[focal, 0, SIZE / 2], [0, focal, SIZE / 2], [0, 0, 1]], np.float32)
    verts = smplx_forward(body, {k: torch.from_numpy(x) for k, x in sp.items()}).vertices
    proj = get_proj_mat(torch.from_numpy(K), (SIZE, SIZE))
    for i in range(FRAMES):
        o = render_mesh(verts[i], body.faces, torch.eye(4), proj, (SIZE, SIZE),
                        max_per_tile=256)
        save_png(str(seq / "images" / f"{i:05d}.png"),
                 np.dstack([o["normal"].numpy(), o["mask"].numpy()]))
    mc.write_tool_outputs(str(seq), body, mc.smplx_segments(sp), np.tile(K[None], (FRAMES, 1, 1)),
                          seed=1)
    for pkg in ("jax", "port"):
        shutil.copytree(seq, root / pkg / "seq")
    return root


@pytest.fixture(scope="module")
def runs(capture):
    from soar_tpu.preproc import preprocess_custom as J
    from soar_tpu.preproc import smplify as Js
    from soar_tpu_torch.preproc import preprocess_custom as T
    from soar_tpu_torch.preproc import smplify as Ts

    mp = pytest.MonkeyPatch()
    try:
        _short_smplify(mp, Js)
        _short_smplify(mp, Ts)
        args = ["--smpl-model", str(capture / "body.npz"), "--mask-backend", "alpha"]
        J.main(["--video-path", str(capture / "jax" / "seq.mp4"),
                "--data-root", str(capture / "jax")] + args)
        T.main(["--video-path", str(capture / "port" / "seq.mp4"),
                "--data-root", str(capture / "port")] + args + ["--device", "cpu"])
    finally:
        mp.undo()
    return {pkg: capture / pkg / "seq" for pkg in ("jax", "port")}


def test_params_pth_matches_jax(runs):
    pj = _load_params_pth(str(runs["jax"] / "smplx" / "params.pth"))
    pt = _load_params_pth(str(runs["port"] / "smplx" / "params.pth"))
    assert {k: v.shape for k, v in pt.items()} == {k: v.shape for k, v in pj.items()}
    assert {"betas", "body_pose", "left_hand_pose", "transl", "Ks", "w2c", "img_wh",
            "normal_Ks"} <= set(pt)
    assert pt["body_pose"].shape == (FRAMES, 21, 3)
    for k in ("Ks", "w2c", "img_wh", "normal_Ks"):
        np.testing.assert_array_equal(pt[k], pj[k])
    for k in ("betas", "body_pose", "global_orient", "transl", "left_hand_pose",
              "right_hand_pose"):
        np.testing.assert_allclose(pt[k], pj[k], atol=PARAM_TOL, err_msg=k)


def test_masks_and_normal_maps_match_jax(runs):
    for sub in ("masks", "normal_F", "normal_B"):
        names = sorted(os.listdir(runs["port"] / sub))
        assert names == sorted(os.listdir(runs["jax"] / sub)) and len(names) == FRAMES
        for f in names:
            a = read_png(str(runs["port"] / sub / f)).astype(np.int16)
            b = read_png(str(runs["jax"] / sub / f)).astype(np.int16)
            assert a.shape == b.shape
            if sub == "masks":
                np.testing.assert_array_equal(a, b)
                continue
            assert a.shape == (512, 512, 4)
            within = np.all(np.abs(a - b) <= 1, axis=-1).mean()
            assert within >= PNG_SHARE, (sub, f, within)
            assert (a[..., 3] > 0).mean() > 0.05


def test_bbox_backend_without_opencv_exits(capture, monkeypatch):
    from soar_tpu_torch.preproc import compute_kp_and_mask as T

    d = capture / "nocv"
    shutil.copytree(capture / "port" / "seq", d)
    shutil.rmtree(d / "masks", ignore_errors=True)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit) as e:
        T.main(["--data-dir", str(d), "--mask-backend", "bbox"])
    assert "--mask-backend sam" in str(e.value) and "--mask-backend alpha" in str(e.value)
    assert not (d / "masks").exists()
