"""The benchmark's SMPL-X-layout body (``benchmark/smplx_body.py``, at its
small layout: SMPL-X's 55 joints and tree, 4- to 8-vertex rings) against
soar_tpu on the CPU: the file reads back through the port's
``cli.common.load_body_model`` equal to what ``soar_tpu.body.model.
load_smplx_npz`` reads (the same numpy slicing and transposes), and
``smplx_forward`` with all seven pose segments, the expressions, the betas
and the MANO hand means matches soar_tpu's to 1e-5 (the same float32
arithmetic in another order, on outputs of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from benchmark import smplx_body
from soar_tpu.body import model as jmodel
from soar_tpu_torch.body.model import smplx_forward
from soar_tpu_torch.cli import common as tcommon
from torch_port_helpers import assert_close, n, t

SEED = 4242
FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights", "faces",
          "pose_mean")


@pytest.fixture(scope="module")
def body_file(tmp_path_factory):
    path = smplx_body.write(SEED, smplx_body.SMALL_TUBES, str(tmp_path_factory.mktemp("smplx")))
    return path, jmodel.load_smplx_npz(path)


def test_the_written_body_reads_back_as_soar_tpu_reads_it(body_file):
    path, jb = body_file
    tb = tcommon.load_body_model(path, device="cpu")
    assert tuple(tb.parents) == tuple(jb.parents) == smplx_body.PARENTS
    assert tb.num_betas == jb.num_betas == 10
    for k in FIELDS:
        got, want = getattr(tb, k), getattr(jb, k)
        assert tuple(got.shape) == tuple(want.shape), k
        np.testing.assert_array_equal(n(got), np.asarray(want), err_msg=k)
    V = smplx_body.counts(smplx_body.SMALL_TUBES)[0]
    assert tb.shapedirs.shape == (V, 3, 20) and tb.posedirs.shape == (486, V * 3)
    assert bool(tb.pose_mean[75:].any()) and not bool(tb.pose_mean[:75].any())
    assert tb.lmk_faces_idx is None and jb.lmk_faces_idx is None


def _params(rng, B):
    """Every SMPL-X segment at the benchmark's draw scales, per item."""
    def draw(k, std):
        return (rng.randn(B, k) * std).astype(np.float32)

    return {"betas": draw(10, 1.0), "global_orient": draw(3, 1.0), "body_pose": draw(63, 0.3),
            "jaw_pose": draw(3, 0.1), "leye_pose": draw(3, 0.1), "reye_pose": draw(3, 0.1),
            "left_hand_pose": draw(45, 0.3), "right_hand_pose": draw(45, 0.3),
            "expression": draw(10, 1.0), "transl": draw(3, 1.0)}


def _forward(body, sp):
    return smplx_forward(body, {k: t(v) for k, v in sp.items()})


def test_smplx_forward_with_every_segment_matches_soar_tpu(body_file):
    path, jb = body_file
    tb = tcommon.load_body_model(path, device="cpu")
    sp = _params(np.random.RandomState(SEED), 3)
    jout = jmodel.smplx_forward(jb, {k: jnp.asarray(v) for k, v in sp.items()})
    tout = _forward(tb, sp)
    for name in ("vertices", "joints", "A"):
        assert_close(getattr(tout, name), getattr(jout, name), 1e-5, msg=name)
    # Each segment moves the body: none is dropped on either side.
    for seg in ("jaw_pose", "left_hand_pose", "right_hand_pose", "expression"):
        moved = dict(sp, **{seg: np.zeros_like(sp[seg])})
        assert float(np.abs(n(_forward(tb, moved).vertices)
                            - n(tout.vertices)).max()) > 1e-3, seg
