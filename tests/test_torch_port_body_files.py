"""The port's body-model files against soar_tpu on the CPU: the SMPL-X
``.npz`` and SMPL ``.pkl`` loaders, the 144-joint landmark output, the
neck-contour buckets, the npz/pkl dispatch of ``cli.common.load_body_model``
and the body carried across by ``io.from_jax.body_from_numpy``.

The files are written here from a seed in the official layouts (SMPL-X:
V = 9,930, the fewest vertices that hold the extra-joint vertex ids, 55
joints, 400 shape columns, MANO hand means, static and dynamic landmark
tables; SMPL: 24 joints and a scipy-sparse ``J_regressor``).

Tolerances: the loaders do the same numpy slicing and transposes, so every
field is equal; LBS is the same float32 arithmetic in another order (1e-5
on outputs of order 1); the neck buckets round an angle in degrees, so
they are equal unless an angle falls within float32 rounding of a half
degree, which the seeded poses do not.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse

from soar_tpu.body import model as jmodel
from soar_tpu_torch.body import model as tmodel
from soar_tpu_torch.cli import common as tcommon
from soar_tpu_torch.io.from_jax import body_from_numpy
from torch_port_helpers import assert_close, body_to_numpy, n, t

# The SMPL-X kinematic tree (55 joints).
SMPLX_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                 15, 15, 15, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
                 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53]
SMPL_PARENTS = [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
                20, 21]
BODY_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights", "faces",
               "pose_mean", "extra_joint_idxs", "lmk_faces_idx", "lmk_bary_coords",
               "dyn_lmk_faces_idx", "dyn_lmk_bary_coords")


def _skin_arrays(rng, V, J, n_shape, n_faces):
    """Template, blend shapes, regressor, weights and faces of a seeded
    body: vertices around the joints, so LBS moves them by O(1)."""
    v_template = rng.randn(V, 3).astype(np.float32) * 0.3
    weights = rng.rand(V, J).astype(np.float32) ** 4
    weights /= weights.sum(1, keepdims=True)
    J_regressor = rng.rand(J, V).astype(np.float32) * (rng.rand(J, V) < 0.01)
    J_regressor[:, 0] += 1e-3
    J_regressor /= J_regressor.sum(1, keepdims=True)
    return dict(
        v_template=v_template,
        shapedirs=(rng.randn(V, 3, n_shape) * 0.01).astype(np.float32),
        posedirs=(rng.randn(V, 3, (J - 1) * 9) * 1e-3).astype(np.float32),
        J_regressor=J_regressor,
        weights=weights,
        f=rng.randint(0, V, (n_faces, 3)).astype(np.uint32),
    )


@pytest.fixture(scope="module")
def smplx_npz(tmp_path_factory):
    rng = np.random.RandomState(0)
    V, J, n_faces = 9930, 55, 2000
    arrays = _skin_arrays(rng, V, J, 400, n_faces)
    kintree = np.stack([np.array(SMPLX_PARENTS), np.arange(J)]).astype(np.int64)
    kintree[0, 0] = 4294967295  # as the official files store the root's parent
    bary = rng.rand(79, 17, 3).astype(np.float32)
    arrays.update(
        kintree_table=kintree,
        hands_meanl=(rng.randn(45) * 0.2).astype(np.float32),
        hands_meanr=(rng.randn(45) * 0.2).astype(np.float32),
        lmk_faces_idx=rng.randint(0, n_faces, 51).astype(np.int64),
        lmk_bary_coords=rng.dirichlet(np.ones(3), 51).astype(np.float32),
        dynamic_lmk_faces_idx=rng.randint(0, n_faces, (79, 17)).astype(np.int64),
        dynamic_lmk_bary_coords=bary / bary.sum(-1, keepdims=True),
    )
    path = tmp_path_factory.mktemp("smplx") / "SMPLX_TEST.npz"
    np.savez(path, **arrays)
    return str(path), jmodel.load_smplx_npz(str(path))


@pytest.fixture(scope="module")
def smpl_pkl(tmp_path_factory):
    rng = np.random.RandomState(1)
    V, J = 300, 24
    arrays = _skin_arrays(rng, V, J, 10, 500)
    arrays["J_regressor"] = scipy.sparse.csc_matrix(arrays["J_regressor"])
    arrays["kintree_table"] = np.stack([np.array(SMPL_PARENTS), np.arange(J)]).astype(np.int64)
    path = tmp_path_factory.mktemp("smpl") / "basicModel_test.pkl"
    with open(path, "wb") as f:
        pickle.dump(arrays, f)
    return str(path), jmodel.load_smpl_pkl(str(path))


def _assert_bodies_equal(tb, jb):
    assert tuple(tb.parents) == tuple(jb.parents) and tb.parents[0] == -1
    assert tb.num_betas == jb.num_betas
    for k in BODY_FIELDS:
        got, want = getattr(tb, k), getattr(jb, k)
        assert (got is None) == (want is None), k
        if want is not None:
            assert tuple(got.shape) == tuple(want.shape), k
            np.testing.assert_array_equal(n(got), np.asarray(want), err_msg=k)
    assert str(tb.faces.dtype) == "torch.int64"


def _smplx_params(rng, B, scale=0.3):
    return {
        "betas": rng.randn(B, 10).astype(np.float32),
        "global_orient": (rng.randn(B, 3) * scale).astype(np.float32),
        "body_pose": (rng.randn(B, 63) * scale).astype(np.float32),
        "jaw_pose": (rng.randn(B, 3) * scale).astype(np.float32),
        "leye_pose": (rng.randn(B, 3) * scale).astype(np.float32),
        "reye_pose": (rng.randn(B, 3) * scale).astype(np.float32),
        "left_hand_pose": (rng.randn(B, 45) * scale).astype(np.float32),
        "right_hand_pose": (rng.randn(B, 45) * scale).astype(np.float32),
        "expression": rng.randn(B, 10).astype(np.float32),
        "transl": rng.randn(B, 3).astype(np.float32),
    }


def test_load_smplx_npz_matches_jax(smplx_npz):
    path, jb = smplx_npz
    tb = tmodel.load_smplx_npz(path, device="cpu")
    _assert_bodies_equal(tb, jb)
    assert tb.shapedirs.shape[-1] == 20 and tb.posedirs.shape == (54 * 9, 9930 * 3)
    assert tb.pose_mean is not None and not bool(tb.pose_mean[:75].any())
    # The CLIs' dispatch reads the same file.
    _assert_bodies_equal(tcommon.load_body_model(path, device="cpu"), jb)


def test_smplx_forward_and_landmarks_match_jax(smplx_npz):
    path, jb = smplx_npz
    tb = tmodel.load_smplx_npz(path, device="cpu")
    sp = _smplx_params(np.random.RandomState(2), 3)
    jout = jmodel.smplx_forward(jb, {k: jnp.asarray(v) for k, v in sp.items()})
    tout = tmodel.smplx_forward(tb, {k: t(v) for k, v in sp.items()})
    for name in ("vertices", "joints", "A"):
        assert_close(getattr(tout, name), getattr(jout, name), 1e-5, msg=name)
    jfull, j144 = jmodel.smplx_forward_full(jb, {k: jnp.asarray(v) for k, v in sp.items()})
    tfull, t144 = tmodel.smplx_forward_full(tb, {k: t(v) for k, v in sp.items()})
    assert tuple(t144.shape) == (3, 144, 3)
    assert_close(tfull.vertices, jfull.vertices, 1e-5)
    assert_close(t144, j144, 1e-5)
    # A body without the landmark tables refuses the full output.
    with pytest.raises(ValueError, match="landmark"):
        tmodel.smplx_forward_full(tmodel.make_test_body(device="cpu"),
                                  {"betas": t(np.zeros((1, 4), np.float32))})


def test_neck_buckets_match_jax(smplx_npz):
    _, jb = smplx_npz
    rng = np.random.RandomState(3)
    pose = (rng.randn(256, 55 * 3) * 0.6).astype(np.float32)
    jbk = np.asarray(jmodel._neck_y_bucket(jnp.asarray(pose), jb.parents))
    tbk = n(tmodel._neck_y_bucket(t(pose), jb.parents))
    np.testing.assert_array_equal(tbk, jbk)
    assert len(np.unique(jbk)) > 20 and jbk.min() >= 0 and jbk.max() <= 78
    # The landmark interpolation on its own, batched tables included.
    verts = rng.randn(2, 50, 3).astype(np.float32)
    faces = rng.randint(0, 50, (40, 3))
    idx = rng.randint(0, 40, (2, 7))
    bary = rng.rand(2, 7, 3).astype(np.float32)
    want = jmodel.vertices2landmarks(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(idx),
                                     jnp.asarray(bary))
    got = tmodel.vertices2landmarks(t(verts), t(faces), t(idx), t(bary))
    assert_close(got, want, 1e-6)


def test_load_smpl_pkl_matches_jax(smpl_pkl):
    path, jb = smpl_pkl
    tb = tmodel.load_smpl_pkl(path, device="cpu")
    _assert_bodies_equal(tb, jb)
    assert tb.pose_mean is None and tb.extra_joint_idxs is None
    _assert_bodies_equal(tcommon.load_body_model(path, device="cpu"), jb)
    rng = np.random.RandomState(4)
    sp = {"betas": rng.randn(2, 10).astype(np.float32),
          "global_orient": (rng.randn(2, 3) * 0.3).astype(np.float32),
          "body_pose": (rng.randn(2, 69) * 0.3).astype(np.float32),
          "transl": rng.randn(2, 3).astype(np.float32)}
    jout = jmodel.smplx_forward(jb, {k: jnp.asarray(v) for k, v in sp.items()})
    tout = tmodel.smplx_forward(tb, {k: t(v) for k, v in sp.items()})
    for name in ("vertices", "joints", "A"):
        assert_close(getattr(tout, name), getattr(jout, name), 1e-5, msg=name)


def test_missing_body_files_raise(tmp_path):
    for load in (tmodel.load_smplx_npz, tmodel.load_smpl_pkl):
        with pytest.raises(FileNotFoundError):
            load(str(tmp_path / "absent"), device="cpu")


def test_body_from_numpy_carries_the_landmarks(smplx_npz, smpl_pkl):
    for path, jb in (smplx_npz, smpl_pkl):
        _assert_bodies_equal(body_from_numpy(body_to_numpy(jb), device="cpu"), jb)
