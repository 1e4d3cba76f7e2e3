"""``soar_tpu_torch.preproc.smplify`` and ``preproc.lbfgs`` against
``soar_tpu.preproc.smplify`` and ``optax.lbfgs`` on the CPU.

Tolerances: the rotation helpers, ``gmof``, ``smooth_loss_6d`` and the
mappings to f32 rounding (1e-6; the integer tables exactly); ``_loss`` value
and gradient to 1e-5 relative; the L-BFGS iterates on a convex problem to
1e-5, and on ``_loss`` the first three steps' losses to 1e-4 relative (after
that the two float32 trajectories part, SURVEY §7 hard part #5: the fit is
held on its keypoint loss, not its iterates); a full two-stage fit's final
keypoint error within 30% of JAX's (``FIT_RTOL``; the two trajectories
part after a few steps and end at different points of the same basin), and
both under half the perturbed initialisation's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soar_tpu.body import make_test_body as jax_make_test_body
from soar_tpu.body.model import smplx_forward_full as jax_forward_full
from soar_tpu.core.transforms import batch_rodrigues as jax_rodrigues
from soar_tpu.preproc import smplify as J
from soar_tpu_torch.io.from_jax import body_from_numpy
from soar_tpu_torch.preproc import lbfgs as L
from soar_tpu_torch.preproc import smplify as T
from torch_port_helpers import body_to_numpy, n, t


def test_rotation_helpers_match_jax():
    rng = np.random.RandomState(0)
    d6 = rng.randn(4, 5, 6).astype(np.float32)
    np.testing.assert_allclose(n(T.rotation_6d_to_matrix(t(d6))),
                               np.asarray(J.rotation_6d_to_matrix(jnp.asarray(d6))), atol=1e-6)
    R = np.asarray(jax_rodrigues(jnp.asarray(rng.randn(7, 3).astype(np.float32))))
    np.testing.assert_array_equal(n(T.matrix_to_rotation_6d(t(R))),
                                  np.asarray(J.matrix_to_rotation_6d(jnp.asarray(R))))
    x = (rng.randn(50) * 300).astype(np.float32)
    np.testing.assert_allclose(n(T.gmof(t(x), 100.0)), np.asarray(J.gmof(jnp.asarray(x), 100.0)),
                               rtol=1e-6)
    seq = (rng.randn(5, 3 * 6) * 0.5).astype(np.float32)
    np.testing.assert_allclose(float(T.smooth_loss_6d(t(seq))),
                               float(J.smooth_loss_6d(jnp.asarray(seq))), rtol=1e-5)
    kps = rng.rand(4, 30, 3).astype(np.float32) * [500, 400, 1]
    kps[2, :, 2] = 0.1  # a frame with no confident keypoint
    np.testing.assert_array_equal(T.target_scales_from_kps(kps), J.target_scales_from_kps(kps))


def test_mappings_match_jax():
    for a, b in zip(T.smplx_to_openpose137(), J.smplx_to_openpose137()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(T.smplx_to_openpose25(), J.smplx_to_openpose25())
    np.testing.assert_array_equal(T.smplx_to_openpose_hands(), J.smplx_to_openpose_hands())
    src, dst, _ = J.smplx_to_openpose137()
    j144 = np.random.RandomState(1).randn(3, 144, 3).astype(np.float32)
    want = np.asarray(J.convert_kps_137(jnp.asarray(j144), jnp.asarray(src), jnp.asarray(dst)))
    got = n(T.convert_kps_137(t(j144), torch.as_tensor(src), torch.as_tensor(dst)))
    np.testing.assert_allclose(got, want, atol=1e-6)


def _with_landmark_tables(body, seed=3):
    """The landmark tables of ``tests/test_smplify.py``, fabricated on the
    procedural 55-joint body."""
    rng = np.random.RandomState(seed)
    V, Fc = body.num_verts, body.faces.shape[0]
    bary = rng.rand(51, 3).astype(np.float32)
    bary /= bary.sum(-1, keepdims=True)
    dyn_bary = rng.rand(79, 17, 3).astype(np.float32)
    dyn_bary /= dyn_bary.sum(-1, keepdims=True)
    return body._replace(
        extra_joint_idxs=jnp.asarray(rng.randint(0, V, 21), jnp.int32),
        lmk_faces_idx=jnp.asarray(rng.randint(0, Fc, 51), jnp.int32),
        lmk_bary_coords=jnp.asarray(bary),
        dyn_lmk_faces_idx=jnp.asarray(rng.randint(0, Fc, (79, 17)), jnp.int32),
        dyn_lmk_bary_coords=jnp.asarray(dyn_bary),
    )


FIT_RTOL = 0.3
W = H = 256
KMAT = np.array([[300.0, 0, W / 2], [0, 300.0, H / 2], [0, 0, 1]], np.float32)
W2C = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    """The 137-column problem of ``test_smplify.py::
    test_smplify_openpose137_recovers_perturbed_pose`` (F = 2, a 0.1 rad
    perturbation of the body pose), with hand poses so both stages move."""
    jbody = _with_landmark_tables(jax_make_test_body(num_joints=55, segments_per_bone=1, ring=4))
    tbody = body_from_numpy(body_to_numpy(jbody), device="cpu")
    src, dst, mask = J.smplx_to_openpose137()
    F = 2
    rng = np.random.RandomState(0)
    gt = {
        "betas": np.zeros((F, jbody.num_betas), np.float32),
        "body_pose": (rng.randn(F, 21 * 3) * 0.05).astype(np.float32),
        "global_orient": np.zeros((F, 3), np.float32),
        "left_hand_pose": (rng.randn(F, 15 * 3) * 0.05).astype(np.float32),
        "right_hand_pose": (rng.randn(F, 15 * 3) * 0.05).astype(np.float32),
        "transl": np.tile([[0.0, -7.0, -40.0]], (F, 1)).astype(np.float32),
    }
    Ks = np.tile(KMAT[None], (F, 1, 1))

    def project(params):
        _, j144 = jax_forward_full(jbody, {k: jnp.asarray(v) for k, v in params.items()})
        kps = np.asarray(J.convert_kps_137(j144, jnp.asarray(src), jnp.asarray(dst)))
        pc = np.einsum("ij,fkj->fki", W2C[:3], np.concatenate([kps, np.ones_like(kps[..., :1])], -1))
        px = np.einsum("fij,fkj->fki", Ks, pc)
        return px[..., :2] / np.maximum(px[..., 2:], 1e-5)

    pix = project(gt)
    target = np.concatenate([pix / [W, H], np.ones_like(pix[..., :1])], -1).astype(np.float32)
    init = dict(gt)
    init["body_pose"] = gt["body_pose"] + (0.1 * rng.randn(F, 63)).astype(np.float32)

    def kp_err(params):
        return float((np.abs(project(params) - pix) * mask[None, :, None]).mean())

    return dict(jbody=jbody, tbody=tbody, init=init, target=target, Ks=Ks, kp_err=kp_err)


def _loss_inputs(pb):
    target_px = np.concatenate([pb["target"][..., :2] * np.asarray((W, H), np.float32),
                                pb["target"][..., 2:]], -1).astype(np.float32)
    scales = J.target_scales_from_kps(target_px)
    return pb["Ks"], W2C, target_px, scales


def _stage_split(p6, keys=("betas", "body_pose", "global_orient", "transl")):
    opt = {k: p6[k] for k in keys if k in p6}
    return opt, {k: v for k, v in p6.items() if k not in opt}


CFG = dict(smooth_weight=10000.0, preserve_weight=60.0)


@pytest.mark.parametrize("ignore_hands", [True, False])
def test_loss_value_and_gradient_match_jax(problem, ignore_hands):
    pb = problem
    aux = _loss_inputs(pb)
    jf = J.SMPLify(pb["jbody"], cfg=J.SMPLifyConfig(**CFG), hand_kp_slice=(25, 67),
                   openpose137=True)
    tf = T.SMPLify(pb["tbody"], cfg=T.SMPLifyConfig(**CFG), hand_kp_slice=(25, 67),
                   openpose137=True)
    j6 = J._to_6d({k: jnp.asarray(v) for k, v in pb["init"].items()})
    t6 = T._to_6d({k: t(v) for k, v in pb["init"].items()})
    for k in j6:
        np.testing.assert_allclose(n(t6[k]), np.asarray(j6[k]), atol=1e-6)
    # Away from the initialisation, so the preserve term has a gradient.
    rng = np.random.RandomState(2)
    shift = {k: (rng.randn(*np.shape(j6[k])) * 0.01).astype(np.float32) for k in j6}
    keys = ("betas", "body_pose", "global_orient", "transl") + (
        () if ignore_hands else ("left_hand_pose", "right_hand_pose"))
    jopt, jfix = _stage_split({k: j6[k] + shift[k] for k in j6}, keys)
    topt, tfix = _stage_split({k: t6[k] + t(shift[k]) for k in t6}, keys)
    jaux = tuple(jnp.asarray(a) for a in aux)
    taux = tuple(t(a) for a in aux)
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jf._loss(p, jfix, j6, *jaux,
                                                            ignore_hands=ignore_hands)))(jopt)
    topt = {k: v.clone().requires_grad_(True) for k, v in topt.items()}
    tv = tf._loss(topt, tfix, t6, *taux, ignore_hands=ignore_hands)
    tg = torch.autograd.grad(tv, list(topt.values()))
    assert abs(tv.item() - float(jv)) <= 1e-5 * abs(float(jv))
    for k, g in zip(topt, tg):
        want = np.asarray(jg[k])
        rel = np.linalg.norm(n(g) - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-5, (k, rel)


def _optax_steps(loss_fn, params, steps):
    opt = optax.lbfgs()
    vg = optax.value_and_grad_from_state(loss_fn)

    @jax.jit
    def step(p, s):
        v, g = vg(p, state=s)
        u, s = opt.update(g, s, p, value=v, grad=g, value_fn=loss_fn)
        return optax.apply_updates(p, u), s, v

    s = opt.init(params)
    out = []
    for _ in range(steps):
        params, s, v = step(params, s)
        out.append((float(v), jax.tree_util.tree_map(np.asarray, params),
                    int(optax.tree.get(s, "num_linesearch_steps"))))
    return out


@pytest.mark.parametrize("n_dim,seed", [(6, 0), (40, 1)])
def test_lbfgs_matches_optax_on_a_convex_quadratic(n_dim, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(n_dim, n_dim).astype(np.float32)
    Q = (A @ A.T / n_dim + 0.05 * np.eye(n_dim)).astype(np.float32)
    b = rng.randn(n_dim).astype(np.float32)
    half = n_dim // 2
    x0 = {"u": rng.randn(half).astype(np.float32), "v": rng.randn(n_dim - half).astype(np.float32)}

    def fj(p):
        x = jnp.concatenate([p["u"], p["v"]])
        return 0.5 * x @ jnp.asarray(Q) @ x - jnp.asarray(b) @ x

    Qt, bt = t(Q), t(b)

    def ft(p):
        x = torch.cat([p["u"], p["v"]])
        return 0.5 * x @ Qt @ x - bt @ x

    want = _optax_steps(fj, {k: jnp.asarray(v) for k, v in x0.items()}, 8)
    opt = L.LBFGS()
    p = {k: t(v) for k, v in x0.items()}
    s = opt.init(p)
    for v_j, p_j, ls_j in want:
        p, s, v = opt.step(p, s, ft)
        np.testing.assert_allclose(float(v), v_j, rtol=1e-5, atol=1e-5)
        for k in p:
            np.testing.assert_allclose(n(p[k]), p_j[k], atol=1e-5)
        assert s.linesearch_steps == ls_j


def _rosenbrock(x, lib):
    return lib.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _kinked(x, lib):
    return lib.sum(lib.abs(x)) + 0.05 * lib.sum(x**2) + lib.abs(x[0] - x[1])


@pytest.mark.parametrize("fn,x0,steps", [
    (_rosenbrock, [-1.2, 1.0, -0.5, 0.8], 14),
    (_kinked, [1.3, -0.7, 0.4, 2.2, -1.1], 15),
])
def test_lbfgs_linesearch_matches_optax(fn, x0, steps):
    """Rosenbrock makes the linesearch zoom; the kinked function makes it
    run long and fall back on its safe step.  Iterates, values and
    linesearch lengths agree until float32 rounding parts them."""
    x0 = {"a": np.asarray(x0, np.float32)}
    want = _optax_steps(lambda p: fn(p["a"], jnp), {"a": jnp.asarray(x0["a"])}, steps)
    assert max(w[2] for w in want) >= 2
    opt = L.LBFGS()
    p = {"a": t(x0["a"])}
    s = opt.init(p)
    for v_j, p_j, ls_j in want:
        p, s, v = opt.step(p, s, lambda q: fn(q["a"], torch))
        np.testing.assert_allclose(float(v), v_j, rtol=1e-5)
        np.testing.assert_allclose(n(p["a"]), p_j["a"], atol=1e-5)
        assert s.linesearch_steps == ls_j


def test_lbfgs_on_the_smplify_loss_matches_optax(problem):
    pb = problem
    aux = _loss_inputs(pb)
    jf = J.SMPLify(pb["jbody"], cfg=J.SMPLifyConfig(**CFG), hand_kp_slice=(25, 67),
                   openpose137=True)
    tf = T.SMPLify(pb["tbody"], cfg=T.SMPLifyConfig(**CFG), hand_kp_slice=(25, 67),
                   openpose137=True)
    j6 = J._to_6d({k: jnp.asarray(v) for k, v in pb["init"].items()})
    t6 = T._to_6d({k: t(v) for k, v in pb["init"].items()})
    jopt, jfix = _stage_split(j6)
    topt, tfix = _stage_split(t6)
    jaux = tuple(jnp.asarray(a) for a in aux)
    taux = tuple(t(a) for a in aux)
    want = _optax_steps(lambda p: jf._loss(p, jfix, j6, *jaux, ignore_hands=True), jopt, 3)
    _, got, _ = L.run(topt, lambda p: tf._loss(p, tfix, t6, *taux, ignore_hands=True), 3)
    for (v_j, _, _), v_t in zip(want, got):
        assert abs(v_t - v_j) <= 1e-4 * abs(v_j), (got, [w[0] for w in want])
    assert got[2] < got[0]


def test_fit_matches_jax(problem):
    pb = problem
    cfg = dict(body_steps=10, hand_steps=4, smooth_weight=0.0, preserve_weight=0.1)
    jf = J.SMPLify(pb["jbody"], cfg=J.SMPLifyConfig(**cfg), hand_kp_slice=(25, 67),
                   openpose137=True)
    tf = T.SMPLify(pb["tbody"], cfg=T.SMPLifyConfig(**cfg), hand_kp_slice=(25, 67),
                   openpose137=True)
    jfit = jf.fit({k: jnp.asarray(v) for k, v in pb["init"].items()}, jnp.asarray(pb["Ks"]),
                  jnp.asarray(W2C), pb["target"], (W, H))
    tfit = tf.fit({k: t(v) for k, v in pb["init"].items()}, t(pb["Ks"]), t(W2C), pb["target"],
                  (W, H))
    assert set(tfit) == set(jfit)
    err0 = pb["kp_err"](pb["init"])
    err_j = pb["kp_err"]({k: np.asarray(v) for k, v in jfit.items()})
    err_t = pb["kp_err"]({k: n(v) for k, v in tfit.items()})
    assert err_j < 0.5 * err0 and err_t < 0.5 * err0, (err0, err_j, err_t)
    assert abs(err_t - err_j) <= FIT_RTOL * err_j, (err_j, err_t)
    assert [len(h["values"]) for h in tf.history] == [10, 4]
    assert all(e >= 1 for h in tf.history for e in h["evaluations"])


def test_fit_at_cli_weights_raises_stage2_loss_in_both_packages(problem):
    """The CLI's configuration (20 + 40 steps, preserve 60, smooth 1e4):
    in the body+hands stage both L-BFGS runs take steps that raise the loss
    (a linesearch that spends its 20 evaluations without sufficient decrease
    takes its last step), and the two stages still end in one basin.  The
    JAX side is ``SMPLify._run_stage``'s optax loop, recorded step by step.
    Bounds: a rise of more than ``RISE`` at some stage-2 step in each
    package; the stage-2 minimum and last loss within ``FIT_RTOL`` of
    JAX's; both keypoint errors under half the initialisation's."""
    RISE = 1.1
    pb = problem
    cfg = J.SMPLifyConfig()
    assert (cfg.body_steps, cfg.hand_steps, cfg.preserve_weight, cfg.smooth_weight) == (
        20, 40, 60.0, 10000.0)
    tf = T.SMPLify(pb["tbody"], cfg=T.SMPLifyConfig(), hand_kp_slice=(25, 67), openpose137=True)
    tfit = tf.fit({k: t(v) for k, v in pb["init"].items()}, t(pb["Ks"]), t(W2C), pb["target"],
                  (W, H))
    t2 = tf.history[1]["values"]

    jf = J.SMPLify(pb["jbody"], cfg=cfg, hand_kp_slice=(25, 67), openpose137=True)
    aux = tuple(jnp.asarray(a) for a in _loss_inputs(pb))
    j6 = J._to_6d({k: jnp.asarray(v) for k, v in pb["init"].items()})
    jopt, jfix = _stage_split(j6)
    out = _optax_steps(lambda p: jf._loss(p, jfix, j6, *aux, ignore_hands=True), jopt,
                       cfg.body_steps)
    jopt, jfix = _stage_split({**jfix, **out[-1][1]}, (
        "betas", "body_pose", "global_orient", "transl", "left_hand_pose", "right_hand_pose"))
    out = _optax_steps(lambda p: jf._loss(p, jfix, j6, *aux, ignore_hands=False), jopt,
                       cfg.hand_steps)
    j2 = [o[0] for o in out]
    jfit = J._to_axis_angle({**jfix, **out[-1][1]}, pb["Ks"].shape[0])

    assert len(t2) == len(j2) == cfg.hand_steps
    rise_t = max(b / a for a, b in zip(t2, t2[1:]))
    rise_j = max(b / a for a, b in zip(j2, j2[1:]))
    assert rise_t > RISE and rise_j > RISE, (rise_t, rise_j)
    assert abs(min(t2) - min(j2)) <= FIT_RTOL * min(j2), (min(t2), min(j2))
    assert abs(t2[-1] - j2[-1]) <= FIT_RTOL * j2[-1], (t2[-1], j2[-1])
    err0 = pb["kp_err"](pb["init"])
    err_j = pb["kp_err"]({k: np.asarray(v) for k, v in jfit.items()})
    err_t = pb["kp_err"]({k: n(v) for k, v in tfit.items()})
    assert err_j < 0.5 * err0 and err_t < 0.5 * err0, (err0, err_j, err_t)
