"""The training slice against soar_tpu on the CPU: losses, background,
learning-rate schedule, camera sampler, optimizer, field distillation, one
whole train step with the JAX draws injected, and the CLI round trip.

Tolerances, each with its reason:
- elementwise float32 with the same arithmetic: 1e-5 (1e-4 relative for
  sums over images, whose order differs);
- the optimizer is fed identical gradients, so the moments agree to float32
  rounding (1e-5 relative) and the parameters to 3e-5 relative: optax
  computes the bias correction 1 - 0.999^t in float32, where 0.999 rounds
  and the cancellation leaves 1.3e-5 relative at t = 1, while torch's CPU
  Adam computes it in float64;
- the train step's losses go through ~10 renders whose preprocess differs
  by ~1e-6 relative and whose pixels may flip at an alpha or T threshold:
  1e-4 relative;
- gradients: relative L2 difference per leaf, 1e-3; the hash tables are
  gathered from a bf16 copy in both packages, and their cotangents are
  scatter-added in bf16 in another order, so they are held to 1e-2;
- updated parameters: Adam with eps = 1e-15 moves every entry with a
  nonzero gradient by about the learning rate on the first step, whatever
  the gradient's size, so they are compared only where |g| is well above
  the noise (1e-3 of the leaf's largest |g|) and the two gradients agree in
  sign there.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from soar_tpu.avatar.optim import expon_lr_schedule as jexpon, make_optimizer as jmake_opt
from soar_tpu.core import camera as jcam
from soar_tpu.data import cameras as jcams
from soar_tpu.data.dataset import AvatarDataset as JDataset
from soar_tpu.field.attribute_field import reset_field as jreset_field
from soar_tpu.render.types import RasterConfig as JRasterConfig
from soar_tpu.train import background as jbg
from soar_tpu.train import losses as jL
from soar_tpu.train import trainer as jtr
from soar_tpu.train.config import LossWeights as JLossWeights
from soar_tpu.train.config import StageConfig as JStageConfig
from soar_tpu.train.config import TrainConfig as JTrainConfig
from soar_tpu_torch.avatar import optim as topt
from soar_tpu_torch.cli import render_rot as trot
from soar_tpu_torch.cli import train as tcli
from soar_tpu_torch.core import camera as tcam
from soar_tpu_torch.data import cameras as tcams
from soar_tpu_torch.data.dataset import AvatarDataset
from soar_tpu_torch.field.attribute_field import reset_field
from soar_tpu_torch.guidance import build as tbuild
from soar_tpu_torch.io.from_jax import background_from_numpy
from soar_tpu_torch.render.types import RasterConfig
from soar_tpu_torch.train import background as tbg
from soar_tpu_torch.train import config as tconfig
from soar_tpu_torch.train import losses as tL
from soar_tpu_torch.train import trainer as ttr
from torch_port_helpers import assert_close, n, port_copy, small_avatar, t


# ---------------------------------------------------------------- pieces


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    a = rng.rand(2, 24, 20, 3).astype(np.float32)
    b = rng.rand(2, 24, 20, 3).astype(np.float32)
    mask = rng.rand(2, 24, 20) > 0.4
    for name in ("l1", "l2", "tv_loss_a", "psnr", "ssim"):
        if name == "tv_loss_a":
            got, want = tL.tv_loss(t(a)), jL.tv_loss(jnp.asarray(a))
        else:
            got = getattr(tL, name)(t(a), t(b))
            want = getattr(jL, name)(jnp.asarray(a), jnp.asarray(b))
        assert_close(got, want, 0, 1e-4, msg=name)
    assert_close(tL.masked_l1(t(a), t(b), t(mask)),
                 jL.masked_l1(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)), 0, 1e-5)
    for thrsh, m in ((0.0, mask), (np.pi / 10000.0, None)):
        got = tL.cos_loss(t(a), t(b), None if m is None else t(m), thrsh=thrsh)
        want = jL.cos_loss(jnp.asarray(a), jnp.asarray(b),
                           None if m is None else jnp.asarray(m), thrsh=thrsh)
        assert_close(got, want, 0, 1e-5)
    # ssim of an image with itself is 1; single image, 1 channel.
    assert_close(tL.ssim(t(a[0]), t(a[0])), 1.0, 1e-6)
    assert_close(tL.ssim(t(a[0, ..., :1]), t(b[0, ..., :1])),
                 jL.ssim(jnp.asarray(a[0, ..., :1]), jnp.asarray(b[0, ..., :1])), 0, 1e-4)
    for v in ((100, 0.75, 0.25, 2100), 0.3):
        for step in (0, 600, 5000):
            assert tconfig.scheduled(v, step) == pytest.approx(
                float(jtr.scheduled(v, step)), rel=1e-6)


def test_background_matches_jax():
    jp = jbg.init_background(jax.random.PRNGKey(3))
    tp = background_from_numpy(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    rng = np.random.RandomState(1)
    d = rng.randn(2, 8, 6, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jbg.background_color(jp, jnp.asarray(d))
    got = tbg.background_color(tp, t(d))
    assert_close(got, want, 1e-6)
    for seed in range(6):  # both branches of both coins
        key = jax.random.PRNGKey(seed)
        k1, k2, k3 = jax.random.split(key, 3)
        aug = {"use_aug": t(np.asarray(jax.random.uniform(k1) < 0.5)),
               "solid": t(np.asarray(jax.random.normal(k3, (1, 1, 1, 3))
                                     * (jax.random.uniform(k2) < 0.5)).reshape(3))}
        assert_close(tbg.apply_random_aug(got, aug),
                     jbg.apply_random_aug(want, key, 0.5), 1e-6)
    # The port's own draws have the distribution's shape.
    gen = torch.Generator().manual_seed(0)
    draws = [tbg.sample_random_aug(gen) for _ in range(400)]
    share = np.mean([bool(d["use_aug"]) for d in draws])
    assert 0.4 < share < 0.6
    init = tbg.init_background(torch.Generator().manual_seed(0))
    assert [tuple(layer["w"].shape) for layer in init["layers"]] == [(9, 16), (16, 16), (16, 3)]
    assert float(init["layers"][0]["w"].abs().max()) <= 1 / 3.0


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-5, lr_delay_mult=0.01, max_steps=1000),
    dict(lr_init=1e-3, lr_final=1e-4, lr_delay_steps=50, lr_delay_mult=0.1, max_steps=300),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr_schedule_matches_jax(kw):
    js, ts = jexpon(**kw), topt.expon_lr_schedule(**kw)
    for step in (0, 1, 10, 49, 50, 51, 500, 999, 1000, 5000):
        assert ts(step) == pytest.approx(float(js(step)), rel=1e-6, abs=1e-12)


def test_camera_sampler_matches_jax_given_its_uniforms():
    for cfg_j, cfg_t in ((jcams.CameraSampleConfig(n_view=4), tcams.CameraSampleConfig(n_view=4)),
                         (jcams.CameraSampleConfig(n_view=3, zoom_range=(0.8, 1.2),
                                                   relative_radius=False),
                          tcams.CameraSampleConfig(n_view=3, zoom_range=(0.8, 1.2),
                                                   relative_radius=False)),
                         (jcams.CameraSampleConfig(n_view=2, elevation_range=(-10.0, 20.0),
                                                   camera_distance_range=(0.28, 0.28),
                                                   fovy_range=(30.0, 45.0)),
                          tcams.head_camera_config(2))):
        for seed in range(4):
            key = jax.random.PRNGKey(seed)
            want_c2w, want_fovy = jcams.sample_multiview_cameras(key, cfg_j)
            u = np.array([float(jax.random.uniform(k)) for k in jax.random.split(key, 6)],
                         np.float32)
            got_c2w, got_fovy = tcams.multiview_cameras_from_uniforms(t(u), cfg_t)
            assert_close(got_c2w, want_c2w, 2e-5)
            assert_close(got_fovy, want_fovy, 1e-6)
    gen = torch.Generator().manual_seed(0)
    c2w, fovy = tcams.sample_multiview_cameras(gen, tcams.CameraSampleConfig())
    assert tuple(c2w.shape) == (4, 4, 4) and tuple(fovy.shape) == (4,)
    # Ray generation and look-at.
    pos = np.array([[0.3, 2.0, 0.5], [1.0, -1.0, 0.2]], np.float32)
    up = np.array([[0.0, 0.0, 1.0]] * 2, np.float32)
    want = jcam.look_at_c2w(jnp.asarray(pos), jnp.zeros((2, 3)), jnp.asarray(up))
    got = tcam.look_at_c2w(t(pos), torch.zeros(2, 3), t(up))
    assert_close(got, want, 1e-6)
    jd = jcam.get_ray_directions(6, 8, (jnp.asarray(7.0), jnp.asarray(9.0)))
    td = tcam.get_ray_directions(6, 8, (7.0, 9.0))
    assert_close(td, jd, 1e-6)
    for g, w in zip(tcam.get_rays(td, got), jcam.get_rays(jd, want)):
        assert_close(g, w, 1e-6)


# ----------------------------------------------------- optimizer / field


def port_leaves(tp):
    """The port's trained tensors by the JAX package's leaf names, in its
    layout (``nn.Linear`` weights transposed)."""
    out = {k: getattr(tp, k) for k in
           ("xyz", "rotation", "scaling", "opacity", "colors", "occ", "latent_pose")}
    f = tp.field
    out["field/encoding"] = f.encoding
    out["field/quat_encoding"] = f.quat_encoding
    for head in ("mlp_shs", "mlp_scales", "mlp_quats", "mlp_offsets", "mlp_opacities"):
        for i, lin in enumerate(getattr(f, head)):
            out[f"field/{head}/{i}/w"] = lin.weight.T
            out[f"field/{head}/{i}/b"] = lin.bias
    return out


def jax_leaves(jp):
    """The same names over an AvatarParams-shaped JAX pytree."""
    out = {k: getattr(jp, k) for k in
           ("xyz", "rotation", "scaling", "opacity", "colors", "occ", "latent_pose")}
    f = jp.field
    out["field/encoding"] = f["encoding"]
    out["field/quat_encoding"] = f["quat_encoding"]
    for head in ("mlp_shs", "mlp_scales", "mlp_quats", "mlp_offsets", "mlp_opacities"):
        for i, layer in enumerate(f[head]):
            out[f"field/{head}/{i}/w"] = layer["w"]
            out[f"field/{head}/{i}/b"] = layer["b"]
    return out


@pytest.fixture(scope="module")
def avatar():
    return small_avatar()


def test_optimizer_matches_optax(avatar):
    jparams, jmodel, _, _ = avatar
    tparams, _ = port_copy(jparams, jmodel)  # a fresh port copy to update
    ocfg_j = jtr.TrainConfig().optim
    ocfg_t = tconfig.TrainConfig().optim
    jopt = jmake_opt(jparams, ocfg_j)
    jstate = jopt.init(jparams)
    topt_ = topt.make_optimizer(tparams, ocfg_t)
    tl = port_leaves(tparams)
    rng = np.random.RandomState(4)
    jp = jparams
    for it in range(3):
        grads = {k: (rng.randn(*v.shape) * 10.0 ** rng.randint(-6, 1)).astype(np.float32)
                 for k, v in tl.items()}
        # The frozen aabb gets no gradient; a NaN there must not matter.
        jg = jax.tree_util.tree_map(jnp.zeros_like, jp)
        jg = jg._replace(**{k: jnp.asarray(grads[k]) for k in
                            ("xyz", "rotation", "scaling", "opacity", "colors", "occ",
                             "latent_pose")})
        field = dict(jg.field)
        field["aabb"] = jnp.full_like(field["aabb"], jnp.nan)
        field["encoding"] = jnp.asarray(grads["field/encoding"])
        field["quat_encoding"] = jnp.asarray(grads["field/quat_encoding"])
        for head in ("mlp_shs", "mlp_scales", "mlp_quats", "mlp_offsets", "mlp_opacities"):
            field[head] = [{"w": jnp.asarray(grads[f"field/{head}/{i}/w"]),
                            "b": jnp.asarray(grads[f"field/{head}/{i}/b"])}
                           for i in range(len(field[head]))]
        jg = jg._replace(field=field)
        updates, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)

        topt_.zero_grad()
        for k, v in tl.items():
            if v.is_leaf:
                v.grad = t(grads[k])
            else:  # a transposed nn.Linear weight
                v._base.grad = t(grads[k]).T.contiguous()
        topt_.step()
    jl = jax_leaves(jp)
    for k, v in port_leaves(tparams).items():
        # Held per leaf to 3e-5 of its largest move plus the rounding of
        # the parameter itself.
        move = np.abs(np.asarray(jl[k]) - np.asarray(jax_leaves(jparams)[k])).max()
        atol = 3e-5 * move + 2e-7 * np.abs(np.asarray(jl[k])).max()
        assert_close(v, jl[k], atol, msg=k)
    assert_close(tparams.field.aabb, jp.field["aabb"], 0)
    # The moments.
    st = topt_.adam.state
    for name, jm in (("exp_avg", jax_leaves(jstate.mu)), ("exp_avg_sq", jax_leaves(jstate.nu))):
        for k, v in port_leaves(tparams).items():
            m = st[v if v.is_leaf else v._base][name]
            assert_close(m if v.is_leaf else m.T, jm[k], 1e-12, 1e-5, msg=f"{name} {k}")
    assert topt_.count == 3


def test_reset_field_matches_jax(avatar):
    jparams, jmodel, _, _ = avatar
    tparams, _ = port_copy(jparams, jmodel)
    rng = np.random.RandomState(5)
    pts = np.asarray(jparams.xyz)
    Np = pts.shape[0]
    shs = rng.uniform(0, 1, (Np, 3)).astype(np.float32)
    scales = rng.uniform(0.005, 0.02, (Np, 1)).astype(np.float32)
    q = rng.randn(Np, 4).astype(np.float32)
    quats = q / np.linalg.norm(q, axis=-1, keepdims=True)
    jfield, jlosses = jreset_field(jparams.field, jnp.asarray(pts), jnp.asarray(shs),
                                   jnp.asarray(scales), jnp.asarray(quats),
                                   cfg=jmodel.field_cfg, steps=5)
    tfield, tlosses = reset_field(tparams.field, t(pts), t(shs), t(scales), t(quats), steps=5)
    assert_close(tlosses, jlosses, 0, 1e-4)
    assert float(tlosses[-1]) < float(tlosses[0])
    got = port_leaves(tparams)
    want = jax_leaves(jparams._replace(field=jfield))
    for k in want:
        if not k.startswith("field/"):
            continue
        # Adam's first steps move each entry by ~lr whatever |g|; entries
        # whose gradient is rounding noise may move the other way.
        diff = np.abs(n(got[k]) - np.asarray(want[k]))
        assert np.mean(diff > 1e-5) <= 0.01, (k, float(diff.max()))
    # Heads outside the loss stay as they were.
    for k in ("field/mlp_offsets/0/w", "field/mlp_opacities/1/b"):
        assert_close(got[k], jax_leaves(jparams)[k], 0, msg=k)
    # Minibatches draw from a generator and still descend.
    tp2, _ = port_copy(jparams, jmodel)
    _, losses = reset_field(tp2.field, t(pts), t(shs), t(scales), t(quats), steps=8,
                            batch_size=64, generator=torch.Generator().manual_seed(1))
    assert losses.shape == (8,) and bool(torch.isfinite(losses).all())


# ------------------------------------------------------------ train step


def _datasets(jmodel, F=4, H=48, seed=7):
    rng = np.random.RandomState(seed)
    focal = 1.2 * H
    K = np.array([[focal, 0, H / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    arrays = dict(
        images=rng.rand(F, H, H, 3).astype(np.float32),
        masks=(rng.rand(F, H, H) > 0.5).astype(np.float32),
        normal_F=rng.rand(F, H, H, 3).astype(np.float32),
        normal_B=rng.rand(F, H, H, 3).astype(np.float32),
        normal_mask=(rng.rand(F, H, H) > 0.5).astype(np.float32),
        images_crop=rng.rand(F, 32, 32, 3).astype(np.float32),
        masks_crop=(rng.rand(F, 32, 32) > 0.5).astype(np.float32),
        smpl_params={k: np.asarray(v) for k, v in jmodel.smpl_params.items()},
        w2c=np.eye(4, dtype=np.float32),
        Ks=np.tile(K[None], (F, 1, 1)),
        normal_Ks=np.tile(K[None], (F, 1, 1)),
        train_idx=list(range(F)), val_idx=[], test_idx=[],
    )
    return JDataset(**arrays), AvatarDataset(**arrays)


def _jax_draws(key, cfg, nv):
    """What soar_tpu's gen pass draws from ``key`` (``trainer.py:216-311``)."""
    k_cam, k_head, k_hflag, k_bgaug, k_rand, _ = jax.random.split(key, 6)
    c2w, fovy = jcams.sample_multiview_cameras(k_cam, jtr.gen_camera_config(cfg, nv))
    head = jnp.asarray(False)
    if cfg.head_prob > 0.0:
        hc, hf = jcams.sample_head_cameras(k_head, nv)
        head = jax.random.uniform(k_hflag) < cfg.head_prob
        c2w, fovy = jnp.where(head, hc, c2w), jnp.where(head, hf, fovy)
    k1, k2, k3 = jax.random.split(k_bgaug, 3)
    solid = jax.random.normal(k3, (1, 1, 1, 3)) * (jax.random.uniform(k2) < 0.5)
    return {
        "c2w": t(c2w), "fovy": t(fovy), "head": t(np.asarray(head)),
        "rand_bg": t(jax.random.uniform(k_rand, (3,))),
        "bg_aug": {"use_aug": t(np.asarray(jax.random.uniform(k1) < cfg.invert_bg_prob)),
                   "solid": t(np.asarray(solid).reshape(3))},
    }


def _grab_grads():
    """An optax transformation whose state after one update is the grads."""
    return optax.GradientTransformation(
        lambda p: p, lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


def _rel_l2(got, want):
    got, want = n(got).astype(np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("use_explicit", [True, False])
def test_train_step_matches_jax(avatar, use_explicit):
    jparams, jmodel, _, _ = avatar
    tparams, tmodel = port_copy(jparams, jmodel)
    jds, tds = _datasets(jmodel)
    nv, gen_size, size = 2, (32, 32), (48, 48)
    # Head cameras drawn with certainty: the head path runs too.
    jcfg, tcfg = JTrainConfig(n_views=nv, head_prob=1.0), tconfig.TrainConfig(n_views=nv,
                                                                              head_prob=1.0)
    stage_j = JStageConfig(loss=JLossWeights(curv=0.05), sds_start=0)
    stage_t = tconfig.StageConfig(loss=tconfig.LossWeights(curv=0.05), sds_start=0)
    jraster = JRasterConfig(composite="xla", composite_dtype="f32", max_per_tile=48, dup_side=3)
    traster = RasterConfig(max_per_tile=48, dup_side=3)  # the kernel's CPU stand-in

    # ---- JAX: grads (captured by the optimizer stand-in) and metrics
    key = jax.random.PRNGKey(11)
    bg = jbg.init_background(jax.random.PRNGKey(7))
    grab = _grab_grads()
    jstep = jax.jit(jtr.make_train_step(
        jmodel, jcfg, stage_j, grab, gen_size=gen_size, gt_size=size, normal_size=size,
        raster=jraster, use_explicit=use_explicit))
    jbatch = jtr.make_gt_batch(jds, jmodel, 2)
    jstate = jtr.TrainState(params=jparams, bg_params=bg, opt_state=grab.init(jparams),
                            step=jnp.asarray(3, jnp.int32))
    jnew, jmetrics = jstep(jstate, jbatch, key)
    jgrads = jax_leaves(jnew.opt_state)
    jopt = jmake_opt(jparams, jcfg.optim)
    upd, _ = jopt.update(jnew.opt_state, jopt.init(jparams), jparams)
    jupdated = jax_leaves(optax.apply_updates(jparams, upd))

    # ---- port: the same state, batch and draws
    state, opt = ttr.init_train_state(tparams, tcfg, stage=stage_t)
    state.bg_params = background_from_numpy(jax.tree_util.tree_map(np.asarray, bg), "cpu")
    state.step = 3
    step = ttr.make_train_step(tmodel, tcfg, stage_t, opt, gen_size=gen_size, gt_size=size,
                               normal_size=size, raster=traster, use_explicit=use_explicit)
    tbatch = ttr.make_gt_batch(tds, tmodel, 2, device="cpu")
    for k in ("gt_cam", "normal_cam"):
        for g, w in zip(tbatch[k], jbatch[k]):
            assert_close(g, w, 1e-6, 1e-6, msg=k)
    draws = _jax_draws(key, jcfg, nv)
    assert bool(draws["head"])
    loss, metrics, aux = step.loss_fn(tparams, state.bg_params, tbatch, draws, state.step)
    opt.zero_grad()
    loss.backward()
    tgrads = {}
    for k, v in port_leaves(tparams).items():
        g = v.grad if v.is_leaf else v._base.grad
        tgrads[k] = g if (g is None or v.is_leaf) else g.T
    assert set(metrics) == set(jmetrics), (sorted(metrics), sorted(jmetrics))
    for k in jmetrics:
        assert_close(metrics[k], jmetrics[k], 1e-7, 1e-4, msg=k)
    assert float(metrics["loss_normal_B"].detach()) > 0
    for k, jg in jgrads.items():
        jg = np.asarray(jg)
        tg = tgrads[k]
        if not np.any(jg):
            assert tg is None or not bool(tg.any()), k
            continue
        tol = 1e-2 if k.endswith("encoding") else 1e-3
        assert _rel_l2(tg, jg) <= tol, (k, _rel_l2(tg, jg))

    # ---- the update: where |g| is well above the noise and the signs agree
    opt.step()
    got = port_leaves(tparams)
    for k, jg in jgrads.items():
        jg = np.asarray(jg)
        if not np.any(jg):
            continue
        tg = n(tgrads[k])
        sel = (np.abs(jg) > 1e-3 * np.abs(jg).max()) & (np.sign(tg) == np.sign(jg))
        assert sel.any(), k
        diff = np.abs(n(got[k]) - np.asarray(jupdated[k]))[sel]
        assert diff.size == 0 or float(diff.max()) <= 1e-6 + 1e-5 * float(
            np.abs(np.asarray(jupdated[k])).max()), (k, float(diff.max()))
    assert opt.count == 1


def test_gt_batch_stack_matches_per_frame(avatar):
    _, jmodel, _, tmodel = avatar
    _, tds = _datasets(jmodel, F=3)
    for store_u8 in (False, True):
        stacked, select, pos_of = ttr.make_gt_batch_stack(tds, tmodel, [2, 0], store_u8=store_u8,
                                                          device="cpu")
        b = select(stacked, pos_of[0])
        ref = ttr.make_gt_batch(tds, tmodel, 0, device="cpu")
        assert b["frame_idx"] == 0
        for k, v in ref.items():
            if k == "frame_idx":
                continue
            for g, w in zip(b[k] if isinstance(v, tuple) else (b[k],),
                            v if isinstance(v, tuple) else (v,)):
                assert_close(g, w, 1 / 510 if store_u8 else 0, msg=k)
    assert ttr.gt_stack_nbytes(tds, tmodel, 3, store_u8=True) < ttr.gt_stack_nbytes(tds, tmodel, 3)


# ------------------------------------------------------------------- CLI


def test_cli_train_and_render_rot_round_trip(tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "run")
    # The flags that shape a capture's run are accepted beside --synthetic
    # and ignored there, as in the JAX CLI: this would not load a body "x"
    # nor subdivide three times.
    tcli.main(["--synthetic", "--stage", "both", "--steps", "2", "--device", "cpu",
               "--out", out, "--log-every", "1", "--eval", "--gen-res", "256",
               "--num-subdiv", "3", "--smpl-model", "x"])
    assert "saved" in capsys.readouterr().out
    for st in (0, 1):
        assert os.path.exists(os.path.join(out, f"stage{st}", "avatar.pt"))
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert [(r["step"], r["stage"]) for r in rows] == [(0, 0), (1, 0), (2, 1), (3, 1)]
    assert all(np.isfinite(r["loss"]) for r in rows)
    for f in ("psnrs.txt", "ssims.txt", "average.txt"):
        assert os.path.exists(os.path.join(out, "test", f))
    assert "nan" in open(os.path.join(out, "test", "average.txt")).read()
    rot = str(tmp_path / "rot")
    trot.main(["--synthetic", "--ckpt", os.path.join(out, "stage1"), "--num-views", "2",
               "--device", "cpu", "--out", rot])
    pngs = sorted(f for f in os.listdir(rot) if f.endswith(".png"))
    assert len(pngs) == 8
    # --resume into the same stage continues from its step.
    tcli.main(["--synthetic", "--stage", "1", "--steps", "3", "--device", "cpu", "--out", out,
               "--resume", os.path.join(out, "stage1"), "--log-every", "1"])
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    assert rows[-1]["step"] == 2 and len(rows) == 5
    # Guidance without its weights (checkpoint or mock, and embeddings) is
    # refused.
    for bad in (["--guidance", "imagedream"], ["--guidance", "mvdream"],
                ["--guidance", "mvdream", "--guidance-ckpt", "x"],
                []):
        with pytest.raises(SystemExit):
            tcli.main((["--synthetic"] if bad else []) + bad + ["--device", "cpu",
                                                                "--out", out])
    # A capture needs its body model, as in the JAX CLI; a missing capture
    # directory stops in the loader.
    with pytest.raises(SystemExit, match="--dataroot and --smpl-model required"):
        tcli.main(["--dataroot", "x", "--device", "cpu", "--out", out])
    with pytest.raises(FileNotFoundError, match="no images under"):
        tcli.main(["--dataroot", str(tmp_path / "absent"), "--smpl-model", "test:4,3,8",
                   "--device", "cpu", "--out", out])
    # SDS guidance with random networks, at the tiny shapes here: each
    # stage's step 0 is its warm-up (sds_start 0), step 1 is guided.
    monkeypatch.setattr(tbuild.NetworkShapes, "full", classmethod(lambda cls: cls.tiny(32)))
    gout = str(tmp_path / "guided")
    tcli.main(["--synthetic", "--stage", "both", "--steps", "2", "--sds-start", "0",
               "--guidance", "mvdream", "--mock-guidance", "--guidance-image-size", "32",
               "--device", "cpu", "--out", gout, "--log-every", "1", "--dump-every", "0"])
    rows = [json.loads(line) for line in open(os.path.join(gout, "metrics.jsonl"))]
    assert [("loss_sds" in r, r["stage"]) for r in rows] == [(False, 0), (True, 0), (False, 1),
                                                             (True, 1)]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert all(np.isfinite(r["loss_sds"]) and r["sds_grad_norm"] > 0 for r in rows[1::2])
    assert os.path.exists(os.path.join(gout, "stage1", "avatar.pt"))

    # ImageDream from a checkpoint with prompt embeddings, split SDS, the
    # LPIPS terms (normals-free synthetic data: the VGG RGB term) and the
    # LPIPS eval, at the tiny shapes; stage 1, step 1 guided.
    import pickle

    from soar_tpu_torch.guidance.clip_vit import CLIPViT
    from soar_tpu_torch.train.lpips import mock_lpips_variables

    g = tbuild.build_guidance("imagedream", tconfig.StageConfig(), tiny=True, image_size=32,
                              device="cpu")
    clip = g.image_encoder["clip"]
    sd = {"model.diffusion_model." + k: v for k, v in g.unet.state_dict().items()}
    sd.update({"first_stage_model." + k: v for k, v in g.vae.state_dict().items()})
    sd.update({"embedder.model.visual." + k: v for k, v in dict(
        CLIPViT(clip.cfg, features="pooled").state_dict(), **clip.state_dict()).items()})
    sd.update({"image_proj_model." + k: v
               for k, v in g.image_encoder["resampler"].state_dict().items()})
    ckpt = str(tmp_path / "ipmv.ckpt")
    torch.save({"state_dict": sd}, ckpt)
    emb = str(tmp_path / "emb.npz")
    rng = np.random.RandomState(0)
    np.savez(emb, cond=rng.randn(77, 16), uncond=rng.randn(77, 16))
    lp = str(tmp_path / "lpips_vgg16.pkl")
    with open(lp, "wb") as f:
        pickle.dump(mock_lpips_variables(0), f)
    iout = str(tmp_path / "imagedream")
    capsys.readouterr()
    tcli.main(["--synthetic", "--stage", "1", "--steps", "2", "--sds-start", "0",
               "--guidance", "imagedream", "--guidance-ckpt", ckpt, "--prompt-embeddings", emb,
               "--lpips-weights", lp, "--lambda-vgg", "0.1", "--sds-mode", "split", "--eval",
               "--guidance-image-size", "32", "--device", "cpu", "--out", iout,
               "--log-every", "1", "--dump-every", "0", "--val-every", "0"])
    assert "precomputed ip tokens for 8 frames (stage 1" in capsys.readouterr().out
    rows = [json.loads(line) for line in open(os.path.join(iout, "metrics.jsonl"))]
    assert [("loss_sds" in r, "loss_vgg" in r) for r in rows] == [(False, True), (True, True)]
    assert all(np.isfinite(r[k]) for r in rows for k in r if k != "stage")
    avg = open(os.path.join(iout, "test", "average.txt")).read().split()
    assert os.path.exists(os.path.join(iout, "test", "lpips.txt")) and np.isfinite(float(avg[2]))
