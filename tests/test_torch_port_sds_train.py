"""The guided training step against soar_tpu on the CPU: one step of each
stage with MVDream and ImageDream guidance (the tiny networks, their flax
variables carried across, the JAX draws injected), the occ hook on the SDS
gradient, and the warm-up steps that never call the guidance.

Tolerances are those of ``test_torch_port_train.py``'s step test: losses
1e-4 relative; gradients 1e-3 relative L2 per leaf, 1e-2 for the hash
tables (scatter-added in bf16 in another order).  The tiny networks here
have flax's zero biases and unit norm scales and random kernels
(``random_flax_variables(affine=False)``; the network tests of
``test_torch_port_guidance.py`` draw biases and scales): with random biases,
the near-uniform renders of the untrained avatar leave the VAE's first
GroupNorm (one channel a group) a near-constant input whose float32
rounding it amplifies ~1,500x, in both packages alike (each ~3e-4 off a
float64 evaluation of the same inputs), which these bounds cannot hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.guidance import build as jbuild
from soar_tpu.render.types import RasterConfig as JRasterConfig
from soar_tpu.train import background as jbg
from soar_tpu.train import trainer as jtr
from soar_tpu.train.config import LossWeights as JLossWeights
from soar_tpu.train.config import StageConfig as JStageConfig
from soar_tpu.train.config import TrainConfig as JTrainConfig
from soar_tpu_torch.guidance import build as tbuild
from soar_tpu_torch.io.from_jax import background_from_numpy, unet_from_flax, vae_from_flax
from soar_tpu_torch.parallel import ViewMesh, view_sharder
from soar_tpu_torch.render.types import RasterConfig
from soar_tpu_torch.train import config as tconfig
from soar_tpu_torch.train import trainer as ttr
from test_torch_port_train import (_datasets, _grab_grads, _jax_draws, _rel_l2, jax_leaves,
                                   port_leaves)
from torch_port_helpers import assert_close, port_copy, small_avatar, t, tiny_guidance_variables

NV, GEN, SIZE, IMAGE = 2, (32, 32), (48, 48), 32
LATENT = IMAGE // 2  # the tiny VAE downsamples once


@pytest.fixture(scope="module")
def avatar():
    return small_avatar()


def _sds_draws(key):
    """The SDS draws of soar_tpu's step from its key: k_sds, the gen pass's
    sixth split, then MultiviewGuidance's three (``sds.py:98-145``)."""
    k_sds = jax.random.split(key, 6)[5]
    k_t, k_noise, k_enc = jax.random.split(k_sds, 3)
    shape = (NV, LATENT, LATENT, 4)
    return {"u": t(jax.random.uniform(k_t)), "noise": t(jax.random.normal(k_noise, shape)),
            "vae_eps": t(jax.random.normal(k_enc, shape))}


def _jax_guidance(monkeypatch, kind, stage, variables, text):
    """soar_tpu's build_guidance at the tiny shapes, its networks' variables
    replaced by ``variables`` (flax's own init and the CLIP tower are not
    needed: the batch carries the ip tokens)."""
    monkeypatch.setattr(jbuild, "init_mock_networks", lambda *a, **k: {
        "unet": jax.tree_util.tree_map(jnp.asarray, variables["unet"]),
        "vae": jax.tree_util.tree_map(jnp.asarray, variables["vae"])})
    monkeypatch.setattr(jbuild, "_mock_clip_vars", lambda *a, **k: ({}, {}))
    return jbuild.build_guidance(kind, stage, tiny=True, image_size=IMAGE, n_view=NV,
                                 text_embeddings=text)


@pytest.mark.parametrize("kind,training_stage,use_explicit", [
    ("mvdream", 0, True),
    ("mvdream", 1, False),
    ("imagedream", 0, False),
    ("imagedream", 1, True),
])
def test_guided_train_step_matches_jax(avatar, monkeypatch, kind, training_stage, use_explicit):
    jparams, jmodel, _, _ = avatar
    tparams, tmodel = port_copy(jparams, jmodel)
    jds, tds = _datasets(jmodel)
    rng = np.random.RandomState(training_stage + 2 * (kind == "imagedream"))
    variables = tiny_guidance_variables(NV, with_ip=kind == "imagedream", image_size=IMAGE,
                                        seed=11 + training_stage, affine=False)
    text = rng.randn(2, 77, 16).astype(np.float32)
    ref_ip = rng.randn(4, 16).astype(np.float32)
    # The SDS term weighs as much as the reconstruction, so its gradient is
    # a large share of every leaf's.
    jstage = JStageConfig(training_stage=training_stage, sds_start=0,
                          loss=JLossWeights(curv=0.05, sds=1.0))
    tstage = tconfig.StageConfig(training_stage=training_stage, sds_start=0,
                                 loss=tconfig.LossWeights(curv=0.05, sds=1.0))
    jcfg, tcfg = JTrainConfig(n_views=NV), tconfig.TrainConfig(n_views=NV)
    jraster = JRasterConfig(composite="xla", composite_dtype="f32", max_per_tile=48, dup_side=3)
    traster = RasterConfig(max_per_tile=48, dup_side=3)

    # ---- JAX
    key = jax.random.PRNGKey(21 + training_stage)
    bg = jbg.init_background(jax.random.PRNGKey(7))
    grab = _grab_grads()
    jguid = _jax_guidance(monkeypatch, kind, jstage, variables, text)
    jstep = jax.jit(jtr.make_train_step(
        jmodel, jcfg, jstage, grab, gen_size=GEN, gt_size=SIZE, normal_size=SIZE,
        raster=jraster, use_explicit=use_explicit, guidance_fn=jguid))
    jbatch = jtr.make_gt_batch(jds, jmodel, 1)
    jbatch["ref_ip"] = jnp.asarray(ref_ip)
    jstate = jtr.TrainState(params=jparams, bg_params=bg, opt_state=grab.init(jparams),
                            step=jnp.asarray(5, jnp.int32))
    jnew, jmetrics = jstep(jstate, jbatch, key)
    jgrads = jax_leaves(jnew.opt_state)

    # ---- port: the same weights, state, batch and draws
    g = tbuild.build_guidance(kind, tstage, tiny=True, image_size=IMAGE, n_view=NV,
                              device="cpu", text_embeddings=text)
    g.unet.load_state_dict(unet_from_flax(variables["unet"], g.shapes.unet), strict=True)
    g.vae.load_state_dict(vae_from_flax(variables["vae"]), strict=True)
    state, opt = ttr.init_train_state(tparams, tcfg, stage=tstage)
    state.bg_params = background_from_numpy(jax.tree_util.tree_map(np.asarray, bg), "cpu")
    step = ttr.make_train_step(tmodel, tcfg, tstage, opt, gen_size=GEN, gt_size=SIZE,
                               normal_size=SIZE, raster=traster, use_explicit=use_explicit,
                               guidance_fn=g)
    tbatch = ttr.make_gt_batch(tds, tmodel, 1, device="cpu")
    tbatch["ref_ip"] = t(ref_ip)
    draws = _jax_draws(key, jcfg, NV)
    draws["sds"] = _sds_draws(key)
    loss, metrics, _ = step.loss_fn(tparams, state.bg_params, tbatch, draws, 5)
    opt.zero_grad()
    loss.backward()

    assert set(metrics) == set(jmetrics), (sorted(metrics), sorted(jmetrics))
    assert "loss_sds" in metrics and "sds_grad_norm" in metrics
    for k in jmetrics:
        assert_close(metrics[k], jmetrics[k], 1e-7, 1e-4, msg=k)
    assert all(p.grad is None for m in (g.unet, g.vae) for p in m.parameters())
    for k, jg in jgrads.items():
        jg = np.asarray(jg)
        v = port_leaves(tparams)[k]
        tg = v.grad if v.is_leaf else (None if v._base.grad is None else v._base.grad.T)
        if not np.any(jg):
            assert tg is None or not bool(tg.any()), k
            continue
        tol = 1e-2 if k.endswith("encoding") else 1e-3
        assert _rel_l2(tg, jg) <= tol, (k, _rel_l2(tg, jg))


def _sds_only_step(avatar, occ_val, guidance_fn, **loss):
    """One port step's colors gradient on the explicit avatar with every
    occ logit at ``occ_val``: only the SDS term (and the occ term, which
    turns the hook on and reaches params.occ only) has weight."""
    jparams, jmodel, _, _ = avatar
    tparams, tmodel = port_copy(jparams, jmodel)
    with torch.no_grad():
        tparams.occ.fill_(occ_val)
    _, tds = _datasets(jmodel)
    weights = dict(sds=1.0, recon=0.0, mask=0.0, normal_F=0.0, normal_B=0.0, normal_mask=0.0,
                   normal_consistency=0.0, curv=0.0, scales=0.0, delta=0.0, occ=1.0)
    weights.update(loss)
    stage = tconfig.StageConfig(training_stage=1, sds_start=0,
                                loss=tconfig.LossWeights(**weights))
    cfg = tconfig.TrainConfig(n_views=NV, head_prob=0.0)
    state, opt = ttr.init_train_state(tparams, cfg, stage=stage)
    step = ttr.make_train_step(tmodel, cfg, stage, opt, gen_size=GEN, gt_size=SIZE,
                               normal_size=SIZE, raster=RasterConfig(max_per_tile=48, dup_side=3),
                               use_explicit=True, has_normals=False, guidance_fn=guidance_fn)
    batch = ttr.make_gt_batch(tds, tmodel, 0, device="cpu")
    draws = ttr.sample_step_draws(torch.Generator().manual_seed(3), cfg, latent_size=LATENT)
    loss, metrics, _ = step.loss_fn(tparams, state.bg_params, batch, draws, 1)
    opt.zero_grad()
    loss.backward()
    return tparams.colors.grad, metrics


def test_occ_hook_modulates_sds_gradient(avatar):
    """exp(-3 occ) on the guidance input: with occ forced high the SDS pull
    on the colours shrinks against occ low (``tests/test_sds_train.py``'s
    check, on the port), and with lambda_occ = 0 the hook is off."""

    def pull_to_zero(inp, c2w, step, draws, **kw):
        return {"loss_sds": torch.sum(inp**2)}

    g_low, _ = _sds_only_step(avatar, -10.0, pull_to_zero)
    g_high, _ = _sds_only_step(avatar, 10.0, pull_to_zero)
    low, high = float(g_low.norm()), float(g_high.norm())
    assert low > 0 and high < 0.5 * low, (low, high)
    # lambda_occ = 0: no hook, so occ does not change the SDS pull.
    g_off_low, _ = _sds_only_step(avatar, -10.0, pull_to_zero, occ=0.0)
    g_off_high, _ = _sds_only_step(avatar, 10.0, pull_to_zero, occ=0.0)
    assert_close(g_off_high, g_off_low, 1e-6 * float(g_off_low.abs().max()))
    # scale_gradient keeps the value and scales the gradient.
    x = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    w = torch.tensor([0.5, 0.0, 1.0])
    y = ttr.scale_gradient(x, w)
    y.sum().backward()
    assert_close(y, x, 0)
    assert_close(x.grad, w, 0)


def test_warm_steps_never_call_the_guidance(avatar):
    """step <= sds_start: the guidance is not called and no SDS metric is
    reported; the step after it calls it once."""
    jparams, jmodel, _, _ = avatar
    tparams, tmodel = port_copy(jparams, jmodel)
    _, tds = _datasets(jmodel)
    calls = []

    def spy(inp, c2w, step, draws, ref_rgb=None, ref_mask=None, comp_bg=None, ref_ip=None):
        calls.append((step, tuple(inp.shape), tuple(c2w.shape), tuple(comp_bg.shape),
                      None if ref_rgb is None else tuple(ref_rgb.shape),
                      None if ref_ip is None else tuple(ref_ip.shape), sorted(draws)))
        return {"loss_sds": inp.mean(), "grad_norm": inp.detach().norm()}

    stage = tconfig.StageConfig(training_stage=0, sds_start=2)
    cfg = tconfig.TrainConfig(n_views=NV)
    state, opt = ttr.init_train_state(tparams, cfg, stage=stage)
    step = ttr.make_train_step(tmodel, cfg, stage, opt, gen_size=GEN, gt_size=SIZE,
                               normal_size=SIZE, raster=RasterConfig(max_per_tile=48, dup_side=3),
                               use_explicit=True, guidance_fn=spy)
    batch = ttr.make_gt_batch(tds, tmodel, 0, device="cpu")
    batch["ref_ip"] = torch.zeros(4, 16)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):  # steps 0, 1 and 2: warm-up (step <= sds_start)
        state, metrics = step(state, batch, ttr.sample_step_draws(gen, cfg, latent_size=LATENT))
        assert "loss_sds" not in metrics
    assert not calls
    state, metrics = step(state, batch, ttr.sample_step_draws(gen, cfg, latent_size=LATENT))
    assert calls == [(3, (NV,) + GEN + (3,), (NV, 4, 4), GEN + (3,), SIZE + (3,), (4, 16),
                      ["noise", "u", "vae_eps"])]
    assert np.isfinite(float(metrics["loss_sds"])) and "sds_grad_norm" in metrics
    draws = ttr.sample_step_draws(torch.Generator().manual_seed(0), cfg)
    assert "sds" not in draws  # the guidance-free draws are unchanged
    with pytest.raises(ValueError, match="latent_size"):
        step(state, batch, draws)
    # Split SDS and LPIPS are ported (test_torch_port_lpips.py), and so is
    # sharding (test_torch_port_parallel.py): a one-rank view sharder.
    split = ttr.make_train_step(tmodel, cfg, stage, opt, gen_size=GEN, gt_size=SIZE,
                                normal_size=SIZE, guidance_fn=spy, split_sds=True)
    assert split.sds_prelude is not None and step.sds_prelude is None
    ttr.make_train_step(tmodel, cfg, stage, opt, gen_size=GEN, gt_size=SIZE,
                        normal_size=SIZE, lpips_fn=lambda a, b: a.mean())
    sharded = ttr.make_train_step(
        tmodel, cfg, stage, opt, gen_size=GEN, gt_size=SIZE, normal_size=SIZE,
        shard_views=view_sharder(ViewMesh(None, 0, 1, torch.device("cpu"))))
    assert callable(sharded) and sharded.sds_prelude is None
