"""LPIPS, split SDS and prompt embeddings against soar_tpu on the CPU: the
LPIPS-VGG16 value and input gradient (float32 and bf16), the weight
converter and the ``--lpips-weights`` pickle loader, a guidance-free step
with the normal-LPIPS and VGG terms, ``evaluate``'s LPIPS files, one guided
step in split mode against the fused one and JAX's split step, and the
``.npz`` prompt embeddings.

Tolerances, each with its reason:
- LPIPS in float32: the value 1e-5 relative and the input gradient 1e-5 of
  its largest entry (thirteen convolutions summed in other orders).  The
  float32 tests run torch's CPU convolutions without oneDNN
  (``torch.backends.mkldnn.flags(enabled=False)``): with it, torch
  2.13.0+cpu's float32 convolution backward was seen far outside these
  bounds against a float64 evaluation of the same module for some random
  VGG16 draws, while without it ``test_lpips_float32_matches_jax`` holds
  the port's and JAX's float32 gradients to 1e-5 of the float64 one;
- LPIPS in bf16 against JAX's bf16: the value 5e-3 relative, the gradient
  cosine > 0.95 and its norm within 5%: the bounds ``tests/test_lpips.py``
  holds JAX's own bf16 path to against float32 (the two bf16 paths round
  the convolutions' outputs and biases at other points);
- the steps: those of ``test_torch_port_train.py`` (losses 1e-4 relative;
  gradients 1e-3 relative L2 per leaf, 1e-2 for the hash tables);
- split against fused SDS in the port: losses 1e-6 relative; gradients
  1e-4 relative L2 (the prelude's lite render and no-grad VAE call reach
  the target through other float32 roundings, and the gradient carries
  lat - target; measured 1.9e-5 on xyz); the split prelude's
  latents and target against JAX's: 1e-4 of their largest magnitude (the
  tiny networks' bound in ``test_torch_port_guidance.py``);
- eval LPIPS: 1e-4 relative (renders ~1e-6 apart through the VGG).
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.guidance import prompt as jprompt
from soar_tpu.render.types import RasterConfig as JRasterConfig
from soar_tpu.train import background as jbg
from soar_tpu.train import evaluate as jeval
from soar_tpu.train import lpips as jlpips
from soar_tpu.train import trainer as jtr
from soar_tpu.train.config import LossWeights as JLossWeights
from soar_tpu.train.config import StageConfig as JStageConfig
from soar_tpu.train.config import TrainConfig as JTrainConfig
from soar_tpu_torch.guidance import build as tbuild
from soar_tpu_torch.guidance import prompt as tprompt
from soar_tpu_torch.io.from_jax import background_from_numpy, unet_from_flax, vae_from_flax
from soar_tpu_torch.render.types import RasterConfig
from soar_tpu_torch.train import config as tconfig
from soar_tpu_torch.train import evaluate as teval
from soar_tpu_torch.train import lpips as tlpips
from soar_tpu_torch.train import trainer as ttr
from test_torch_port_sds_train import GEN, IMAGE, NV, SIZE, _jax_guidance, _sds_draws
from test_torch_port_train import (_datasets, _grab_grads, _jax_draws, _rel_l2, jax_leaves,
                                   port_leaves)
from torch_port_helpers import assert_close, n, port_copy, small_avatar, t, tiny_guidance_variables

JRASTER = JRasterConfig(composite="xla", composite_dtype="f32", max_per_tile=48, dup_side=3)
TRASTER = RasterConfig(max_per_tile=48, dup_side=3)


@pytest.fixture(scope="module")
def avatar():
    return small_avatar()


@pytest.fixture(scope="module")
def lpips_pickle(tmp_path_factory):
    """The ``--lpips-weights`` pickle (flax variables, numpy leaves), with
    random kernels and biases and lin weights of both signs."""
    v = tlpips.mock_lpips_variables(seed=3)
    rng = np.random.RandomState(4)
    for conv in v["params"]["vgg"].values():
        conv["bias"] = (0.05 * rng.randn(*conv["bias"].shape)).astype(np.float32)
    for i in range(5):
        lin = v["params"][f"lin_{i}"]
        v["params"][f"lin_{i}"] = (lin - 0.1).astype(np.float32)  # max(w, 0) bites
    path = str(tmp_path_factory.mktemp("lpips") / "lpips_vgg16.pkl")
    with open(path, "wb") as f:
        pickle.dump(v, f)
    return path, v


def _images(seed, hw=(64, 64)):
    rng = np.random.RandomState(seed)
    return [(rng.rand(*hw, 3).astype(np.float32) * 2 - 1) for _ in range(2)]


# ------------------------------------------------------------ the network


@pytest.fixture
def precise_cpu_conv():
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def test_lpips_float32_matches_jax(lpips_pickle, precise_cpu_conv):
    path, v = lpips_pickle
    a, b = _images(0)
    jfn = jlpips.make_lpips_fn(path, dtype=jnp.float32)
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(a), jnp.asarray(b))
    fn = tlpips.make_lpips_fn(path, dtype=torch.float32, device="cpu")
    at = t(a).requires_grad_(True)
    got = fn(at, t(b))
    got.backward()
    assert_close(got, want, 0, 1e-5)
    assert_close(at.grad, want_g, 1e-5 * float(np.abs(want_g).max()))
    assert float(want) > 0 and float(fn(t(a), t(a))) == 0.0
    # Both float32 gradients against float64 (the same module, widened).
    net64 = tlpips.lpips_module(path, device="cpu").double()
    net64.compute_dtype = torch.float64
    a64 = t(a).double().requires_grad_(True)
    net64(a64[None], t(b).double()[None])[0].backward()
    assert _rel_l2(at.grad, n(a64.grad)) <= 1e-5
    assert _rel_l2(want_g, n(a64.grad)) <= 1e-5
    # The eval path: [0, 1] inputs, float32, a Python float.
    ev = tlpips.load_lpips(path, device="cpu")
    assert ev((a + 1) / 2, (b + 1) / 2) == pytest.approx(float(want), rel=1e-5)
    assert tlpips.make_lpips_fn(path + ".missing") is None
    assert tlpips.load_lpips(None) is None


def test_lpips_bf16_matches_jax_bf16(lpips_pickle):
    path, _ = lpips_pickle
    a, b = _images(1)
    jfn = jlpips.make_lpips_fn(path)  # bf16, the loss path's default
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(a), jnp.asarray(b))
    fn = tlpips.make_lpips_fn(path, device="cpu")
    assert all(p.dtype == torch.bfloat16 for p in fn.net.vgg.parameters())
    at = t(a).requires_grad_(True)
    got = fn(at, t(b))
    got.backward()
    assert got.dtype == torch.float32 and at.grad.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 5e-3 * abs(float(want))
    g, w = n(at.grad).ravel().astype(np.float64), np.asarray(want_g, np.float64).ravel()
    cos = g @ w / (np.linalg.norm(g) * np.linalg.norm(w))
    assert cos > 0.95 and 0.95 < np.linalg.norm(g) / np.linalg.norm(w) < 1.05, cos


def test_convert_lpips_params_and_pickle_match_jax(lpips_pickle, precise_cpu_conv):
    """torchvision / lpips-package state_dicts through both converters; the
    JAX converter's pickle read by the port gives the port converter's
    weights, and the port's LPIPS on them is JAX's."""
    rng = np.random.RandomState(5)
    vgg_sd, cin = {}, 3
    for layer, c in zip(tlpips.VGG16_CONV_LAYERS, (64, 64, 128, 128, 256, 256, 256, 512, 512,
                                                  512, 512, 512, 512)):
        vgg_sd[f"features.{layer}.weight"] = (rng.randn(c, cin, 3, 3) / np.sqrt(9 * cin)).astype(
            np.float32)
        vgg_sd[f"features.{layer}.bias"] = (0.05 * rng.randn(c)).astype(np.float32)
        cin = c
    vgg_sd["classifier.0.weight"] = np.zeros((2, 2), np.float32)  # not read
    lpips_sd = {f"lin{i}.model.1.weight": rng.rand(1, c, 1, 1).astype(np.float32)
                for i, c in enumerate((64, 128, 256, 512, 512))}
    jvars = jlpips.convert_lpips_params(vgg_sd, lpips_sd)
    path = os.path.join(os.path.dirname(lpips_pickle[0]), "converted.pkl")
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jvars), f)
    net = tlpips.lpips_module(path, device="cpu")
    sd = tlpips.convert_lpips_params(vgg_sd, lpips_sd)
    assert set(sd) == set(net.state_dict())
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    a, b = _images(2, (48, 40))
    want = jlpips.LPIPS().apply(jvars, jnp.asarray(a)[None], jnp.asarray(b)[None])
    with torch.no_grad():
        assert_close(net(t(a)[None], t(b)[None]), want, 0, 1e-5)


# ------------------------------------------------------------ the steps


def test_lpips_step_matches_jax(avatar, lpips_pickle, precise_cpu_conv):
    """A guidance-free step with normals (front and back) and vgg = 0.1, the
    JAX draws injected, LPIPS in float32 in both."""
    path, _ = lpips_pickle
    jparams, jmodel, _, _ = avatar
    tparams, tmodel = port_copy(jparams, jmodel)
    jds, tds = _datasets(jmodel)
    jcfg, tcfg = JTrainConfig(n_views=NV), tconfig.TrainConfig(n_views=NV)
    jstage = JStageConfig(loss=JLossWeights(curv=0.05, vgg=0.1), sds_start=0)
    tstage = tconfig.StageConfig(loss=tconfig.LossWeights(curv=0.05, vgg=0.1), sds_start=0)
    key = jax.random.PRNGKey(13)
    bg = jbg.init_background(jax.random.PRNGKey(7))
    grab = _grab_grads()
    jstep = jax.jit(jtr.make_train_step(
        jmodel, jcfg, jstage, grab, gen_size=GEN, gt_size=SIZE, normal_size=SIZE, raster=JRASTER,
        use_explicit=True, lpips_fn=jlpips.make_lpips_fn(path, dtype=jnp.float32)))
    jbatch = jtr.make_gt_batch(jds, jmodel, 1)
    jstate = jtr.TrainState(params=jparams, bg_params=bg, opt_state=grab.init(jparams),
                            step=jnp.asarray(2, jnp.int32))
    jnew, jmetrics = jstep(jstate, jbatch, key)
    jgrads = jax_leaves(jnew.opt_state)

    state, opt = ttr.init_train_state(tparams, tcfg, stage=tstage)
    state.bg_params = background_from_numpy(jax.tree_util.tree_map(np.asarray, bg), "cpu")
    step = ttr.make_train_step(
        tmodel, tcfg, tstage, opt, gen_size=GEN, gt_size=SIZE, normal_size=SIZE, raster=TRASTER,
        use_explicit=True,
        lpips_fn=tlpips.make_lpips_fn(path, dtype=torch.float32, device="cpu"))
    tbatch = ttr.make_gt_batch(tds, tmodel, 1, device="cpu")
    loss, metrics, _ = step.loss_fn(tparams, state.bg_params, tbatch, _jax_draws(key, jcfg, NV), 2)
    opt.zero_grad()
    loss.backward()
    assert set(metrics) == set(jmetrics) and "loss_vgg" in metrics, sorted(metrics)
    for k in jmetrics:
        assert_close(metrics[k], jmetrics[k], 1e-7, 1e-4, msg=k)
    # The LPIPS terms are in: the normal terms exceed their cosine part.
    assert float(metrics["loss_vgg"]) > 0 and float(metrics["loss_normal_B"]) > 0.2
    for k, jg in jgrads.items():
        jg = np.asarray(jg)
        v = port_leaves(tparams)[k]
        tg = v.grad if v.is_leaf else (None if v._base.grad is None else v._base.grad.T)
        if not np.any(jg):
            assert tg is None or not bool(tg.any()), k
            continue
        tol = 1e-2 if k.endswith("encoding") else 1e-3
        assert _rel_l2(tg, jg) <= tol, (k, _rel_l2(tg, jg))


def test_evaluate_lpips_matches_jax(avatar, lpips_pickle, tmp_path):
    path, _ = lpips_pickle
    jparams, jmodel, tparams, tmodel = avatar
    jds, tds = _datasets(jmodel, F=5)
    for ds in (jds, tds):
        ds.train_idx, ds.test_idx = [0, 1, 2], [3, 4]
    jres = jeval.evaluate(jparams, jmodel, jds, save_dir=str(tmp_path / "jax"),
                          lpips_fn=jlpips.load_lpips(path))
    tres = teval.evaluate(tparams, tmodel, tds, save_dir=str(tmp_path / "port"),
                          lpips_fn=tlpips.load_lpips(path, device="cpu"), device="cpu")
    want = np.loadtxt(tmp_path / "jax" / "lpips.txt")
    got = np.loadtxt(tmp_path / "port" / "lpips.txt")
    assert got.shape == want.shape == (2,) and np.all(want > 0)
    assert_close(got, want, 0, 1e-4)
    avg = open(tmp_path / "port" / "average.txt").read().split()
    assert len(avg) == 3 and float(avg[2]) == pytest.approx(tres["lpips"]) == pytest.approx(
        jres["lpips"], rel=1e-4)
    # Without weights the LPIPS column is nan and no lpips.txt is written.
    teval.evaluate(tparams, tmodel, tds, save_dir=str(tmp_path / "none"), device="cpu")
    assert not os.path.exists(tmp_path / "none" / "lpips.txt")
    assert open(tmp_path / "none" / "average.txt").read().split()[2] == "nan"


def test_split_sds_matches_fused_and_jax(avatar, monkeypatch):
    """One guided stage-1 ImageDream step: the port's split SDS (prelude,
    compute_target, then the step) equals its fused step and JAX's split
    step (the tiny networks, the JAX draws injected)."""
    jparams, jmodel, _, _ = avatar
    jds, tds = _datasets(jmodel)
    rng = np.random.RandomState(9)
    variables = tiny_guidance_variables(NV, with_ip=True, image_size=IMAGE, seed=12, affine=False)
    text = rng.randn(2, 77, 16).astype(np.float32)
    ref_ip = rng.randn(4, 16).astype(np.float32)
    jstage = JStageConfig(training_stage=1, sds_start=0, loss=JLossWeights(curv=0.05, sds=1.0))
    tstage = tconfig.StageConfig(training_stage=1, sds_start=0,
                                 loss=tconfig.LossWeights(curv=0.05, sds=1.0))
    jcfg, tcfg = JTrainConfig(n_views=NV), tconfig.TrainConfig(n_views=NV)
    key, step_i = jax.random.PRNGKey(31), 4

    # ---- JAX split: the prelude and target programs, then the step
    bg = jbg.init_background(jax.random.PRNGKey(7))
    grab = _grab_grads()
    jguid = _jax_guidance(monkeypatch, "imagedream", jstage, variables, text)
    raw = jtr.make_train_step(jmodel, jcfg, jstage, grab, gen_size=GEN, gt_size=SIZE,
                              normal_size=SIZE, raster=JRASTER, use_explicit=True,
                              guidance_fn=jguid, split_sds=True)
    jbatch = jtr.make_gt_batch(jds, jmodel, 2)
    jbatch["ref_ip"] = jnp.asarray(ref_ip)
    jstate = jtr.TrainState(params=jparams, bg_params=bg, opt_state=grab.init(jparams),
                            step=jnp.asarray(step_i, jnp.int32))
    lat, c2w, k_sds = jax.jit(raw.sds_prelude)(jstate, jbatch, key)
    jbatch["sds_target"] = jguid.compute_target(lat, c2w, k_sds, jstate.step,
                                                ref_ip=jbatch["ref_ip"])
    jnew, jmetrics = jax.jit(raw)(jstate, jbatch, key)
    jgrads = jax_leaves(jnew.opt_state)

    # ---- the port, split and fused, on the same weights, state and draws
    g = tbuild.build_guidance("imagedream", tstage, tiny=True, image_size=IMAGE, n_view=NV,
                              device="cpu", text_embeddings=text)
    g.unet.load_state_dict(unet_from_flax(variables["unet"], g.shapes.unet), strict=True)
    g.vae.load_state_dict(vae_from_flax(variables["vae"]), strict=True)
    draws = _jax_draws(key, jcfg, NV)
    draws["sds"] = _sds_draws(key)
    results = {}
    for mode in ("split", "fused"):
        tparams, tmodel = port_copy(jparams, jmodel)
        state, opt = ttr.init_train_state(tparams, tcfg, stage=tstage)
        state.bg_params = background_from_numpy(jax.tree_util.tree_map(np.asarray, bg), "cpu")
        state.step = step_i
        step = ttr.make_train_step(tmodel, tcfg, tstage, opt, gen_size=GEN, gt_size=SIZE,
                                   normal_size=SIZE, raster=TRASTER, use_explicit=True,
                                   guidance_fn=g, split_sds=mode == "split")
        batch = ttr.make_gt_batch(tds, tmodel, 2, device="cpu")
        batch["ref_ip"] = t(ref_ip)
        if mode == "split":
            tlat, tc2w, sd = step.sds_prelude(state, batch, draws)
            assert not tlat.requires_grad
            assert_close(tlat.permute(0, 2, 3, 1), lat, 1e-4 * float(np.abs(lat).max()))
            batch["sds_target"] = g.compute_target(tlat, tc2w, state.step, sd,
                                                   ref_ip=batch["ref_ip"])
            assert_close(batch["sds_target"].permute(0, 2, 3, 1), jbatch["sds_target"],
                         1e-4 * float(np.abs(jbatch["sds_target"]).max()))
        else:
            assert step.sds_prelude is None
        loss, metrics, _ = step.loss_fn(tparams, state.bg_params, batch, draws, step_i)
        opt.zero_grad()
        loss.backward()
        grads = {}
        for k, v in port_leaves(tparams).items():
            gr = v.grad if v.is_leaf else (None if v._base.grad is None else v._base.grad.T)
            grads[k] = None if gr is None else gr.clone()
        results[mode] = ({k: float(v) for k, v in metrics.items()}, grads)

    (ms, gs), (mf, gf) = results["split"], results["fused"]
    assert set(ms) == set(mf) == set(jmetrics) and "loss_sds" in ms, sorted(ms)
    for k in ms:
        assert ms[k] == pytest.approx(mf[k], rel=1e-6, abs=1e-9), k
        assert_close(ms[k], jmetrics[k], 1e-7, 1e-4, msg=k)
    for k, jg in jgrads.items():
        jg = np.asarray(jg)
        if not np.any(jg):
            assert gs[k] is None or not bool(gs[k].any()), k
            continue
        assert _rel_l2(gs[k], n(gf[k])) <= 1e-4, (k, _rel_l2(gs[k], n(gf[k])))
        tol = 1e-2 if k.endswith("encoding") else 1e-3
        assert _rel_l2(gs[k], jg) <= tol, (k, _rel_l2(gs[k], jg))
    # A split step without its target says what is missing.
    tparams, tmodel = port_copy(jparams, jmodel)
    state, opt = ttr.init_train_state(tparams, tcfg, stage=tstage)
    step = ttr.make_train_step(tmodel, tcfg, tstage, opt, gen_size=GEN, gt_size=SIZE,
                               normal_size=SIZE, raster=TRASTER, use_explicit=True,
                               guidance_fn=g, split_sds=True)
    with pytest.raises(ValueError, match="sds_target"):
        step.loss_fn(tparams, state.bg_params, ttr.make_gt_batch(tds, tmodel, 2, device="cpu"),
                     draws, step_i)


# ------------------------------------------------------------ prompts


def test_prompt_processor_npz_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    path = str(tmp_path / "emb.npz")
    np.savez(path, cond=rng.randn(77, 24), uncond=rng.randn(77, 24).astype(np.float32))
    want = jprompt.PromptProcessor("a person", embeddings_path=path)()
    got = tprompt.PromptProcessor("a person", embeddings_path=path)()
    assert got.dtype == np.float32 and got.shape == (2, 77, 24)
    np.testing.assert_array_equal(got, want)
    assert tprompt.NEGATIVE_PROMPT == jprompt.NEGATIVE_PROMPT
    for mod in (jprompt, tprompt):
        with pytest.raises(FileNotFoundError):
            mod.PromptProcessor("x", embeddings_path=str(tmp_path / "none.npz"),
                                clip_model_dir=str(tmp_path / "none"))()
