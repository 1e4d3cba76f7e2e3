"""The SDS guidance modules against soar_tpu on the CPU: the DDPM schedule,
the camera conditioning, MultiviewGuidance's math, the tiny 4-view UNet
(with and without the image-prompt branch) and VAE encoder with flax
variables carried across, the full-shape networks' checkpoint keys, and a
checkpoint round trip through the JAX package's loader.

Tolerances, each with its reason:
- the schedule, q_sample and the camera: elementwise float32 with the same
  arithmetic, 1e-6;
- MultiviewGuidance with the mock networks: the timestep exactly (an
  integer from the same float32 product); loss and grad_norm 1e-5
  relative; the input gradient 1e-5 of its largest entry (the antialiased
  resize's weights are computed in another order);
- the tiny networks, float32: 1e-4 of each output's largest magnitude (the
  convolutions, norms and softmaxes sum in other orders through ~30
  layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from soar_tpu.guidance import build as jbuild
from soar_tpu.guidance import sds as jsds
from soar_tpu.guidance.manifest import unet_key_manifest, vae_encoder_key_manifest
from soar_tpu.guidance.scheduler import DDPMSchedule as JSchedule
from soar_tpu.train.config import StageConfig as JStageConfig
from soar_tpu_torch.guidance import build as tbuild
from soar_tpu_torch.guidance import clip_vit as tclip
from soar_tpu_torch.guidance import sds as tsds
from soar_tpu_torch.guidance.scheduler import DDPMSchedule
from soar_tpu_torch.io.from_jax import text_embeddings_from_numpy, unet_from_flax, vae_from_flax
from soar_tpu_torch.train.config import StageConfig
from torch_port_helpers import assert_close, n, t, tiny_guidance_variables

V = 2


def _nchw(a):
    return t(a).permute(0, 3, 1, 2)


def _nhwc(x):
    return n(x.permute(0, 2, 3, 1))


def _close_to_max(got, want, rel, msg=""):
    want = np.asarray(want)
    assert_close(got, want, rel * float(np.abs(want).max()), msg=msg)


def _c2w(rng, nv=V):
    q, _ = np.linalg.qr(rng.randn(nv, 3, 3))
    c2w = np.tile(np.eye(4, dtype=np.float32), (nv, 1, 1))
    c2w[:, :3, :3] = q
    c2w[:, :3, 3] = rng.randn(nv, 3) * 2.0
    return c2w.astype(np.float32)


# ---------------------------------------------------------------- schedule


def test_schedule_and_camera_match_jax():
    js = JSchedule.stable_diffusion()
    ts = DDPMSchedule.stable_diffusion(device="cpu")
    for got, want in zip(ts, js):
        assert got.dtype == torch.float32
        assert_close(got, want, 1e-6)
    rng = np.random.RandomState(0)
    x0 = rng.randn(V, 4, 4, 4).astype(np.float32)
    noise = rng.randn(V, 4, 4, 4).astype(np.float32)
    for step in (0, 17, 500, 999):
        xt = js.q_sample(jnp.asarray(x0), step, jnp.asarray(noise))
        assert_close(ts.q_sample(t(x0), torch.tensor(step), t(noise)), xt, 1e-6)
        assert_close(ts.predict_start_from_noise(t(x0), step, t(noise)),
                     js.predict_start_from_noise(jnp.asarray(x0), step, jnp.asarray(noise)),
                     1e-6, 1e-6)
    c2w = _c2w(rng, 4)
    c2w[0, :3, 3] = 0.0  # the clamp of a zero translation
    assert_close(tsds.normalize_camera(t(c2w)), jsds.normalize_camera(jnp.asarray(c2w)), 1e-6)


def test_timestep_matches_jax_over_the_anneal():
    """t equal as an integer over the annealed window of both stages."""
    text = np.zeros((2, 77, 16), np.float32)
    lat = jnp.zeros((V, 4, 4, 4))
    c2w = jnp.asarray(_c2w(np.random.RandomState(1)))
    for stage in (JStageConfig(), JStageConfig(max_step_percent=(0, 0.75, 0.25, 1000))):
        jcfg = jsds.GuidanceConfig(min_step_percent=stage.min_step_percent,
                                   max_step_percent=stage.max_step_percent, n_view=V)
        tcfg = tsds.GuidanceConfig(min_step_percent=stage.min_step_percent,
                                   max_step_percent=stage.max_step_percent, n_view=V)
        mv = jsds.MultiviewGuidance(jcfg, None, lambda x, tt, c: jnp.zeros_like(x),
                                    jnp.asarray(text))
        target = jax.jit(lambda k, s: mv.compute_target(lat, c2w, k, s)[1])
        for i, step in enumerate(range(0, 2301, 53)):
            key = jax.random.PRNGKey(i)
            u = jax.random.uniform(jax.random.split(key, 3)[0])
            got = tsds.sample_timestep(tcfg, step, t(u))
            assert got.dtype == torch.int64
            assert int(got) == int(target(key, jnp.asarray(step, jnp.int32))), step


# ------------------------------------------------------- guidance math

CASES = [
    # (gen size, config overrides, x0 target, step)
    (16, dict(recon_loss=True, recon_std_rescale=0.2), False, 0),
    (32, dict(recon_loss=True, recon_std_rescale=0.0), True, 700),
    (64, dict(recon_loss=True, recon_std_rescale=0.2), True, 1500),
    (64, dict(recon_loss=False), True, 300),
    (32, dict(recon_loss=False, grad_clip=0.05), True, 2500),
]


def _sds_draws(key, shape):
    """MultiviewGuidance's draws from ``key`` as the JAX package takes them
    (``sds.py:98-145``): (u, noise, vae_eps)."""
    k_t, k_noise, k_enc = jax.random.split(key, 3)
    return {"u": t(jax.random.uniform(k_t)), "noise": t(jax.random.normal(k_noise, shape)),
            "vae_eps": t(jax.random.normal(k_enc, shape))}


@pytest.mark.parametrize("gen,kw,with_target,step", CASES)
def test_multiview_guidance_matches_jax(gen, kw, with_target, step):
    rng = np.random.RandomState(gen + step)
    size, lat = 32, 4  # mock encoder: average-pool by 8
    rgb = rng.rand(V, gen, gen, 3).astype(np.float32)
    c2w = _c2w(rng)
    text = rng.randn(2, 77, 16).astype(np.float32)
    x0 = rng.randn(V, lat, lat, 4).astype(np.float32) * 0.5 if with_target else None
    ref_ip = rng.randn(4, 16).astype(np.float32)
    key = jax.random.PRNGKey(gen * 7 + step)

    jsched = JSchedule.stable_diffusion()
    seen = {}

    def jden(x, tt, ctx):
        seen["jax"] = ctx
        return jsds.mock_denoiser(jsched, None if x0 is None else jnp.asarray(x0))(x, tt, ctx)

    jcfg = jsds.GuidanceConfig(n_view=V, image_size=size, **kw)
    jmv = jsds.MultiviewGuidance(jcfg, jsds.mock_encoder(8), jden, jnp.asarray(text))

    def jloss(r, s):
        out = jmv(r, jnp.asarray(c2w), key, s, ref_ip=jnp.asarray(ref_ip))
        ctx = {k: seen["jax"][k] for k in ("context", "camera", "ip")}
        return out["loss_sds"], (out, ctx)

    # Jitted with a traced step, as the training step runs it: XLA then
    # multiplies by the schedule span's reciprocal (see sds._scheduled_f32).
    (_, (jout, jctx)), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(rgb), jnp.asarray(step, jnp.int32))

    tsched = DDPMSchedule.stable_diffusion(device="cpu")
    tden_inner = tsds.mock_denoiser(tsched, None if x0 is None else _nchw(x0))

    def tden(x, tt, ctx):
        seen["port"] = ctx
        return tden_inner(x, tt, ctx)

    tcfg = tsds.GuidanceConfig(n_view=V, image_size=size, **kw)
    tmv = tsds.MultiviewGuidance(tcfg, tsds.mock_encoder(8), tden, t(text))
    rgb_t = t(rgb).requires_grad_(True)
    out = tmv(rgb_t, t(c2w), step, _sds_draws(key, (V, lat, lat, 4)), ref_ip=t(ref_ip))
    out["loss_sds"].backward()

    assert int(out["t"]) == int(jout["t"])
    assert_close(out["loss_sds"], jout["loss_sds"], 1e-8, 1e-5)
    assert_close(out["grad_norm"], jout["grad_norm"], 1e-8, 1e-5)
    _close_to_max(rgb_t.grad, jgrad, 1e-5)
    assert float(jnp.abs(jgrad).max()) > 0
    # The UNet's conditioning: [cond; uncond] text, cameras twice, the ip
    # tokens then zeros.
    for k in ("context", "camera", "ip"):
        assert_close(seen["port"][k], jctx[k], 1e-6, msg=k)
    assert seen["port"]["num_frames"] == V
    assert_close(seen["port"]["ip"][V:], np.zeros((V, 4, 16)), 0)


# ------------------------------------------------------------ networks


@pytest.fixture(scope="module")
def tiny_vars():
    return {ip: tiny_guidance_variables(n_view=V, with_ip=ip, seed=3 + ip) for ip in (False, True)}


def _unet_inputs(rng, with_ip, B=2 * V):
    x = rng.randn(B, 16, 16, 4).astype(np.float32)
    tt = np.array([10, 500, 999, 3][:B], np.int32)
    ctx = {"context": rng.randn(B, 77, 16).astype(np.float32),
           "camera": rng.randn(B, 16).astype(np.float32)}
    if with_ip:
        ctx["ip"] = rng.randn(B, 4, 16).astype(np.float32)
    return x, tt, ctx


def _jax_unet(variables, x, tt, ctx, num_frames):
    unet = jbuild.NetworkShapes.tiny(32).unet
    c = {k: jnp.asarray(v) for k, v in ctx.items()}
    c["num_frames"] = num_frames
    return np.asarray(jax.jit(lambda v, a, b: unet.apply(v, a, b, c))(
        variables, jnp.asarray(x), jnp.asarray(tt)))


def _port_unet(module, x, tt, ctx, num_frames):
    c = {k: t(v) for k, v in ctx.items()}
    c["num_frames"] = num_frames
    with torch.no_grad():
        return _nhwc(module(_nchw(x), t(tt), c))


@pytest.mark.parametrize("with_ip", [False, True])
@pytest.mark.parametrize("num_frames", [2, 1])
def test_tiny_unet_matches_jax(tiny_vars, with_ip, num_frames):
    shapes = tbuild.NetworkShapes.tiny(32)
    unet, _ = tbuild.make_networks(shapes, with_ip, device="cpu")
    jvars = tiny_vars[with_ip]["unet"]
    unet.load_state_dict(unet_from_flax(jvars, shapes.unet), strict=True)
    x, tt, ctx = _unet_inputs(np.random.RandomState(num_frames + 2 * with_ip), with_ip)
    want = _jax_unet(jvars, x, tt, ctx, num_frames)
    _close_to_max(_port_unet(unet, x, tt, ctx, num_frames), want, 1e-4)
    assert np.abs(want).max() > 0.1


def test_tiny_vae_matches_jax_with_vjp(tiny_vars):
    shapes = tbuild.NetworkShapes.tiny(32)
    _, vae = tbuild.make_networks(shapes, False, device="cpu")
    jvars = tiny_vars[False]["vae"]
    vae.load_state_dict(vae_from_flax(jvars), strict=True)
    rng = np.random.RandomState(5)
    img = rng.rand(V, 32, 32, 3).astype(np.float32)
    ct = rng.randn(V, 16, 16, 4).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jvae = jbuild.NetworkShapes.tiny(32).vae
    want, vjp = jax.vjp(lambda im: jvae.apply(jvars, im, key), jnp.asarray(img))
    (want_g,) = vjp(jnp.asarray(ct))
    eps = np.asarray(jax.random.normal(key, (V, 16, 16, 4)))
    img_t = _nchw(img).requires_grad_(True)
    got = vae(img_t, _nchw(eps))
    got.backward(_nchw(ct))
    _close_to_max(_nhwc(got), want, 1e-4)
    _close_to_max(_nhwc(img_t.grad), want_g, 1e-4)
    # Without eps: the posterior mean.
    mean = np.asarray(jvae.apply(jvars, jnp.asarray(img)))
    with torch.no_grad():
        _close_to_max(_nhwc(vae(_nchw(img))), mean, 1e-4)


@pytest.mark.parametrize("ipmv", [True, False])
def test_full_shape_keys_match_the_manifests(ipmv):
    """The full-shape networks (on the meta device: no memory) have the
    checkpoint's keys and shapes, so an LDM checkpoint loads strictly."""
    unet, vae = tbuild.make_networks(tbuild.NetworkShapes.full(), ipmv, device="meta")
    got = {k: tuple(v.shape) for k, v in unet.state_dict().items()}
    want = unet_key_manifest(ipmv=ipmv)
    assert got == want, sorted(set(got) ^ set(want))[:8]
    assert sum(p.numel() for p in unet.parameters()) == (893_131_204 if ipmv else 867_572_164)
    got = {k: tuple(v.shape) for k, v in vae.state_dict().items()}
    assert got == vae_encoder_key_manifest()
    assert sum(p.numel() for p in vae.parameters()) == 34_163_664


def _flat(tree):
    import jax

    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_checkpoint_round_trip(tiny_vars, tmp_path):
    """flax variables (random biases and norm scales) -> ``unet_from_flax``
    / ``vae_from_flax`` -> the port's modules -> a torch checkpoint with the
    LDM prefixes -> the JAX package's loader: the same trees, leaf by leaf,
    and the same UNet and VAE outputs; the port's loader reads the same
    checkpoint back into the same weights."""
    stage = StageConfig()
    text = np.random.RandomState(0).randn(2, 77, 16).astype(np.float32)
    g = tbuild.build_guidance("imagedream", stage, tiny=True, image_size=32, n_view=V,
                              device="cpu", text_embeddings=text,
                              generator=torch.Generator().manual_seed(4))
    assert_close(g.guidance.text_embeddings, text_embeddings_from_numpy(text, "cpu"), 0)
    jvars = tiny_vars[True]
    g.unet.load_state_dict(unet_from_flax(jvars["unet"], g.shapes.unet), strict=True)
    g.vae.load_state_dict(vae_from_flax(jvars["vae"]), strict=True)
    sd = {"model.diffusion_model." + k: v for k, v in g.unet.state_dict().items()}
    sd.update({"first_stage_model." + k: v for k, v in g.vae.state_dict().items()})
    sd["first_stage_model.decoder.conv_in.weight"] = torch.zeros(3)  # not read
    # ImageDream's checkpoint also holds the image towers (a whole open_clip
    # tower: the penultimate one's weights plus the keys it does not hold).
    clip = g.image_encoder["clip"]
    whole = dict(tclip.CLIPViT(clip.cfg, features="pooled").state_dict(), **clip.state_dict())
    sd.update({"embedder.model.visual." + k: v for k, v in whole.items()})
    sd.update({"image_proj_model." + k: v
               for k, v in g.image_encoder["resampler"].state_dict().items()})
    path = str(tmp_path / "tiny.ckpt")
    torch.save({"state_dict": sd}, path)

    jv = jbuild.load_guidance_checkpoint(path, jbuild.NetworkShapes.tiny(32))
    for net in ("unet", "vae"):
        got, want = _flat(jv[net]), _flat(jvars[net])
        assert set(got) == set(want), sorted(set(got) ^ set(want))[:8]
        for k in want:
            assert_close(got[k], want[k], 0, msg=net + k)
    x, tt, ctx = _unet_inputs(np.random.RandomState(7), True)
    want = _jax_unet(jv["unet"], x, tt, ctx, V)
    _close_to_max(_port_unet(g.unet, x, tt, ctx, V), want, 1e-4)
    img = np.random.RandomState(8).rand(V, 32, 32, 3).astype(np.float32)
    jvae = jbuild.NetworkShapes.tiny(32).vae
    with torch.no_grad():
        _close_to_max(_nhwc(g.vae(_nchw(img))), jvae.apply(jv["vae"], jnp.asarray(img)), 1e-4)

    g2 = tbuild.build_guidance("imagedream", stage, tiny=True, image_size=32, n_view=V,
                               device="cpu", ckpt_path=path, text_embeddings=text)
    for a, b in ((g.unet, g2.unet), (g.vae, g2.vae),
                 (g.image_encoder["clip"], g2.image_encoder["clip"]),
                 (g.image_encoder["resampler"], g2.image_encoder["resampler"])):
        for (k, p), (k2, p2) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k == k2 and torch.equal(p, p2), k


class _HostReads(TorchDispatchMode):
    """Counts the aten ops that read a tensor's value on the host."""

    n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += "_local_scalar_dense" in str(func)
        return func(*args, **(kwargs or {}))


def test_build_guidance_contract():
    stage = StageConfig()
    g = tbuild.build_guidance("mvdream", stage, tiny=True, image_size=32, n_view=V,
                              device="cpu")
    assert g.latent_size == 16 and not hasattr(g.unet.input_blocks[1][1].transformer_blocks[0]
                                                  .attn2, "to_k_ip")
    assert all(not p.requires_grad for m in (g.unet, g.vae) for p in m.parameters())
    rng = np.random.RandomState(0)
    rgb = t(rng.rand(V, 32, 32, 3)).float().requires_grad_(True)
    draws = {"u": torch.tensor(0.5), "noise": torch.randn(V, 16, 16, 4),
             "vae_eps": torch.randn(V, 16, 16, 4)}
    with _HostReads() as reads:
        out = g(rgb, t(_c2w(rng)), 5, draws, ref_ip=torch.zeros(4, 16))  # ip dropped
        out["loss_sds"].backward()
    assert reads.n == 0  # no device value read on the host: no sync on a GPU
    assert torch.isfinite(rgb.grad).all() and float(rgb.grad.abs().max()) > 0
    assert all(p.grad is None for m in (g.unet, g.vae) for p in m.parameters())
    g1 = g.for_stage(StageConfig(guidance_scale=7.5))
    assert g1.unet is g.unet and g1.guidance.cfg.guidance_scale == 7.5
    gi = tbuild.build_guidance("imagedream", stage, tiny=True, image_size=32, n_view=V,
                               device="cpu")
    with pytest.raises(ValueError, match="ip tokens"):
        gi(rgb, t(_c2w(rng)), 5, draws)
    with pytest.raises(ValueError):
        tbuild.build_guidance("sd", stage, tiny=True, device="cpu")
    with pytest.raises(ValueError):
        tbuild.build_guidance("mvdream", stage, device="cpu")  # no weights
