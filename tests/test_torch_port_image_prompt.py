"""ImageDream's image prompt against soar_tpu on the CPU: the CLIP ViT tower
(all three feature modes), the Resampler and the embedding function with
its resize, at the tiny configs with flax variables carried across
(``io/from_jax``); the key manifests and the full-shape modules' keys; a
checkpoint with the image towers read by both packages; the release of the
towers; and the guidance closure embedding a reference image in the call.

Tolerances, each with its reason:
- the tower and the Resampler, float32: 1e-5 of each output's largest
  magnitude (the same arithmetic; LayerNorm, softmax and matmuls sum in
  other orders);
- with the resize in front: 1e-4 (the antialiased bicubic weights are
  computed in another order, ~5e-6 at the image; two networks amplify it);
- the guidance closure: the timestep exactly, loss and grad_norm 1e-4
  relative, the render's gradient 1e-4 of its largest entry (the tiny
  UNet and VAE, as in ``test_torch_port_guidance.py``).
"""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.guidance import build as jbuild
from soar_tpu.guidance import clip_vit as jclip
from soar_tpu.guidance import manifest as jman
from soar_tpu.train.config import StageConfig as JStageConfig
from soar_tpu_torch.guidance import build as tbuild
from soar_tpu_torch.guidance import clip_vit as tclip
from soar_tpu_torch.guidance import manifest as tman
from soar_tpu_torch.io.from_jax import (clip_vit_from_flax, resampler_from_flax, unet_from_flax,
                                        vae_from_flax)
from soar_tpu_torch.train.config import StageConfig
from torch_port_helpers import (assert_close, n, random_flax_variables, t,
                                tiny_guidance_variables)

CLIP_T, RES_T = tclip.CLIPVisionConfig.tiny(), tclip.ResamplerConfig.tiny()
CLIP_J, RES_J = jclip.CLIPVisionConfig.tiny(), jclip.ResamplerConfig.tiny()
V = 2


def _close_to_max(got, want, rel, msg=""):
    want = np.asarray(want)
    assert_close(got, want, rel * float(np.abs(want).max()), msg=msg)


def _clip_vars(features, seed=0):
    img = jnp.zeros((1, CLIP_J.image_size, CLIP_J.image_size, 3))
    shapes = jax.eval_shape(jclip.CLIPViT(CLIP_J, features).init, jax.random.PRNGKey(0), img)
    return random_flax_variables(shapes, seed)


def _resampler_vars(seed=1):
    n_tok = 1 + (CLIP_J.image_size // CLIP_J.patch_size) ** 2
    tok = jnp.zeros((1, n_tok, CLIP_J.width))
    shapes = jax.eval_shape(jclip.Resampler(RES_J).init, jax.random.PRNGKey(0), tok)
    return random_flax_variables(shapes, seed)


def _port_clip(variables, features="penultimate"):
    m = tclip.CLIPViT(CLIP_T, features)
    m.load_state_dict(clip_vit_from_flax(variables), strict=True)
    return m.eval()


def _port_resampler(variables):
    m = tclip.Resampler(RES_T)
    m.load_state_dict(resampler_from_flax(variables), strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def towers():
    return {"clip": _clip_vars("penultimate"), "res": _resampler_vars()}


# ------------------------------------------------------------ the modules


@pytest.mark.parametrize("features", ["penultimate", "tokens", "pooled"])
def test_clip_vit_matches_jax(features):
    variables = _clip_vars(features, seed=2)
    x = np.random.RandomState(3).randn(2, 28, 28, 3).astype(np.float32)
    want = np.asarray(jclip.CLIPViT(CLIP_J, features).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_clip(variables, features)(t(x).permute(0, 3, 1, 2))
    assert got.shape == want.shape
    _close_to_max(got, want, 1e-5)
    assert np.abs(want).max() > 0.1


def test_resampler_matches_jax(towers):
    x = np.random.RandomState(4).randn(2, 5, CLIP_J.width).astype(np.float32)
    want = np.asarray(jclip.Resampler(RES_J).apply(towers["res"], jnp.asarray(x)))
    with torch.no_grad():
        got = _port_resampler(towers["res"])(t(x))
    assert got.shape == (2, RES_T.num_queries, RES_T.output_dim)
    _close_to_max(got, want, 1e-5)


@pytest.mark.parametrize("hw", [(512, 512), (128, 128), (300, 200)])
def test_image_embed_fn_matches_jax(towers, hw):
    """The shorter side to the tower's size (antialiased bicubic), the
    centre crop, the CLIP normalisation, the tower and the Resampler."""
    img = np.random.RandomState(hw[0] + hw[1]).rand(*hw, 3).astype(np.float32)
    jfn = jclip.make_image_embed_fn(towers["clip"], towers["res"], CLIP_J, RES_J)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(img)))
    got = tclip.make_image_embed_fn(_port_clip(towers["clip"]),
                                    _port_resampler(towers["res"]))(t(img))
    assert got.dtype == torch.float32 and got.shape == want.shape == (4, 16)
    _close_to_max(got, want, 1e-4)
    # The resize alone, against jax.image.resize and the same crop.
    s = CLIP_J.image_size
    scale = s / min(hw)
    nh, nw = round(hw[0] * scale), round(hw[1] * scale)
    ref = jax.image.resize(jnp.asarray(img), (nh, nw, 3), method="cubic")
    y0, x0 = (nh - s) // 2, (nw - s) // 2
    assert_close(tclip.resize_and_crop(t(img), s)[0].permute(1, 2, 0),
                 ref[y0:y0 + s, x0:x0 + s], 2e-5)


# ------------------------------------------------------- key names


def test_manifests_equal_soar_tpus():
    for name in ("unet_key_manifest", "vae_encoder_key_manifest", "clip_vit_h_key_manifest",
                 "resampler_key_manifest"):
        assert getattr(tman, name)() == getattr(jman, name)(), name
    assert tman.unet_key_manifest(ipmv=False) == jman.unet_key_manifest(ipmv=False)


def test_full_shape_image_modules_match_the_manifests():
    """On the meta device (no memory): the pooled tower holds exactly the
    open_clip keys, the penultimate tower (ImageDream's) those minus the
    last block, ln_post and proj; the Resampler exactly IP-Adapter's."""
    shapes = tbuild.NetworkShapes.full()
    clip, res = tbuild.make_image_encoder(shapes, device="meta")
    prefix = "embedder.model.visual."
    want = {k[len(prefix):]: v for k, v in tman.clip_vit_h_key_manifest().items()}
    got = {k: tuple(v.shape) for k, v in clip.state_dict().items()}
    assert set(want) - set(got) == clip.unheld_keys() and len(clip.unheld_keys()) == 15
    assert got == {k: v for k, v in want.items() if k in got}
    assert sum(p.numel() for p in clip.parameters()) == 611_086_080
    with torch.device("meta"):
        pooled = tclip.CLIPViT(shapes.clip_cfg, features="pooled")
    assert {k: tuple(v.shape) for k, v in pooled.state_dict().items()} == want
    assert sum(p.numel() for p in pooled.parameters()) == 632_076_800
    prefix = "image_proj_model."
    want = {k[len(prefix):]: v for k, v in tman.resampler_key_manifest().items()}
    assert {k: tuple(v.shape) for k, v in res.state_dict().items()} == want
    assert sum(p.numel() for p in res.parameters()) == 48_541_696
    # A full tower's state_dict loads into the penultimate one minus exactly
    # those 15 keys, and nothing else may be left out.
    full = {k: torch.empty(0) for k in pooled.state_dict()}
    assert set(tclip.clip_state_dict_for(clip, full)) == set(clip.state_dict())
    with pytest.raises(ValueError, match="outside"):
        tclip.clip_state_dict_for(clip, {k: v for k, v in full.items() if k != "proj"})


# ------------------------------------------------------- checkpoints


def _tiny_ckpt(path, tiny_vars, towers, clip_prefix, with_image=True):
    """A torch checkpoint written by the port: the tiny ipmv UNet, the VAE
    and (``with_image``) the Resampler and a whole open_clip tower (the
    penultimate tower's weights plus a last block, ln_post and proj)."""
    shapes = tbuild.NetworkShapes.tiny(32)
    unet, vae = tbuild.make_networks(shapes, True, device="cpu")
    unet.load_state_dict(unet_from_flax(tiny_vars["unet"], shapes.unet), strict=True)
    vae.load_state_dict(vae_from_flax(tiny_vars["vae"]), strict=True)
    sd = {"model.diffusion_model." + k: v for k, v in unet.state_dict().items()}
    sd.update({"first_stage_model." + k: v for k, v in vae.state_dict().items()})
    if with_image:
        full = _port_clip(_clip_vars("pooled", seed=9), "pooled").state_dict()
        full.update(_port_clip(towers["clip"]).state_dict())
        sd.update({clip_prefix + k: v for k, v in full.items()})
        sd.update({"image_proj_model." + k: v
                   for k, v in _port_resampler(towers["res"]).state_dict().items()})
    torch.save({"state_dict": sd}, path)


@pytest.mark.parametrize("clip_prefix", ["embedder.model.visual.",
                                         "image_embedder.model.visual."])
def test_image_checkpoint_loads_in_both_packages(towers, tmp_path, clip_prefix):
    tiny_vars = tiny_guidance_variables(n_view=V, with_ip=True, seed=5)
    path = str(tmp_path / "ipmv.ckpt")
    _tiny_ckpt(path, tiny_vars, towers, clip_prefix)
    text = np.random.RandomState(0).randn(2, 77, 16).astype(np.float32)
    img = np.random.RandomState(1).rand(64, 48, 3).astype(np.float32)
    jg = jbuild.build_guidance("imagedream", JStageConfig(), ckpt_path=path, tiny=True,
                               image_size=32, n_view=V, text_embeddings=text)
    tg = tbuild.build_guidance("imagedream", StageConfig(), ckpt_path=path, tiny=True,
                               image_size=32, n_view=V, text_embeddings=text, device="cpu")
    want = np.asarray(jg.embed_ref(jnp.asarray(img)))
    got = tg.embed_ref(img)
    _close_to_max(got, want, 1e-4)
    # ... and they are the tokens of the towers written into the checkpoint.
    jfn = jclip.make_image_embed_fn(towers["clip"], towers["res"], CLIP_J, RES_J)
    _close_to_max(got, np.asarray(jfn(jnp.asarray(img))), 1e-4)

    # A checkpoint without the image towers is not ImageDream's.
    bare = str(tmp_path / "bare.ckpt")
    _tiny_ckpt(bare, tiny_vars, towers, clip_prefix, with_image=False)
    for build, stage, kw in ((jbuild.build_guidance, JStageConfig(), {}),
                             (tbuild.build_guidance, StageConfig(), {"device": "cpu"})):
        with pytest.raises(ValueError, match="ipmv"):
            build("imagedream", stage, ckpt_path=bare, tiny=True, image_size=32, n_view=V,
                  text_embeddings=text, **kw)


def test_release_frees_the_image_towers():
    g = tbuild.build_guidance("imagedream", StageConfig(), tiny=True, image_size=32, n_view=V,
                              device="cpu")
    refs = [weakref.ref(g.image_encoder[k]) for k in ("clip", "resampler")]
    tokens = g.embed_ref(np.random.RandomState(0).rand(40, 40, 3).astype(np.float32))
    assert tokens.shape == g.shapes.ip_shape and tokens.dtype == torch.float32
    g1 = g.for_stage(StageConfig(guidance_scale=7.5))
    g.release_image_encoder()
    gc.collect()
    assert all(r() is None for r in refs)
    assert g1.image_encoder == {"clip": None, "resampler": None}
    with pytest.raises(RuntimeError, match="released"):
        g1.embed_ref(np.zeros((8, 8, 3), np.float32))
    rgb = torch.rand(V, 32, 32, 3)
    c2w = torch.eye(4).repeat(V, 1, 1)
    c2w[:, 2, 3] = 2.0
    draws = {"u": torch.tensor(0.5), "noise": torch.randn(V, 16, 16, 4),
             "vae_eps": torch.randn(V, 16, 16, 4)}
    with pytest.raises(RuntimeError, match="released"):
        g(rgb, c2w, 5, draws, ref_rgb=torch.rand(16, 16, 3))
    # Precomputed tokens need no tower; with neither input the call raises.
    assert torch.isfinite(g(rgb, c2w, 5, draws, ref_ip=tokens)["loss_sds"])
    with pytest.raises(ValueError, match="ip tokens"):
        g(rgb, c2w, 5, draws)
    mv = tbuild.build_guidance("mvdream", StageConfig(), tiny=True, image_size=32, n_view=V,
                               device="cpu")
    assert mv.embed_ref is None and mv.image_encoder == {"clip": None, "resampler": None}
    mv.release_image_encoder()


# ------------------------------------------- the guidance embeds the image


def test_guidance_fn_embeds_ref_rgb_like_jax(monkeypatch, towers):
    """ImageDream with the reference image and no tokens: both packages
    embed it in the call (JAX's ``guidance_fn`` passes ``ref_rgb`` on when
    ``ref_ip`` is None), with the JAX draws injected."""
    variables = tiny_guidance_variables(V, with_ip=True, image_size=32, seed=6)
    rng = np.random.RandomState(7)
    text = rng.randn(2, 77, 16).astype(np.float32)
    monkeypatch.setattr(jbuild, "init_mock_networks", lambda *a, **k: {
        "unet": jax.tree_util.tree_map(jnp.asarray, variables["unet"]),
        "vae": jax.tree_util.tree_map(jnp.asarray, variables["vae"])})
    monkeypatch.setattr(jbuild, "_mock_clip_vars", lambda *a, **k: (towers["clip"], towers["res"]))
    stage = dict(guidance_scale=7.5)
    jg = jbuild.build_guidance("imagedream", JStageConfig(**stage), tiny=True, image_size=32,
                               n_view=V, text_embeddings=text)
    tg = tbuild.build_guidance("imagedream", StageConfig(**stage), tiny=True, image_size=32,
                               n_view=V, text_embeddings=text, device="cpu")
    tg.unet.load_state_dict(unet_from_flax(variables["unet"], tg.shapes.unet), strict=True)
    tg.vae.load_state_dict(vae_from_flax(variables["vae"]), strict=True)
    tg.image_encoder["clip"].load_state_dict(clip_vit_from_flax(towers["clip"]), strict=True)
    tg.image_encoder["resampler"].load_state_dict(resampler_from_flax(towers["res"]),
                                                  strict=True)

    rgb = rng.rand(V, 32, 32, 3).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(V, 3, 3))
    c2w = np.tile(np.eye(4, dtype=np.float32), (V, 1, 1))
    c2w[:, :3, :3], c2w[:, :3, 3] = q, rng.randn(V, 3) * 2.0
    ref = rng.rand(48, 40, 3).astype(np.float32)
    key, step = jax.random.PRNGKey(3), 40

    def jloss(r, s):
        out = jg(r, jnp.asarray(c2w), s, key, ref_rgb=jnp.asarray(ref))
        return out["loss_sds"], out

    (_, jout), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(rgb), jnp.asarray(step, jnp.int32))
    k_t, k_noise, k_enc = jax.random.split(key, 3)
    shape = (V, 16, 16, 4)
    draws = {"u": t(jax.random.uniform(k_t)), "noise": t(jax.random.normal(k_noise, shape)),
             "vae_eps": t(jax.random.normal(k_enc, shape))}
    rgb_t = t(rgb).requires_grad_(True)
    out = tg(rgb_t, t(c2w).float(), step, draws, ref_rgb=t(ref))
    out["loss_sds"].backward()
    assert int(out["t"]) == int(jout["t"])
    assert_close(out["loss_sds"], jout["loss_sds"], 1e-8, 1e-4)
    assert_close(out["grad_norm"], jout["grad_norm"], 1e-8, 1e-4)
    _close_to_max(rgb_t.grad, jgrad, 1e-4)
    # The tokens it embedded are the ones embed_ref gives, and they count:
    # other tokens move the loss.
    tokens = tg.embed_ref(ref)
    with torch.no_grad():
        same = tg(t(rgb), t(c2w).float(), step, draws, ref_ip=tokens)["loss_sds"]
        other = tg(t(rgb), t(c2w).float(), step, draws, ref_ip=torch.zeros_like(tokens))["loss_sds"]
    assert_close(same, n(out["loss_sds"]), 1e-6, 1e-6)
    assert abs(float(other) - float(same)) > 1e-6 * abs(float(same))
