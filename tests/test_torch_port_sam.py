"""``soar_tpu_torch.preproc.sam`` against ``soar_tpu.preproc.sam`` on the CPU.

A tiny ``SAMConfig`` with random flax weights (every leaf drawn, so no
conversion error hides behind a zero) is carried across with
``io.from_jax.sam_from_flax``; the image encoder, prompt encoder, mask
decoder and the whole model agree with flax to 1e-5 of the output's
scale, and the port's ``state_dict`` through JAX's ``convert_sam_params``
gives the same outputs.  At full shape the port's keys and shapes equal
``sam_vit_h_key_manifest``.  ``load_sam_predictor`` on a checkpoint the
test writes agrees with JAX's at a frame under and one over the input
size: masks differ on at most 0.5% of pixels (logits within rounding of
0 may flip; the resizes are antialiased in both packages but computed
differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.preproc import sam as J
from soar_tpu_torch.guidance.manifest import sam_vit_h_key_manifest
from soar_tpu_torch.io.from_jax import sam_from_flax
from soar_tpu_torch.preproc import sam as T
from torch_port_helpers import n, t

KW = dict(img_size=64, patch_size=16, embed_dim=32, depth=3, num_heads=4,
          global_attn_layers=(1,), window_size=3, out_chans=16, decoder_dim=16,
          decoder_depth=2, decoder_mlp_dim=32)
TOL = 1e-5
MASK_SHARE = 0.005


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = J.SAMConfig(**KW), T.SAMConfig(**KW)
    jsam = J.SAM(jcfg)
    img = jnp.zeros((1, 64, 64, 3))
    pts = jnp.asarray([[[0.5, 0.5], [0.2, 0.8]]])
    v = jsam.init(jax.random.PRNGKey(0), img, pts, jnp.asarray([[1.0, 1.0]]))
    leaves, td = jax.tree_util.tree_flatten(v)
    key = jax.random.PRNGKey(1)
    drawn = []
    for leaf in leaves:
        key, k = jax.random.split(key)
        drawn.append(jax.random.normal(k, leaf.shape) * 0.3)
    v = jax.tree_util.tree_unflatten(td, drawn)
    tsam = T.SAM(tcfg)
    tsam.load_state_dict(sam_from_flax(jax.tree_util.tree_map(np.asarray, v), tcfg), strict=True)
    return jcfg, tcfg, jsam, v, tsam.eval()


def _inputs(seed=2):
    rng = np.random.RandomState(seed)
    img = rng.randn(2, 64, 64, 3).astype(np.float32)
    pts = rng.rand(2, 4, 2).astype(np.float32)
    lbl = np.asarray([[1, 0, 1, -1], [1, 1, -1, -1]], np.float32)
    return img, pts, lbl


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=tol * max(np.abs(want).max(), 1.0), rtol=0)


def test_sam_modules_match_flax(tiny):
    jcfg, _, _, v, tsam = tiny
    p = v["params"]
    img, pts, lbl = _inputs()
    emb_j = J.SAMImageEncoder(jcfg).apply({"params": p["image_encoder"]}, jnp.asarray(img))
    with torch.no_grad():
        emb_t = tsam.image_encoder(t(img).permute(0, 3, 1, 2))
    _close(n(emb_t.permute(0, 2, 3, 1)), emb_j)

    pe_j = J.SAMPromptEncoder(jcfg).apply({"params": p["prompt_encoder"]}, jnp.asarray(pts),
                                          jnp.asarray(lbl), 4)
    with torch.no_grad():
        pe_t = tsam.prompt_encoder(t(pts), t(lbl), 4)
    for a, b in zip(pe_t, pe_j):
        _close(n(a), b)

    sparse, dense, image_pe = pe_j
    dec_j = J.SAMMaskDecoder(jcfg).apply({"params": p["mask_decoder"]}, emb_j, image_pe, sparse,
                                         dense)
    with torch.no_grad():
        dec_t = tsam.mask_decoder(t(np.asarray(emb_j)).permute(0, 3, 1, 2),
                                  *(t(np.asarray(x)) for x in (image_pe, sparse, dense)))
    for a, b in zip(dec_t, dec_j):
        _close(n(a), b)


def test_sam_matches_flax_both_ways(tiny):
    jcfg, _, jsam, v, tsam = tiny
    img, pts, lbl = _inputs(3)
    want = jsam.apply(v, jnp.asarray(img), jnp.asarray(pts), jnp.asarray(lbl))
    with torch.no_grad():
        got = tsam(t(img).permute(0, 3, 1, 2), t(pts), t(lbl))
    for a, b in zip(got, want):
        _close(n(a), b)
    assert np.asarray(want[0]).shape == (2, 4, 16, 16)
    # The port's state_dict, read by the JAX package's own converter.
    back = J.convert_sam_params({k: n(x) for k, x in tsam.state_dict().items()}, jcfg)
    again = jsam.apply(back, jnp.asarray(img), jnp.asarray(pts), jnp.asarray(lbl))
    for a, b in zip(got, again):
        _close(n(a), b)


def test_full_shape_keys_match_the_manifest():
    with torch.device("meta"):
        sam = T.SAM(T.SAMConfig())
    got = {k: tuple(x.shape) for k, x in sam.state_dict().items()}
    assert got == sam_vit_h_key_manifest()


def _centre_mask_logits(tsam, img, pts):
    """Random weights give each mask logits of one sign over the whole
    frame.  Shift the last bias of each multimask hypernetwork along the
    mean upscaled feature: the first mask's logits on ``img`` get mean 0,
    the other two mean -1 (all negative), so the union thresholded at 0
    carries both signs."""
    sd = {k: v.clone() for k, v in tsam.state_dict().items()}
    seen = {}
    dec = tsam.mask_decoder
    hooks = [dec.output_upscaling.register_forward_hook(
        lambda m, i, o: seen.__setitem__("up", o))]
    for j, mlp in enumerate(dec.output_hypernetworks_mlps):
        hooks.append(mlp.register_forward_hook(lambda m, i, o, j=j: seen.__setitem__(j, o)))
    T.SamPredictor(tsam)(img, pts)
    for h in hooks:
        h.remove()
    u = seen["up"][0].mean(dim=(1, 2))
    for j in range(1, len(dec.output_hypernetworks_mlps)):
        key = f"mask_decoder.output_hypernetworks_mlps.{j}.layers.2.bias"
        sd[key] -= (seen[j][0] @ u + (j > 1)) * u / (u @ u)
    return sd


@pytest.mark.parametrize("hw", [(48, 40), (80, 96)])
def test_predictor_matches_jax(tiny, tmp_path, hw):
    jcfg, tcfg, _, _, tsam = tiny
    rng = np.random.RandomState(4)
    img = (rng.rand(*hw, 3) * 255).astype(np.uint8)
    pts = np.asarray([[hw[1] * 0.5, hw[0] * 0.4], [hw[1] * 0.3, hw[0] * 0.7]], np.float32)
    path = str(tmp_path / "sam_tiny.pth")
    torch.save(_centre_mask_logits(tsam, img, pts), path)
    jpred = J.load_sam_predictor(path, jcfg)
    tpred = T.load_sam_predictor(path, tcfg, device="cpu")
    want = np.asarray(jpred(img, pts))
    got = tpred(img, pts)
    assert got.shape == want.shape == hw and got.dtype == bool
    assert 0.05 < want.mean() < 0.95, want.mean()
    assert np.mean(got != want) <= MASK_SHARE, np.mean(got != want)
    with pytest.raises(SystemExit):
        T.load_sam_predictor(None)
