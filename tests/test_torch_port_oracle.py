"""Parity of the port's exact oracle (``render/oracle.py``) with soar_tpu's,
on the fixtures of tests/test_render.py (``make_scene``, ``make_camera``).

Tolerances: both oracles run the same f32 arithmetic on the same sorted
surfels, so images agree to 1e-5 absolute; the depth image is divided by
1 - T and is compared where the oracle's opacity exceeds 0.5.  A pixel whose
alpha or T sits within rounding of a threshold may flip a splat between the
two packages (preprocess agrees to ~1e-6 relative): at most 0.5% of the
pixels may differ.  Gradients of a scalar loss agree to 1e-4 of the
gradient's largest magnitude.  The port's tiled renderer equals the port's
oracle to the JAX test's own 3e-4 (3e-3 for depth) where capacities suffice.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.core import camera as jcam
from soar_tpu.render import oracle as joracle
from soar_tpu.render import types as jtypes
from soar_tpu_torch.core import camera as tcam
from soar_tpu_torch.render import oracle as toracle
from soar_tpu_torch.render import tiled as ttiled
from soar_tpu_torch.render import types as ttypes
from torch_port_helpers import assert_close, assert_close_share, make_render_scene, n, t

FLIP_SHARE = 0.005


def make_scenes(n_pts, seed=0):
    arrs = make_render_scene(n_pts, seed=seed)
    return (jtypes.GaussianInputs(*(jnp.asarray(a) for a in arrs)),
            ttypes.GaussianInputs(*(t(a) for a in arrs)))


def make_cameras(dist=3.0, fov_deg=40.0, azim=0.3, elev=0.2):
    pos = np.array([dist * np.cos(elev) * np.sin(azim), dist * np.sin(elev),
                    dist * np.cos(elev) * np.cos(azim)], np.float32)
    c2w = n(tcam.look_at_c2w(t(pos), torch.zeros(3), torch.tensor([0.0, 1.0, 0.0])))
    fov = np.float32(np.deg2rad(fov_deg))
    return (jcam.camera_from_c2w(jnp.asarray(c2w), jnp.asarray(fov), jnp.asarray(fov)),
            tcam.camera_from_c2w(t(c2w), fov, fov))


def assert_images_match(got, want, atol=1e-5):
    for f in ("color", "normal", "opac", "transmittance"):
        assert_close_share(getattr(got, f), getattr(want, f), atol, FLIP_SHARE, msg=f)
    m = n(want.opac) > 0.5
    assert m.mean() > 0.02  # render_front keeps ~2.6% of the pixels covered
    assert_close_share(n(got.depth)[m], n(want.depth)[m], 10 * atol, FLIP_SHARE, msg="depth")


CFGS = {
    "ascending": dict(),
    "descending": dict(sort_descending=True),
    "render_front": dict(render_front=True),
    "flat_depth": dict(perpix_depth=False, normalize_depth=False),
}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_rasterize_oracle_matches_jax(name):
    jg, tg = make_scenes(40)
    jc, tc = make_cameras()
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    want = joracle.rasterize_oracle(jg, jc, (32, 32), jnp.asarray(bg),
                                    jtypes.RasterConfig(**CFGS[name]), pixel_chunk=256)
    got = toracle.rasterize_oracle(tg, tc, (32, 32), t(bg),
                                   ttypes.RasterConfig(**CFGS[name]), pixel_chunk=256)
    assert got.color.shape == (32, 32, 3) and got.depth.shape == (32, 32)
    assert_images_match(got, want)


def test_oracle_does_not_depend_on_the_chunk(monkeypatch):
    _, tg = make_scenes(40)
    _, tc = make_cameras()
    bg = torch.tensor([0.2, 0.3, 0.4])
    a = toracle.rasterize_oracle(tg, tc, (32, 24), bg, pixel_chunk=4096)
    b = toracle.rasterize_oracle(tg, tc, (32, 24), bg, pixel_chunk=100)
    # A chunk capped from N: 7 pixels at a time.
    monkeypatch.setattr(toracle, "CHUNK_ELEMENTS", 7 * 40)
    c = toracle.rasterize_oracle(tg, tc, (32, 24), bg)
    for f in ("color", "normal", "depth", "opac", "transmittance"):
        assert_close(getattr(b, f), getattr(a, f), 1e-6, msg=f)
        assert_close(getattr(c, f), getattr(a, f), 1e-6, msg=f)


def test_oracle_at_pixels_matches_full_oracle():
    """``rasterize_oracle_at`` is the same chunk renderer at chosen pixels:
    it equals the full image there exactly, and JAX's to 1e-5."""
    cfg = dict(max_per_tile=64, dup_side=4)
    jg, tg = make_scenes(60)
    jc, tc = make_cameras()
    H = W = 64
    bg = np.array([0.1, 0.1, 0.1], np.float32)
    full = toracle.rasterize_oracle(tg, tc, (H, W), t(bg), ttypes.RasterConfig(**cfg),
                                    pixel_chunk=512)
    rng = np.random.RandomState(0)
    xs, ys = rng.randint(0, W, 200), rng.randint(0, H, 200)
    pix = np.stack([xs, ys], -1).astype(np.float32)
    got = toracle.rasterize_oracle_at(tg, tc, (H, W), t(bg), t(pix), ttypes.RasterConfig(**cfg))
    for g, f in zip(got, ("color", "normal", "depth", "opac", "transmittance")):
        np.testing.assert_array_equal(n(g), n(getattr(full, f))[ys, xs], err_msg=f)
    want = joracle.rasterize_oracle_at(jg, jc, (H, W), jnp.asarray(bg), jnp.asarray(pix),
                                       jtypes.RasterConfig(**cfg))
    for g, w, f in zip(got[:2] + got[3:], want[:2] + want[3:], ("color", "normal", "opac", "T")):
        assert_close_share(g, w, 1e-5, FLIP_SHARE, msg=f)


@pytest.mark.parametrize("sort_descending", [False, True])
def test_tiled_matches_oracle(sort_descending):
    cfg = ttypes.RasterConfig(sort_descending=sort_descending, max_per_tile=64, dup_side=4)
    _, tg = make_scenes(60)
    _, tc = make_cameras()
    bg = torch.tensor([0.1, 0.1, 0.1])
    a = toracle.rasterize_oracle(tg, tc, (64, 64), bg, cfg, pixel_chunk=512)
    b = ttiled.rasterize(tg, tc, (64, 64), bg, cfg)
    assert [int(x) for x in b.overflow] == [0, 0]
    assert_close(b.color, a.color, 3e-4)
    assert_close(b.normal, a.normal, 3e-4)
    assert_close(b.opac, a.opac, 3e-4)
    assert_close(b.depth, a.depth, 3e-3)


def test_oracle_gradients_match_jax():
    jg, tg = make_scenes(30)
    jc, tc = make_cameras()
    H = W = 32

    def jloss(means, colors):
        out = joracle.rasterize_oracle(jg._replace(means3d=means, colors=colors), jc, (H, W),
                                       jnp.zeros(3), jtypes.RasterConfig(), pixel_chunk=256)
        return jnp.mean((out.color - 0.5) ** 2) + jnp.mean(out.normal ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(jg.means3d, jg.colors)
    means = tg.means3d.clone().requires_grad_()
    colors = tg.colors.clone().requires_grad_()
    out = toracle.rasterize_oracle(tg._replace(means3d=means, colors=colors), tc, (H, W),
                                   torch.zeros(3), ttypes.RasterConfig(), pixel_chunk=256)
    loss = torch.mean((out.color - 0.5) ** 2) + torch.mean(out.normal ** 2)
    loss.backward()
    for g, w, name in ((means.grad, want[0], "means"), (colors.grad, want[1], "colors")):
        scale = float(np.abs(n(w)).max())
        assert scale > 0 and bool(torch.isfinite(g).all())
        assert_close(g, w, 1e-4 * scale, msg=name)
