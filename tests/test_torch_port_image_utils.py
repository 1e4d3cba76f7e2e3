"""``soar_tpu_torch.render.image_utils`` against ``soar_tpu.render.image_utils``
on the CPU, each of the seven functions on seeded inputs.

Tolerances: boolean outputs exactly (points within 1e-4 of a mask or
frustum edge are left out, where f32 rounding may decide either way);
positions and NDC to 1e-5; the occupancy grid to 1e-5 (a scatter sums in
another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from soar_tpu.core.camera import camera_from_c2w, look_at_c2w
from soar_tpu.render import image_utils as jiu
from soar_tpu_torch.core.camera import Camera
from soar_tpu_torch.render import image_utils as tiu
from torch_port_helpers import n, t


def _cams(num=3, dist=3.0):
    cams = []
    for i in range(num):
        a = 2 * np.pi * i / num + 0.3
        pos = jnp.asarray([dist * np.sin(a), 0.4 * i, dist * np.cos(a)])
        c2w = look_at_c2w(pos, jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
        cams.append(camera_from_c2w(c2w, jnp.asarray(0.7), jnp.asarray(0.6),
                                    prcppoint=jnp.asarray([0.5 + 0.02 * i, 0.48])))
    return cams


def _stack(cams):
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *cams)


def _port(cam):
    return Camera(*(t(np.asarray(x)) for x in cam))


def _points(seed, N=400, r=1.4):
    return (np.random.RandomState(seed).rand(N, 3).astype(np.float32) * 2 - 1) * r


def _masks(seed, C, H, W):
    rng = np.random.RandomState(seed)
    m = np.zeros((C, H, W), np.float32)
    for c in range(C):
        y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
        m[c, y0:y0 + H // 2, x0:x0 + W // 2] = 1.0
    return m


@pytest.mark.parametrize("pad,shape", [(1, (16, 16)), (2, (20, 24)), (3, (12, 12, 1)),
                                       (0, (8, 8))])
def test_contour_padding_matches_jax(pad, shape):
    m = (np.random.RandomState(pad).rand(*shape) > 0.9).astype(np.float32)
    want = np.asarray(jiu.contour_padding(jnp.asarray(m), pad))
    got = n(tiu.contour_padding(t(m), pad))
    np.testing.assert_array_equal(got.astype(bool), want.astype(bool))


def _safe(ndc, px_margin, size):
    """Points not within ``px_margin`` of a frustum or mask edge."""
    return np.all(np.abs(np.abs(ndc) - 1.0) > px_margin, axis=-1)


@pytest.mark.parametrize("with_masks,pad", [(False, 0), (True, 0), (True, 2)])
def test_world2scrn_matches_jax(with_masks, pad):
    H, W = 48, 64
    jc = _cams()
    cams_j, cams_t = _stack(jc), Camera(*(t(np.asarray(x)) for x in _stack(jc)))
    pts = _points(1)
    masks = _masks(2, len(jc), H, W) if with_masks else None
    want = jiu.world2scrn(jnp.asarray(pts), cams_j, None if masks is None else jnp.asarray(masks),
                          (H, W), pad)
    got = tiu.world2scrn(t(pts), cams_t, None if masks is None else t(masks), (H, W), pad)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(n(a), np.asarray(b), rtol=1e-5, atol=1e-5)
    ndc = np.asarray(want[1])
    # Mask lookups floor the pixel coordinate: keep points off pixel borders.
    pix = (ndc + 1.0) / 2.0 * np.array([W, H])
    safe = np.all(np.abs(pix - np.round(pix)) > 1e-3, axis=-1)
    np.testing.assert_array_equal(n(got[2])[safe], np.asarray(want[2])[safe])
    np.testing.assert_array_equal(n(got[3]), np.asarray(want[3]))
    assert safe.mean() > 0.9


@pytest.mark.parametrize("pad", [0, 4])
def test_mask_prune_matches_jax(pad):
    H, W = 40, 40
    jc = _cams(2)
    cams_j, cams_t = _stack(jc), Camera(*(t(np.asarray(x)) for x in _stack(jc)))
    pts = _points(3, 300, 1.0)
    masks = _masks(4, 2, H, W)
    want = np.asarray(jiu.mask_prune(jnp.asarray(pts), cams_j, jnp.asarray(masks), (H, W), pad))
    got = n(tiu.mask_prune(t(pts), cams_t, t(masks), (H, W), pad))
    _, ndc, _, _ = jiu.world2scrn(jnp.asarray(pts), cams_j, None, (H, W))
    pix = (np.asarray(ndc) + 1.0) / 2.0 * np.array([W, H])
    safe = np.all(np.abs(pix - np.round(pix)) > 1e-3, axis=(0, 2))
    np.testing.assert_array_equal(got[safe], want[safe])
    assert 0 < want.sum() < len(want)


@pytest.mark.parametrize("radius,scale", [(1, 8.0), (0, (6.0, 8.0, 10.0)), (2, 5.0)])
def test_occgrid_and_grid_prune_match_jax(radius, scale):
    rng = np.random.RandomState(5)
    pts = rng.rand(500, 3).astype(np.float32)
    op = rng.rand(500).astype(np.float32)
    dims = (8, 9, 10)
    shift = np.array([0.05, -0.02, 0.0], np.float32)
    sc = np.asarray(scale, np.float32)
    want = np.asarray(jiu.gaussian_to_occgrid(jnp.asarray(pts), jnp.asarray(op), dims,
                                              jnp.asarray(shift), jnp.asarray(sc), radius))
    got = n(tiu.gaussian_to_occgrid(t(pts), t(op), dims, t(shift), t(sc), radius))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    q = rng.rand(200, 3).astype(np.float32) * 1.2 - 0.1
    keep_j = np.asarray(jiu.grid_prune(jnp.asarray(want), jnp.asarray(shift), jnp.asarray(sc),
                                       jnp.asarray(q), thrsh=1.0))
    keep_t = n(tiu.grid_prune(t(want), t(shift), t(sc), t(q), thrsh=1.0))
    np.testing.assert_array_equal(keep_t, keep_j)
    assert 0 < keep_j.sum() < len(keep_j)


def test_depth2wpos_and_reproject_match_jax():
    H, W = 24, 32
    jc = _cams(3)
    depth = (2.5 + np.random.RandomState(6).rand(H, W)).astype(np.float32)
    mask = (np.random.RandomState(7).rand(H, W) > 0.3).astype(np.float32)
    want = np.asarray(jiu.depth2wpos(jnp.asarray(depth), jnp.asarray(mask), jc[0], (H, W)))
    got = n(tiu.depth2wpos(t(depth), t(mask), _port(jc[0]), (H, W)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    rest_j = _stack(jc[1:])
    rest_t = Camera(*(t(np.asarray(x)) for x in rest_j))
    ndc_j, vis_j = jiu.reproject_depth(jnp.asarray(depth), jc[0], jnp.asarray(mask), rest_j,
                                       (H, W))
    ndc_t, vis_t = tiu.reproject_depth(t(depth), _port(jc[0]), t(mask), rest_t, (H, W))
    np.testing.assert_allclose(n(ndc_t), np.asarray(ndc_j), rtol=1e-4, atol=1e-4)
    safe = _safe(np.asarray(ndc_j), 1e-4, (H, W))
    np.testing.assert_array_equal(n(vis_t)[safe], np.asarray(vis_j)[safe])
    assert isinstance(got, np.ndarray) and torch.is_tensor(vis_t)
