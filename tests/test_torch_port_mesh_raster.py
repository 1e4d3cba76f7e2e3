"""``soar_tpu_torch.render.mesh_raster`` against ``soar_tpu.render.mesh_raster``
on the CPU: the projection, and front and flipped-back renders of the
procedural body and of the two truncation scenes of
``tests/test_mesh_raster.py``.

Tolerances: the projection to 1e-6; normal, mask and depth equal (normal
and depth to 1e-4) on every pixel but those where the z-test meets a tie
(two candidate faces within 1e-5 of the NDC key, where float rounding of
the edge functions may pick either); at most 1% of the covered pixels are
such ties; the overflow canaries exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from soar_tpu.body import make_test_body as jax_make_test_body
from soar_tpu.render import mesh_raster as jmr
from soar_tpu_torch.render import mesh_raster as tmr
from torch_port_helpers import t

TIE_SHARE = 0.01


def make_K(f, W, H):
    return np.asarray([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("wh,f,cxcy,znear", [((64, 64), 64.0, None, 0.1),
                                              ((96, 80), 120.0, (41.3, 37.9), 0.5),
                                              ((128, 128), 300.0, (70.0, 60.0), 1e-3)])
def test_get_proj_mat_matches_jax(wh, f, cxcy, znear):
    K = make_K(f, *wh)
    if cxcy:
        K[0, 2], K[1, 2] = cxcy
    want = np.asarray(jmr.get_proj_mat(jnp.asarray(K), wh, znear=znear))
    got = tmr.get_proj_mat(t(K), wh, znear=znear).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _stack(n_layers, z0, dz):
    v, f = [], []
    for i in range(n_layers):
        z = z0 + dz * i
        b = len(v)
        v += [[-8.0, -8.0, z], [8.0, -8.0, z], [0.0, 12.0, z]]
        f += [[b, b + 1, b + 2]]
    return np.asarray(v, np.float32), np.asarray(f, np.int32)


def _body_scene(W):
    body = jax_make_test_body(num_joints=4, segments_per_bone=3, ring=8)
    verts = np.asarray(body.v_template) + np.array([0.0, -0.5, 2.0], np.float32)
    return verts, np.asarray(body.faces), make_K(180.0 * W / 96, W, W), (W, W)


def _scene(name):
    if name == "body96":
        v, f, K, wh = _body_scene(96)
        return v, f, K, wh, dict(max_per_tile=96)
    if name == "body128":
        v, f, K, wh = _body_scene(128)
        return v, f, K, wh, {}
    if name == "near_last":  # test_mesh_raster.py::test_truncation_keeps_nearest_faces
        v, f = _stack(12, 5.0, -0.3)
        return v, f, make_K(16.0, 16, 16), (16, 16), dict(max_per_tile=8)
    if name == "far_last":  # ::test_back_surface_truncation_keeps_farthest
        v, f = _stack(12, 1.7, 0.3)
        return v, f, make_K(16.0, 16, 16), (16, 16), dict(max_per_tile=8)
    raise KeyError(name)


def _tie_pixels(verts, faces, proj, w2c, wh):
    """Pixels where two faces covering the pixel centre have NDC keys within
    1e-5: the z-test may pick either under float rounding."""
    W, H = wh
    vh = np.concatenate([verts, np.ones_like(verts[:, :1])], -1).astype(np.float64)
    clip = vh @ (proj.astype(np.float64) @ w2c.astype(np.float64)).T
    ndc = clip[:, :3] / np.maximum(clip[:, 3:4], 1e-8)
    x = ((ndc[:, 0] + 1.0) * W - 1.0) * 0.5
    y = ((ndc[:, 1] + 1.0) * H - 1.0) * 0.5
    X, Y = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    keys = []
    for a, b, c in faces:
        area = (x[b] - x[a]) * (y[c] - y[a]) - (y[b] - y[a]) * (x[c] - x[a])
        if abs(area) < 1e-12:
            continue
        w0 = ((x[b] - X) * (y[c] - Y) - (y[b] - Y) * (x[c] - X)) / area
        w1 = ((x[c] - X) * (y[a] - Y) - (y[c] - Y) * (x[a] - X)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= -1e-6) & (w1 >= -1e-6) & (w2 >= -1e-6)
        keys.append(np.where(inside, w0 * ndc[a, 2] + w1 * ndc[b, 2] + w2 * ndc[c, 2],
                             np.inf))
    keys = np.sort(np.stack(keys), axis=0)
    with np.errstate(invalid="ignore"):
        return np.isfinite(keys[1]) & (keys[1] - keys[0] < 1e-5)


@pytest.mark.parametrize("scene", ["body96", "body128", "near_last", "far_last"])
@pytest.mark.parametrize("side", ["front", "back"])
def test_render_mesh_matches_jax(scene, side):
    verts, faces, K, wh, kw = _scene(scene)
    proj = np.array(jmr.get_proj_mat(jnp.asarray(K), wh))
    if side == "back":
        proj[2] *= -1.0  # the far-surface pass of compute_normal
    w2c = np.eye(4, dtype=np.float32)
    want = jmr.render_mesh(jnp.asarray(verts), jnp.asarray(faces), jnp.asarray(w2c),
                           jnp.asarray(proj), wh, **kw)
    got = tmr.render_mesh(t(verts), t(faces), t(w2c), t(proj), wh, **kw)
    np.testing.assert_array_equal(got["overflow"].numpy(), np.asarray(want["overflow"]))
    ties = _tie_pixels(verts, faces, proj, w2c, wh)
    wm = np.asarray(want["mask"])[..., 0]
    assert ties.sum() <= TIE_SHARE * max(wm.sum(), 1.0) + 2
    keep = ~ties
    np.testing.assert_array_equal(got["mask"].numpy()[..., 0][keep], wm[keep])
    np.testing.assert_allclose(got["normal"].numpy()[keep], np.asarray(want["normal"])[keep],
                               atol=1e-4)
    np.testing.assert_allclose(got["depth"].numpy()[keep], np.asarray(want["depth"])[keep],
                               rtol=1e-4, atol=1e-4)
    if scene == "body96":
        assert 0.02 < wm.mean() < 0.9
    if scene in ("near_last", "far_last"):
        # The truncation keeps the faces the pass's z-test needs, in both
        # packages: the overflow counts the dropped entries.
        assert int(want["overflow"][0]) > 0


def test_vertex_normals_match_jax():
    body = jax_make_test_body(num_joints=4, segments_per_bone=3, ring=8)
    verts = np.asarray(body.v_template)
    want = np.asarray(jmr._vertex_normals(jnp.asarray(verts), body.faces))
    got = tmr._vertex_normals(t(verts), t(body.faces).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
