"""The surfel preprocess's CUDA kernel (``csrc/preprocess.cu``) against the
plain PyTorch version (``render.preprocess.preprocess_plain``), and which
calls it takes.

This file imports neither JAX nor soar_tpu, so it also runs where only the
port is installed; ``tests/data/preprocess_jax.npz`` holds soar_tpu's
forward and gradients on the cases of ``torch_port_helpers.prep_jax_case``
(``test_torch_port_render.py`` checks them against soar_tpu on the CPU).
On a machine with a GPU:

    python -m pytest tests/test_torch_port_preprocess_kernel.py --noconftest -q

Without a GPU the ``cuda`` tests skip (a CUDA kernel has no CPU mode) and
the rest run: the plain path's counter, which calls the kernel refuses, the
launch structure against the kernel's source, and a plain-torch model of the
kernel's hand-derived backward held against autograd of the plain version on
the edge cases, in float64.

Tolerances on the card, and why:

- ``valid`` and ``radius`` are equal but for surfels whose plain value sits
  on a threshold (a cull's bound, a ceil's integer) within float32 rounding:
  at most ``THRESHOLD_SHARE`` of them, and each such radius one apart.
- The float outputs agree to float32 rounding of the chain, relative to
  each field's scale (``FWD_RTOL``); the conic is divided by
  ``det = a c - b^2``, whose cancellation turns an ulp of cov2d into
  ``(a c + b^2) / det`` ulps, so its entries are held to that condition
  number times ``FWD_RTOL``.
- The gradients come from a hand-derived chain rule in a different order of
  float32 operations than autograd's: each input's gradient is held to
  ``GRAD_RTOL`` of its norm (relative L2), and each entry to ``GRAD_RTOL``
  of its own column's largest magnitude times the surfel's conic condition
  number.  They are compared for cotangents that are zero on the culled
  surfels, as the renderer's gathers give them: a culled surfel may sit
  edge-on to its view ray, where the homography divides by a projection
  near zero and two float32 orders of the same chain part by percents.
  With cotangents on every surfel the gradients are held finite.
"""

import ctypes
import dataclasses
import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from soar_tpu_torch.avatar.renderer import RenderSettings
from soar_tpu_torch.core.camera import Camera, camera_from_c2w, focal_from_fov, \
    look_at_c2w, projection_matrix
from soar_tpu_torch.core.transforms import quat_to_rotmat
from soar_tpu_torch.render import preprocess as pp
from soar_tpu_torch.render.types import GaussianInputs, RasterConfig
from soar_tpu_torch.train.systems import DreamerConfig
from soar_tpu_torch.train.trainer import make_train_step
from torch_port_helpers import (
    PREP_CAMERA,
    PREP_FIELDS,
    PREP_JAX_CASES,
    PREP_JAX_FILE,
    PREP_SIZE,
    assert_preprocess_matches_record,
    prep_jax_case,
    prep_masked_cot,
)

SOURCE = Path(pp.__file__).resolve().parents[1] / "csrc" / "preprocess.cu"
FIELDS = ("xy", "depth", "conic", "normal_view", "view_dot", "jinv")

# Variants of the kernel the tests drive: every flag combination the cells
# and CLIs use (surface and per-pixel depth, render_front off; the dreamer's
# volume Gaussians) and the rest.
CONFIGS = {
    "default": RasterConfig(),
    "front": RasterConfig(render_front=True),
    "no_perpix": RasterConfig(perpix_depth=False),
    "dreamer": DreamerConfig().raster,
    "volume": RasterConfig(surface=False),
    "volume_front": RasterConfig(surface=False, render_front=True, scale_modifier=1.5),
    # Zero scales with no low-pass: det = 0 on those surfels.
    "det0": RasterConfig(low_pass=0.0),
}

FWD_RTOL = 1e-6
GRAD_RTOL = 2e-5
THRESHOLD_SHARE = 1e-5


def _counts():
    return pp.preprocess.kernel, pp.preprocess.kernel_bwd, pp.preprocess.eager


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def axis_camera(size, dtype=torch.float64, fov=0.7, prcp=(0.53, 0.46)):
    """A camera looking down +z with no rotation (w2c a translation), so
    that a surfel on the optical axis whose normal is the x axis meets the
    grazing test's exact zero; principal point off centre."""
    H, W = size
    fovx = torch.tensor(fov, dtype=torch.float32)
    fovy = torch.tensor(2.0 * math.atan(math.tan(fov / 2) * H / W), dtype=torch.float32)
    w2c = torch.eye(4)
    w2c[2, 3] = 3.0
    P = projection_matrix(0.1, 100.0, fovx, fovy)
    return Camera(fovx=fovx.to(dtype), fovy=fovy.to(dtype), w2c=w2c.to(dtype),
                  full_proj=(P @ w2c).to(dtype), campos=torch.zeros(3, dtype=dtype),
                  prcppoint=torch.tensor(prcp, dtype=dtype))


def orbit_camera(size, dtype=torch.float64, seed=0):
    """A camera on a seeded orbit around the origin, looking at it."""
    gen = torch.Generator().manual_seed(seed)
    az, el = 2 * math.pi * torch.rand((), generator=gen), 0.4 * torch.rand((), generator=gen)
    d = 2.2 + torch.rand((), generator=gen)
    pos = torch.stack([d * torch.cos(el) * torch.sin(az), d * torch.sin(el),
                       d * torch.cos(el) * torch.cos(az)])
    c2w = look_at_c2w(pos, torch.zeros(3), torch.tensor([0.0, 1.0, 0.0]))
    fov = 0.6 + 0.3 * float(torch.rand((), generator=gen))
    cam = camera_from_c2w(c2w, fov, fov, znear=0.1, zfar=100.0)
    return Camera(*(x.to(dtype) for x in cam))


def body_surfels(n, seed, dtype=torch.float32, device="cpu"):
    """``n`` surfels spread over a body-sized box around the origin:
    unit quaternions, scales log-normal around a centimetre."""
    gen = torch.Generator().manual_seed(seed)
    means = (torch.rand((n, 3), generator=gen) - 0.5) * torch.tensor([0.8, 1.8, 0.6])
    quats = torch.randn((n, 4), generator=gen)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    s = torch.exp(math.log(0.01) + 0.6 * torch.randn((n, 1), generator=gen))
    scales = torch.cat([s, s * (0.5 + torch.rand((n, 1), generator=gen)),
                        torch.rand((n, 1), generator=gen) * s], -1)
    g = GaussianInputs(means3d=means, quats=quats, scales=scales,
                       opacities=torch.rand((n,), generator=gen),
                       colors=torch.rand((n, 3), generator=gen))
    return GaussianInputs(*(x.to(dtype=dtype, device=device) for x in g))


def edge_surfels(camera, n=400, seed=0, dtype=torch.float64):
    """Surfels in front of ``axis_camera`` (world z = view z - 3) with the
    edge cases among them: depths between 0 and the near plane, at 0 and
    behind the camera; points beyond the EWA clamp's 1.3 tan(fov / 2) but
    inside the frustum's border; on-axis surfels whose normal is the x axis
    (the grazing cull, and |prj| < 1e-12 in the homography); zero scales
    (det = 0 with no low-pass)."""
    gen = torch.Generator().manual_seed(seed)
    tanx = math.tan(float(camera.fovx) / 2)
    z = 1.0 + 3.0 * torch.rand((n,), generator=gen)
    lateral = (2 * torch.rand((n, 2), generator=gen) - 1) * z[:, None] * tanx
    quats = torch.randn((n, 4), generator=gen)
    quats = quats / quats.norm(dim=-1, keepdim=True)
    scales = torch.exp(math.log(0.02) + 0.5 * torch.randn((n, 3), generator=gen))
    z[0:6] = torch.tensor([0.05, 0.0, -0.3, -2.0, 0.1, 0.0999])
    k = torch.arange(6, 14)
    lateral[k, 0] = (1.3 + 0.09 * (k - 5) / 8.0) * tanx * z[k] * torch.where(k % 2 == 0, 1, -1)
    lateral[k, 1] = 0.1 * z[k]
    lateral[14:20] = 0.0
    quats[14:20] = 0.5  # R[:, 2] = (1, 0, 0): edge-on to the axis
    quats[20:22] = torch.tensor([1.0, 0.0, 0.0, 0.0])  # back-facing: normal +z
    quats[22:24] = torch.tensor([0.0, 1.0, 0.0, 0.0])  # front-facing: normal -z
    scales[24:30] = 0.0
    means = torch.cat([lateral, (z - 3.0)[:, None]], -1)
    return GaussianInputs(means3d=means.to(dtype), quats=quats.to(dtype),
                          scales=scales.to(dtype),
                          opacities=torch.rand((n,), generator=gen).to(dtype),
                          colors=torch.rand((n, 3), generator=gen).to(dtype))


def _cotangents(N, seed, dtype, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    widths = {"xy": 2, "depth": 1, "conic": 3, "normal_view": 3, "view_dot": 1, "jinv": 10}
    return {k: torch.randn((N, w) if w > 1 else (N,), generator=gen).to(dtype=dtype,
                                                                         device=device)
            for k, w in widths.items()}


def plain_vjp(g, camera, size, cfg, cot):
    """Autograd of the plain version: the means', quaternions' and scales'
    gradients for the cotangents ``cot``."""
    leaves = [x.detach().clone().requires_grad_() for x in g[:3]]
    pre = pp.preprocess_plain(GaussianInputs(*leaves, *g[3:]), camera, size, cfg)
    loss = sum((getattr(pre, k) * cot[k]).sum() for k in FIELDS if getattr(pre, k).requires_grad)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if d is None else d for x, d in zip(leaves, grads)]


def vjp_model(g, camera, size, cfg, cot):
    """The kernel's backward in plain torch: ``preprocess_bwd``'s
    hand-derived chain rule, step for step, on columns of N surfels."""
    H, W = size
    m, q = g.means3d, g.quats
    P, V = camera.full_proj, camera.w2c
    V3 = V[:3, :3]
    tanx, tany = torch.tan(camera.fovx * 0.5), torch.tan(camera.fovy * 0.5)
    fx, fy = focal_from_fov(camera.fovx, W), focal_from_fov(camera.fovy, H)
    scale = (fx + fy) / 2.0 / 1000.0
    near = cfg.near
    mh = torch.cat([m, torch.ones_like(m[:, :1])], -1)
    hom0, hom1, hom3 = mh @ P[0], mh @ P[1], mh @ P[3]
    pw = 1.0 / (hom3 + 1e-7)
    pv = mh @ V[:3].T
    zs = torch.where(pv[:, 2] >= near, pv[:, 2], near)
    R = quat_to_rotmat(q)
    gpv = torch.zeros_like(pv)
    gR = torch.zeros_like(R)

    # ---- conic <- cov2d <- (J, Sigma)
    s = g.scales * cfg.scale_modifier
    if cfg.surface:
        s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], -1)
    RS = R * s[:, None, :]
    cov3 = RS @ RS.transpose(-1, -2)
    tz = zs
    lim_x, lim_y = tanx * 1.3, tany * 1.3
    rx, ry = pv[:, 0] / tz, pv[:, 1] / tz
    cx, cy = torch.clamp(rx, -lim_x, lim_x), torch.clamp(ry, -lim_y, lim_y)
    tx, ty = cx * tz, cy * tz
    tz2 = tz * tz
    J00, J11 = fx / tz, fy / tz
    J02, J12 = -fx * tx / tz2, -fy * ty / tz2
    zero = torch.zeros_like(tz)
    J = torch.stack([torch.stack([J00, zero, J02], -1), torch.stack([zero, J11, J12], -1)], -2)
    JW = J @ V3
    T = JW @ cov3
    C = T @ JW.transpose(-1, -2)
    a, b, c = C[:, 0, 0] + cfg.low_pass, C[:, 0, 1], C[:, 1, 1] + cfg.low_pass
    det = a * c - b * b
    dinv = 1.0 / torch.where(det == 0, 1.0, det)
    gc0, gc1, gc2 = cot["conic"].unbind(-1)
    ga, gb, gc = gc2 * dinv, -gc1 * dinv, gc0 * dinv
    gdinv = gc0 * c - gc1 * b + gc2 * a
    gdet = torch.where(det != 0, -gdinv * dinv * dinv, 0.0)
    ga, gc, gb = ga + gdet * c, gc + gdet * a, gb - 2.0 * b * gdet
    gC = torch.stack([torch.stack([ga, gb], -1), torch.stack([zero, gc], -1)], -2)
    gT = gC @ JW
    gJW = gC.transpose(-1, -2) @ T + gT @ cov3.transpose(-1, -2)
    gcov = JW.transpose(-1, -2) @ gT
    gJ = gJW @ V3.T
    gtz = -gJ[:, 0, 0] * J00 / tz - gJ[:, 1, 1] * J11 / tz
    gtz2 = -(gJ[:, 0, 2] * J02 + gJ[:, 1, 2] * J12) / tz2
    gtx, gty = -fx * (gJ[:, 0, 2] / tz2), -fy * (gJ[:, 1, 2] / tz2)
    gtz = gtz + 2.0 * tz * gtz2 + gtx * cx + gty * cy
    grx = torch.where((rx >= -lim_x) & (rx <= lim_x), gtx * tz, 0.0)
    gry = torch.where((ry >= -lim_y) & (ry <= lim_y), gty * tz, 0.0)
    gpv[:, 0] += grx / tz
    gpv[:, 1] += gry / tz
    gzs = gtz - (grx * rx + gry * ry) / tz
    gRS = (gcov + gcov.transpose(-1, -2)) @ RS
    gR = gR + gRS * s[:, None, :]
    gs = (gRS * R).sum(-2) * cfg.scale_modifier
    if cfg.surface:
        gs = torch.cat([gs[:, :2], torch.zeros_like(gs[:, 2:])], -1)

    # ---- normal, view_dot and the local homography <- the view axes
    if cfg.surface:
        n, u0, u1 = R[:, :, 2] @ V3.T, R[:, :, 0] @ V3.T, R[:, :, 1] @ V3.T
        gvd = cot["view_dot"]
        gn = cot["normal_view"] + gvd[:, None] * pv
        gpv = gpv + gvd[:, None] * n
        gu0, gu1 = torch.zeros_like(u0), torch.zeros_like(u1)
        if cfg.perpix_depth:
            p = torch.stack([pv[:, 0], pv[:, 1], zs], -1)
            px, py = p[:, 0] / p[:, 2], p[:, 1] / p[:, 2]
            one = torch.ones_like(px)
            v0 = torch.stack([px + 0.001, py, one], -1)
            v1 = torch.stack([px, py + 0.001, one], -1)
            mod0 = torch.clamp_min(v0.norm(dim=-1), 1e-8)
            mod1 = torch.clamp_min(v1.norm(dim=-1), 1e-8)
            d0, d1 = v0 / mod0[:, None], v1 / mod1[:, None]
            prj0, prj1 = (d0 * n).sum(-1), (d1 * n).sum(-1)
            tt = (p * n).sum(-1)
            sp0 = torch.where(prj0.abs() < 1e-12, 1e-12, prj0)
            sp1 = torch.where(prj1.abs() < 1e-12, 1e-12, prj1)
            t0, t1 = tt / sp0, tt / sp1
            xu0, xu1 = d0 * t0[:, None] - p, d1 * t1[:, None] - p
            gj = cot["jinv"]
            ge00, ge01, ge10, ge11 = (gj[:, k] / scale for k in range(4))
            gxu0 = ge00[:, None] * u0 + ge10[:, None] * u1
            gxu1 = ge01[:, None] * u0 + ge11[:, None] * u1
            gu0 = gu0 + ge00[:, None] * xu0 + ge01[:, None] * xu1 + gj[:, 4:7]
            gu1 = gu1 + ge10[:, None] * xu0 + ge11[:, None] * xu1 + gj[:, 7:10]
            gp = -(gxu0 + gxu1)
            gd0, gd1 = gxu0 * t0[:, None], gxu1 * t1[:, None]
            gt0, gt1 = (gxu0 * d0).sum(-1), (gxu1 * d1).sum(-1)
            gtt = gt0 / sp0 + gt1 / sp1
            gprj0 = torch.where(prj0.abs() < 1e-12, 0.0, -gt0 * t0 / sp0)
            gprj1 = torch.where(prj1.abs() < 1e-12, 0.0, -gt1 * t1 / sp1)
            gp = gp + gtt[:, None] * n
            gn = gn + gtt[:, None] * p + gprj0[:, None] * d0 + gprj1[:, None] * d1
            gd0 = gd0 + gprj0[:, None] * n
            gd1 = gd1 + gprj1[:, None] * n
            gm0 = torch.where(mod0 >= 1e-8, -(gd0 * v0).sum(-1) / mod0**3, 0.0)
            gm1 = torch.where(mod1 >= 1e-8, -(gd1 * v1).sum(-1) / mod1**3, 0.0)
            gv0 = gd0 / mod0[:, None] + gm0[:, None] * v0
            gv1 = gd1 / mod1[:, None] + gm1[:, None] * v1
            gpx, gpy = gv0[:, 0] + gv1[:, 0], gv0[:, 1] + gv1[:, 1]
            gpv[:, 0] += gp[:, 0] + gpx / p[:, 2]
            gpv[:, 1] += gp[:, 1] + gpy / p[:, 2]
            gzs = gzs + gp[:, 2] - (gpx * px + gpy * py) / p[:, 2]
        gR = gR + torch.stack([gu0 @ V3, gu1 @ V3, gn @ V3], -1)

    # ---- the view-space position and the projection <- the mean
    gpv[:, 2] += cot["depth"] + torch.where(pv[:, 2] >= near, gzs, 0.0)
    gprx, gpry = cot["xy"][:, 0] * (W * 0.5), cot["xy"][:, 1] * (H * 0.5)
    ghom0, ghom1 = gprx * pw, gpry * pw
    ghom3 = -(gprx * hom0 + gpry * hom1) * pw * pw
    gm = (gpv @ V[:3, :3] + ghom0[:, None] * P[0, :3] + ghom1[:, None] * P[1, :3]
          + ghom3[:, None] * P[3, :3])

    # ---- the rotation <- the quaternion
    r, x, y, z = q.unbind(-1)
    G = gR
    gq = torch.stack([
        2 * (-G[:, 0, 1] * z + G[:, 0, 2] * y + G[:, 1, 0] * z - G[:, 1, 2] * x
             - G[:, 2, 0] * y + G[:, 2, 1] * x),
        2 * (G[:, 0, 1] * y + G[:, 0, 2] * z + G[:, 1, 0] * y - G[:, 1, 2] * r
             + G[:, 2, 0] * z + G[:, 2, 1] * r) - 4 * x * (G[:, 1, 1] + G[:, 2, 2]),
        2 * (G[:, 0, 1] * x + G[:, 0, 2] * r + G[:, 1, 0] * x + G[:, 1, 2] * z
             - G[:, 2, 0] * r + G[:, 2, 1] * z) - 4 * y * (G[:, 0, 0] + G[:, 2, 2]),
        2 * (-G[:, 0, 1] * r + G[:, 0, 2] * x + G[:, 1, 0] * r + G[:, 1, 2] * y
             + G[:, 2, 0] * x + G[:, 2, 1] * y) - 4 * z * (G[:, 0, 0] + G[:, 1, 1]),
    ], -1)
    return [gm, gq, gs]


def edge_case(config, dtype=torch.float64):
    cfg = CONFIGS[config]
    size = (96, 128)
    cam = axis_camera(size, dtype)
    g = edge_surfels(cam, dtype=dtype)
    if config == "det0":
        g = g._replace(scales=torch.where(torch.arange(len(g.scales))[:, None] % 7 == 0, 0.0,
                                          g.scales))
    return g, cam, size, cfg


# --------------------------------------------------------------- on the CPU


def test_cpu_calls_take_the_plain_path_and_count_it():
    g, cam, size, cfg = edge_case("default", torch.float32)
    before = _counts()
    got = pp.preprocess(g, cam, size, cfg)
    assert _counts() == (before[0], before[1], before[2] + 1)
    want = pp.preprocess_plain(g, cam, size, cfg)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_which_calls_may_launch_the_kernel():
    """What a CUDA call's tensors must be (checked here on CPU tensors)."""
    g, cam, _, _ = edge_case("default", torch.float32)
    assert pp.refusal(g, cam) is None
    assert "float32" in pp.refusal(g._replace(quats=g.quats.double()), cam)
    assert "float32" in pp.refusal(g._replace(scales=g.scales.half()), cam)
    assert "not contiguous" in pp.refusal(g._replace(means3d=g.means3d.T.contiguous().T), cam)
    wide = torch.cat([g.means3d, g.means3d], -1)
    assert pp.refusal(g._replace(means3d=wide[:, 1:4]), cam) is None  # rows strided
    assert "shape" in pp.refusal(g._replace(scales=g.scales[:, :2]), cam)
    assert "camera w2c" in pp.refusal(g, cam._replace(w2c=cam.w2c.T))
    assert "camera fovx" in pp.refusal(g, cam._replace(fovx=cam.fovx.double()))
    grad_cam = cam._replace(full_proj=cam.full_proj.clone().requires_grad_())
    assert "needs a gradient" in pp.refusal(g, grad_cam)
    with torch.no_grad():
        assert pp.refusal(g, grad_cam) is None


@pytest.mark.parametrize("config,want", [("default", 3), ("front", 7), ("no_perpix", 1),
                                         ("dreamer", 0), ("volume", 0), ("volume_front", 0)])
def test_launch_flags(config, want):
    """Without surface, per-pixel depth and render_front act on nothing:
    every volume config takes the one volume kernel."""
    assert pp.launch_flags(CONFIGS[config]) == want


def test_the_launch_struct_is_the_kernels():
    """``_Args`` names the fields of csrc/preprocess.cu's ``PreprocessArgs``
    in its order, with C's sizes."""
    body = re.search(r"struct PreprocessArgs \{(.*?)\n\};", SOURCE.read_text(), re.S).group(1)
    names = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        decl = decl.strip()
        if decl:
            names += [re.sub(r"^.*[\s*]", "", part.strip()) for part in decl.split(",")]
    assert names == [name for name, _ in pp._Args._fields_]
    assert ctypes.sizeof(pp._Args) == 25 * 8 + 9 * 8 + 3 * 4 + 7 * 4


@pytest.mark.parametrize("config", list(CONFIGS))
def test_backward_model_matches_plain_autograd(config):
    """The hand-derived chain rule (the model of the kernel's backward)
    against autograd of the plain version in float64, on the edge cases,
    with random cotangents on every output; the culled surfels' gradients
    are finite in both."""
    g, cam, size, cfg = edge_case(config)
    cot = _cotangents(g.means3d.shape[0], 3, torch.float64)
    want = plain_vjp(g, cam, size, cfg, cot)
    got = vjp_model(g, cam, size, cfg, cot)
    pre = pp.preprocess_plain(g, cam, size, cfg)
    assert not bool(pre.valid[:30].all()) and bool(pre.valid[30:].any())
    for name, a, b in zip(("means3d", "quats", "scales"), got, want):
        assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
        tol = 1e-9 * b.abs().amax(-1, keepdim=True) + 1e-12
        assert torch.all((a - b).abs() <= tol), (name, float((a - b).abs().max()))
    if cfg.surface and cfg.perpix_depth:
        # The homography's safe division took its branch on the on-axis
        # surfels, and the clamp and the near plane their bounds.
        n_view = quat_to_rotmat(g.quats)[:, :, 2] @ cam.w2c[:3, :3].T
        assert torch.equal(n_view[14:20], torch.tensor([[1.0, 0.0, 0.0]] * 6,
                                                       dtype=torch.float64))
    if config == "det0":
        det0 = (pre.conic[:, 0] == 0) & (pre.conic[:, 2] == 0)
        assert bool(det0.any()) and not bool(pre.valid[det0].any())


# --------------------------------------------------------------- on the card


def _cells_cameras(device):
    """Cameras as the cells draw them: a gen view at 256^2 (fovx = fovy,
    camera_from_c2w), the GT camera at 512^2 with an off-centre principal
    point, a novel-pose camera at 512^2."""
    gen = orbit_camera((256, 256), torch.float32, seed=1)
    gt = camera_from_c2w(look_at_c2w(torch.tensor([0.3, 0.2, 2.6]), torch.zeros(3),
                                     torch.tensor([0.0, 1.0, 0.0])), 0.52, 0.52,
                         prcppoint=torch.tensor([0.512, 0.487]))
    novel = orbit_camera((512, 512), torch.float32, seed=2)
    return {"gen": (gen, (256, 256)), "gt": (gt, (512, 512)), "novel": (novel, (512, 512))}


def _to(cam, device):
    return Camera(*(x.to(device) for x in cam))


def _conic_condition(pre):
    """(a c + b^2) / det of each surfel's cov2d, from its conic."""
    c0, c1, c2 = pre.conic.unbind(-1)
    return ((c0 * c2 + c1 * c1) / (c0 * c2 - c1 * c1).abs()).nan_to_num(1.0, 1.0, 1.0)


def assert_forward_close(got, want, label):
    """``valid`` and ``radius`` equal but on thresholds; the float fields to
    float32 rounding of the chain (the conic times its condition number)."""
    N = want.valid.shape[0]
    off = (got.valid != want.valid) | (got.radius != want.radius)
    assert int(off.sum()) <= max(2, THRESHOLD_SHARE * N), (label, int(off.sum()))
    assert torch.all((got.radius - want.radius).abs()[off] <= 1), label
    keep = want.valid & got.valid
    cond = _conic_condition(want).clamp_min(1.0)
    for k in FIELDS:
        a, b = getattr(got, k)[keep], getattr(want, k)[keep]
        scale = b.abs().amax(0, keepdim=True).clamp_min(1e-30)
        tol = FWD_RTOL * scale
        if k == "conic":
            tol = tol * cond[keep][:, None]
        err = (a - b).abs()
        assert torch.all(err <= tol), (label, k, float((err / scale).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [125_664, 167_014, 251_328])
def test_kernel_forward_matches_plain(n):
    dev = _cuda()
    g = body_surfels(n, seed=n, device=dev)
    for name, (cam, size) in _cells_cameras(dev).items():
        cam = _to(cam, dev)
        before = pp.preprocess.kernel
        got = pp.preprocess(g, cam, size, RasterConfig())
        assert pp.preprocess.kernel == before + 1
        want = pp.preprocess_plain(g, cam, size, RasterConfig())
        assert got.valid.dtype == torch.bool and got.xy.shape == (n, 2)
        assert 0.05 * n < int(want.valid.sum()) < n, name
        assert_forward_close(got, want, f"N={n} {name}")


def _grads_close(got, want, cond, label):
    for name, a, b in zip(("means3d", "quats", "scales"), got, want):
        assert torch.isfinite(a).all(), (label, name)
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        assert rel <= GRAD_RTOL, (label, name, rel)
        tol = GRAD_RTOL * b.abs().amax(0, keepdim=True) * cond[:, None]
        assert torch.all((a - b).abs() <= tol), (label, name)


def _masked(cot, valid):
    """The cotangents with the culled surfels' rows zeroed, as the
    renderer's ``pack_surfels`` hands them back."""
    return {k: v * valid.reshape(-1, *([1] * (v.dim() - 1))) for k, v in cot.items()}


def _kernel_vjp(g, cam, size, cfg, cot):
    leaves = [x.detach().clone().requires_grad_() for x in g[:3]]
    pre = pp.preprocess(GaussianInputs(*leaves, *g[3:]), cam, size, cfg)
    loss = sum((getattr(pre, k) * cot[k]).sum() for k in FIELDS)
    return list(torch.autograd.grad(loss, leaves))


@pytest.mark.cuda
@pytest.mark.parametrize("camera", ["gen", "gt"])
def test_kernel_gradients_match_plain_autograd(camera):
    dev = _cuda()
    n = 125_664
    g = body_surfels(n, seed=5, device=dev)
    cam, size = _cells_cameras(dev)[camera]
    cam = _to(cam, dev)
    cfg = RasterConfig()
    pre = pp.preprocess_plain(g, cam, size, cfg)
    cot = _cotangents(n, 6, torch.float32, dev)
    before = _counts()
    assert all(bool(torch.isfinite(x).all()) for x in _kernel_vjp(g, cam, size, cfg, cot))
    assert _counts() == (before[0] + 1, before[1] + 1, before[2])
    cot = _masked(cot, pre.valid)
    got = _kernel_vjp(g, cam, size, cfg, cot)
    want = plain_vjp(g, cam, size, cfg, cot)
    _grads_close(got, want, _conic_condition(pre).clamp_min(1.0), camera)


@pytest.mark.cuda
@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_edge_cases_match_plain(config):
    """The edge cases in float32 on the card: forward as plain, gradients
    as autograd's and as the model's, finite on culled surfels."""
    dev = _cuda()
    g, cam, size, cfg = edge_case(config, torch.float32)
    g, cam = GaussianInputs(*(x.to(dev) for x in g)), _to(cam, dev)
    got = pp.preprocess(g, cam, size, cfg)
    want = pp.preprocess_plain(g, cam, size, cfg)
    assert_forward_close(got, want, config)
    assert torch.equal(got.valid[:30], want.valid[:30])
    cot = _cotangents(g.means3d.shape[0], 7, torch.float32, dev)
    # Cotangents on every surfel, the culled ones too: finite gradients.
    for grad in _kernel_vjp(g, cam, size, cfg, cot):
        assert torch.isfinite(grad).all()
    cot = _masked(cot, want.valid)
    k = _kernel_vjp(g, cam, size, cfg, cot)
    cond = _conic_condition(want).clamp_min(1.0)
    _grads_close(k, plain_vjp(g, cam, size, cfg, cot), cond, config)
    _grads_close(k, vjp_model(g, cam, size, cfg, cot), cond, config + " model")
    for grad in k:  # a culled surfel's rows get no gradient
        assert not bool(grad[~want.valid].any())


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PREP_JAX_CASES))
def test_kernel_matches_soar_tpu_recorded_on_the_cpu(case):
    """The kernel's forward and its means', quaternions' and scales'
    gradients against soar_tpu's and jax.grad's, as
    ``tests/data/preprocess_jax.npz`` records them (the tolerances of
    ``torch_port_helpers.assert_preprocess_matches_record``: float32
    round-off of the chain, scaled by the conic's conditioning)."""
    dev = _cuda()
    rec = np.load(PREP_JAX_FILE)
    means, quats, scales, cot = prep_jax_case()
    cam = Camera(*(torch.from_numpy(rec[f"camera_{k}"]).to(dev) for k in PREP_CAMERA))
    leaves = [torch.from_numpy(a).to(dev).requires_grad_() for a in (means, quats, scales)]
    N = means.shape[0]
    g = GaussianInputs(*leaves, torch.ones(N, device=dev), torch.zeros((N, 3), device=dev))
    before = _counts()
    pre = pp.preprocess(g, cam, PREP_SIZE, RasterConfig(**PREP_JAX_CASES[case]))
    masked = prep_masked_cot(cot, rec[f"{case}_valid"])
    loss = sum((getattr(pre, f) * torch.from_numpy(masked[f]).to(dev)).sum()
               for f in PREP_FIELDS)
    grads = torch.autograd.grad(loss, leaves)
    assert _counts() == (before[0] + 1, before[1] + 1, before[2])
    assert_preprocess_matches_record(pre, grads, rec, case, case)


@pytest.mark.cuda
def test_kernel_takes_strided_rows_and_cotangents():
    """Inputs and cotangents whose rows sit in wider tensors (as
    ``pack_surfels``' backward hands them over) give what contiguous ones
    give, to the bit."""
    dev = _cuda()
    g = body_surfels(5000, seed=8, device=dev)
    cam, size = _cells_cameras(dev)["gt"]
    cam = _to(cam, dev)
    wide = torch.cat([g.means3d, g.quats, g.scales], -1)
    strided = g._replace(means3d=wide[:, 0:3], quats=wide[:, 3:7], scales=wide[:, 7:10])
    cot = _cotangents(5000, 9, torch.float32, dev)
    packed = torch.cat([cot[k].reshape(5000, -1) for k in FIELDS], -1)
    cuts = torch.tensor([0, 2, 3, 6, 9, 10, 20]).tolist()
    cot_strided = {k: packed[:, a:b].reshape(cot[k].shape) if cot[k].dim() == 2 else packed[:, a]
                   for k, a, b in zip(FIELDS, cuts, cuts[1:])}
    a = pp.preprocess(g, cam, size, RasterConfig())
    b = pp.preprocess(strided, cam, size, RasterConfig())
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for x, y in zip(_kernel_vjp(g, cam, size, RasterConfig(), cot),
                    _kernel_vjp(strided, cam, size, RasterConfig(), cot_strided)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_a_captured_preprocess_replays_equal_to_eager():
    """Forward and backward captured into one CUDA graph replay what eager
    calls give, to the bit, for new surfels and a new camera written into
    the captured tensors."""
    dev = _cuda()
    n = 20_000
    cams = _cells_cameras(dev)
    (cam_a, size), (cam_b, _) = cams["gt"], cams["novel"]
    cam = Camera(*(x.to(dev).clone() for x in cam_a))
    g = body_surfels(n, seed=10, device=dev)
    leaves = [x.clone().requires_grad_() for x in g[:3]]
    cot = _cotangents(n, 11, torch.float32, dev)
    cfg = RasterConfig()

    def step():
        pre = pp.preprocess(GaussianInputs(*leaves, *g[3:]), cam, size, cfg)
        loss = sum((getattr(pre, k) * cot[k]).sum() for k in FIELDS)
        return (pre, *torch.autograd.grad(loss, leaves))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    with torch.cuda.graph(graph):
        static = step()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2])
    g2 = body_surfels(n, seed=12, device=dev)
    with torch.no_grad():
        for leaf, new in zip(leaves, g2[:3]):
            leaf.copy_(new)
        for mine, new in zip(cam, cam_b):
            mine.copy_(new.to(dev))
    graph.replay()
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 1, before[1] + 1, before[2])
    eager = step()
    for x, y in zip(static[0], eager[0]):
        assert torch.equal(x, y)
    for x, y in zip(static[1:], eager[1:]):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_a_call_the_kernel_is_not_built_for_raises(dtype):
    dev = _cuda()
    g = body_surfels(1000, seed=13, dtype=dtype, device=dev)
    cam, size = _cells_cameras(dev)["gen"]
    before = _counts()
    with pytest.raises(NotImplementedError, match="float32"):
        pp.preprocess(g, _to(cam, dev), size, RasterConfig())
    assert _counts() == before


@pytest.mark.cuda
def test_the_kernel_launches_on_the_current_stream_without_a_host_sync():
    dev = _cuda()
    g = body_surfels(4000, seed=14, device=dev)
    cam, size = _cells_cameras(dev)["gen"]
    cam = _to(cam, dev)
    cot = _cotangents(4000, 15, torch.float32, dev)
    _kernel_vjp(g, cam, size, RasterConfig(), cot)  # loads the library
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            grads = _kernel_vjp(g, cam, size, RasterConfig(), cot)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.current_stream().wait_stream(side)
    assert all(bool(torch.isfinite(x).all()) for x in grads)


def test_configs_cover_every_forward_variant_the_paths_use():
    """The variants the paths launch, from the configs they build: the
    avatar's views (``_view_passes`` turns render_front off) and the SOAR
    trainer, surface with per-pixel depth; the dreamer, volume Gaussians.
    The tests' configs drive each of them."""
    paths = (dataclasses.replace(RenderSettings().raster, render_front=False),
             inspect.signature(make_train_step).parameters["raster"].default,
             DreamerConfig().raster)
    used = {pp.launch_flags(c) for c in paths}
    assert used == {0, 3}
    assert used <= {pp.launch_flags(c) for c in CONFIGS.values()}
