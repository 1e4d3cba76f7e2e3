"""Per-surfel screen-space preprocessing (port of
``soar_tpu.render.preprocess``): projection, frustum / back-face / grazing
culling as a validity mask, view-space normals, EWA 3D->2D covariance with
the 0.3 low-pass, screen radius, and the per-pixel-depth local homography
``jinv`` (``cuda_rasterizer/forward.cu:204-385``, ``auxiliary.h:291-397``).

:func:`preprocess` on CUDA launches ``csrc/preprocess.cu`` (the forward, and
the means', quaternions' and scales' gradients in its backward); on the CPU
it runs the plain PyTorch version, :func:`preprocess_plain`, which is also
what the kernel is held against.  A CUDA call the kernel is not built for
(another dtype, an input whose rows are not contiguous, a camera that needs
a gradient, ...) raises NotImplementedError: there is no plain path on the
card.  ``preprocess.kernel`` and ``preprocess.kernel_bwd`` count the
kernel's forward and backward launches, and ``preprocess.eager`` the plain
calls, since import.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import kernels
from ..core import spans
from ..core.camera import Camera, focal_from_fov, ndc2pix
from ..core.transforms import quat_to_rotmat
from .types import GaussianInputs, Preprocessed, RasterConfig


def _ewa_cov2d(
    p_view: torch.Tensor,  # [N, 3]
    cov3d: torch.Tensor,  # [N, 3, 3]
    w_rot: torch.Tensor,  # [3, 3]
    focal: Tuple[torch.Tensor, torch.Tensor],
    tan_fov: Tuple[torch.Tensor, torch.Tensor],
    low_pass: float,
) -> torch.Tensor:
    """cov2d = J W Σ Wᵀ Jᵀ + low_pass·I at the fov-clamped view point,
    returned as (a, b, c) packing [[a, b], [b, c]]."""
    fx, fy = focal
    tanx, tany = tan_fov
    tz = p_view[:, 2]
    tx = torch.clamp(p_view[:, 0] / tz, -1.3 * tanx, 1.3 * tanx) * tz
    ty = torch.clamp(p_view[:, 1] / tz, -1.3 * tany, 1.3 * tany) * tz

    zero = torch.zeros_like(tz)
    J = torch.stack(
        [
            torch.stack([fx / tz, zero, -fx * tx / (tz * tz)], dim=-1),
            torch.stack([zero, fy / tz, -fy * ty / (tz * tz)], dim=-1),
        ],
        dim=-2,
    )  # [N, 2, 3]
    JW = J @ w_rot
    cov = JW @ cov3d @ JW.transpose(-1, -2)  # [N, 2, 2]
    a = cov[:, 0, 0] + low_pass
    b = cov[:, 0, 1]
    c = cov[:, 1, 1] + low_pass
    return torch.stack([a, b, c], dim=-1)


def _local_homo(
    p_view: torch.Tensor,
    n_view: torch.Tensor,
    ax0_view: torch.Tensor,
    ax1_view: torch.Tensor,
    fx: torch.Tensor,
    fy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse local homography between the screen plane and the surfel's
    tangent plane.  Returns (jinv [N, 10], grazing [N] bool): jinv[:4] is
    the 2x2 screen->tangent Jacobian scaled by S_fix/Svp, jinv[4:7] = u0,
    jinv[7:10] = u1."""
    s_fix = 1000.0
    svp = (fx + fy) / 2.0

    px = p_view[:, 0] / p_view[:, 2]
    py = p_view[:, 1] / p_view[:, 2]
    ones = torch.ones_like(px)

    def norm3(v):
        mod = torch.clamp_min(torch.linalg.norm(v, dim=-1), 1e-8)
        return v / mod[:, None], mod

    dir_x0, mod_x0 = norm3(torch.stack([px + 1.0 / s_fix, py, ones], dim=-1))
    dir_x1, mod_x1 = norm3(torch.stack([px, py + 1.0 / s_fix, ones], dim=-1))

    prj_x0 = torch.sum(dir_x0 * n_view, dim=-1)
    prj_x1 = torch.sum(dir_x1 * n_view, dim=-1)
    # Grazing cull (threshold 0.01); the reference divides the normalized
    # dot by the direction norm again — replicated.
    grazing = (torch.abs(prj_x0 / mod_x0) < 0.01) | (torch.abs(prj_x1 / mod_x1) < 0.01)

    t_temp = torch.sum(p_view * n_view, dim=-1)

    def safe(x):
        return torch.where(torch.abs(x) < 1e-12, 1e-12, x)

    t_x0 = t_temp / safe(prj_x0)
    t_x1 = t_temp / safe(prj_x1)
    xu0 = dir_x0 * t_x0[:, None] - p_view
    xu1 = dir_x1 * t_x1[:, None] - p_view

    u0, u1 = ax0_view, ax1_view
    scale = svp / s_fix
    j00 = torch.sum(xu0 * u0, dim=-1) / scale
    j01 = torch.sum(xu1 * u0, dim=-1) / scale
    j10 = torch.sum(xu0 * u1, dim=-1) / scale
    j11 = torch.sum(xu1 * u1, dim=-1) / scale

    jinv = torch.cat([torch.stack([j00, j01, j10, j11], dim=-1), u0, u1], dim=-1)
    return jinv, grazing


def preprocess_plain(
    g: GaussianInputs,
    camera: Camera,
    image_size: Tuple[int, int],
    cfg: RasterConfig,
) -> Preprocessed:
    """:func:`preprocess` in plain PyTorch, on any device."""
    H, W = image_size
    fx = focal_from_fov(camera.fovx, W)
    fy = focal_from_fov(camera.fovy, H)
    tanx = torch.tan(camera.fovx * 0.5)
    tany = torch.tan(camera.fovy * 0.5)

    N = g.means3d.shape[0]
    ones = torch.ones_like(g.means3d[:, :1])
    p_h = torch.cat([g.means3d, ones], dim=-1)  # [N, 4]

    p_hom = p_h @ camera.full_proj.T
    p_w = 1.0 / (p_hom[:, 3] + 1e-7)
    p_proj = p_hom[:, :3] * p_w[:, None]
    p_view = (p_h @ camera.w2c.T)[:, :3]

    x_pix = ndc2pix(p_proj[:, 0], W, camera.prcppoint[0])
    y_pix = ndc2pix(p_proj[:, 1], H, camera.prcppoint[1])
    xy = torch.stack([x_pix, y_pix], dim=-1)

    # Frustum test with a 20% border; z >= cfg.near (see RasterConfig).
    ex, ey = 0.2 * W, 0.2 * H
    valid = (
        (p_view[:, 2] >= cfg.near)
        & (x_pix >= -ex)
        & (x_pix < W + ex)
        & (y_pix >= -ey)
        & (y_pix < H + ey)
    )

    R = quat_to_rotmat(g.quats)  # [N, 3, 3], columns are local axes
    w_rot = camera.w2c[:3, :3]
    # A splat in front of the near plane is culled, but the footprint and
    # local homography below divide by its depth: at z = 0 they are NaN, and
    # the zero cotangent it gets times that NaN makes NaN gradients on the
    # parameters it shares with every other splat (the field).  Those terms
    # take its depth clamped to the near plane; a kept splat's values are
    # unchanged, and a culled splat's are never read.  (The JAX package has
    # the NaN: ROADMAP.md, Queue 3.)
    z = p_view[:, 2]
    p_safe = torch.cat([p_view[:, :2], torch.where(z >= cfg.near, z, cfg.near)[:, None]], -1)

    zeros10 = torch.zeros((N, 10), dtype=g.means3d.dtype, device=g.means3d.device)
    if cfg.surface:
        n_view = R[..., :, 2] @ w_rot.T
        ax0_view = R[..., :, 0] @ w_rot.T
        ax1_view = R[..., :, 1] @ w_rot.T
        view_dot = torch.sum(p_view * n_view, dim=-1)
        if cfg.render_front:
            valid = valid & (view_dot <= -0.01)
        if cfg.perpix_depth:
            jinv, grazing = _local_homo(p_safe, n_view, ax0_view, ax1_view, fx, fy)
            valid = valid & ~grazing
        else:
            jinv = zeros10
    else:
        n_view = torch.zeros_like(g.means3d)
        view_dot = torch.full((N,), -1.0, dtype=g.means3d.dtype, device=g.means3d.device)
        jinv = zeros10

    # Σ = R S² Rᵀ with the z-scale zeroed for flat surfels.
    s = g.scales * cfg.scale_modifier
    if cfg.surface:
        s = torch.cat([s[:, :2], torch.zeros_like(s[:, 2:])], dim=-1)
    RS = R * s[:, None, :]
    cov3d = RS @ RS.transpose(-1, -2)

    cov = _ewa_cov2d(p_safe, cov3d, w_rot, (fx, fy), (tanx, tany), cfg.low_pass)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    valid = valid & (det != 0.0)
    det_inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    conic = torch.stack(
        [cov[:, 2] * det_inv, -cov[:, 1] * det_inv, cov[:, 0] * det_inv], dim=-1
    )

    mid = 0.5 * (cov[:, 0] + cov[:, 2])
    lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam_max))
    valid = valid & (radius > 0.0)

    return Preprocessed(
        valid=valid,
        xy=xy,
        depth=p_view[:, 2],
        conic=conic,
        radius=radius,
        normal_view=n_view,
        view_dot=view_dot,
        jinv=jinv,
        colors=g.colors,
        opacities=g.opacities,
    )


# Flags of the kernel's variants (csrc/preprocess.cu kSurface, kPerpix,
# kFront).
FLAGS = {"surface": 1, "perpix_depth": 2, "render_front": 4}
_P, _LL, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float


class _Args(ctypes.Structure):
    """csrc/preprocess.cu's ``PreprocessArgs``, field for field."""

    _fields_ = (
        [(n, _P) for n in ("means", "quats", "scales", "fovx", "fovy", "w2c", "full_proj",
                           "prcp", "valid", "xy", "depth", "conic", "radius", "normal",
                           "view_dot", "jinv", "g_xy", "g_depth", "g_conic", "g_normal",
                           "g_view_dot", "g_jinv", "g_means", "g_quats", "g_scales")]
        + [(n, _LL) for n in ("s_means", "s_quats", "s_scales", "s_gxy", "s_gdepth",
                              "s_gconic", "s_gnormal", "s_gview_dot", "s_gjinv")]
        + [(n, _I) for n in ("N", "W", "H")]
        + [(n, _F) for n in ("near_z", "low_pass", "scale_modifier", "lo_x", "hi_x", "lo_y",
                             "hi_y")]
    )


# The outputs the kernel writes, in its Args' order, with their widths.
_OUTPUTS = (("xy", 2), ("depth", 1), ("conic", 3), ("normal", 3), ("view_dot", 1),
            ("jinv", 10))


def launch_flags(cfg: RasterConfig) -> int:
    """The kernel variant of ``cfg``: per-pixel depth and render_front act
    only on surfels, so without ``surface`` it is the one volume kernel."""
    if not cfg.surface:
        return 0
    return sum(bit for name, bit in FLAGS.items() if getattr(cfg, name))


def refusal(g: GaussianInputs, camera: Camera) -> Optional[str]:
    """What in a CUDA call's tensors the kernel is not built for, or None:
    float32 means [N, 3], quaternions [N, 4] and scales [N, 3] on one device,
    each row's floats contiguous; a float32 camera on that device whose
    tensors are contiguous and need no gradient (the kernel gives them
    none)."""
    dev = g.means3d.device
    cam = (camera.fovx, camera.fovy, camera.w2c, camera.full_proj, camera.prcppoint)
    for name, t, width in (("means3d", g.means3d, 3), ("quats", g.quats, 4),
                           ("scales", g.scales, 3)):
        if t.dtype != torch.float32:
            return f"{t.dtype} {name} (it takes float32)"
        if t.device != dev:
            return f"{name} on {t.device} with means3d on {dev}"
        if t.dim() != 2 or t.shape != (g.means3d.shape[0], width):
            return f"{name} of shape {tuple(t.shape)}"
        if t.shape[0] > 1 and t.stride(1) != 1:
            return f"{name} whose rows are not contiguous"
    if g.means3d.shape[0] >= 2**31 // 10:
        return f"{g.means3d.shape[0]} surfels: the outputs' indices pass 32 bits"
    for name, t in zip(("fovx", "fovy", "w2c", "full_proj", "prcppoint"), cam):
        if t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
            return f"a camera {name} that is not a contiguous float32 tensor on {dev}"
        if torch.is_grad_enabled() and t.requires_grad:
            return f"a camera {name} that needs a gradient"
    return None


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _row_stride(t: Optional[torch.Tensor]) -> int:
    """Floats from one surfel's row to the next (0 for a broadcast row)."""
    return 0 if t is None else t.stride(0)


def _launch(args: _Args, flags: int, backward: bool, device) -> None:
    """csrc/preprocess.cu on the current stream, counted in
    ``preprocess.kernel`` / ``preprocess.kernel_bwd``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = kernels.load("preprocess").preprocess(ctypes.byref(args), flags, int(backward),
                                                stream)
    if err != 0:
        raise RuntimeError(f"preprocess kernel launch failed: CUDA error {err}")
    if backward:
        preprocess.kernel_bwd += 1
    else:
        preprocess.kernel += 1


def _args(means, quats, scales, cam, image_size, cfg) -> _Args:
    H, W = image_size
    fovx, fovy, w2c, full_proj, prcp = cam
    # The frustum test's bounds as the plain chain compares them: Python
    # floats taken to float32.
    ex, ey = 0.2 * W, 0.2 * H
    return _Args(
        means=_ptr(means), quats=_ptr(quats), scales=_ptr(scales), fovx=_ptr(fovx),
        fovy=_ptr(fovy), w2c=_ptr(w2c), full_proj=_ptr(full_proj), prcp=_ptr(prcp),
        s_means=_row_stride(means), s_quats=_row_stride(quats), s_scales=_row_stride(scales),
        N=means.shape[0], W=W, H=H, near_z=cfg.near, low_pass=cfg.low_pass,
        scale_modifier=cfg.scale_modifier, lo_x=-ex, hi_x=W + ex, lo_y=-ey, hi_y=H + ey)


def forward_args(means, quats, scales, cam, image_size, cfg):
    """The forward's launch structure and the outputs it writes, allocated:
    ``(args, (valid, xy, depth, conic, radius, normal, view_dot, jinv))``."""
    N, dev = means.shape[0], means.device
    args = _args(means, quats, scales, cam, image_size, cfg)
    valid = torch.empty((N,), dtype=torch.bool, device=dev)
    radius = torch.empty((N,), dtype=torch.float32, device=dev)
    outs = {name: torch.empty((N, w) if w > 1 else (N,), dtype=torch.float32, device=dev)
            for name, w in _OUTPUTS}
    args.valid, args.radius = _ptr(valid), _ptr(radius)
    for name, t in outs.items():
        setattr(args, name, _ptr(t))
    return args, (valid, outs["xy"], outs["depth"], outs["conic"], radius, outs["normal"],
                  outs["view_dot"], outs["jinv"])


def backward_args(means, quats, scales, cam, image_size, cfg, cotangents, wanted):
    """The backward's launch structure for the cotangents of (xy, depth,
    conic, normal, view_dot, jinv), each None for zero, and the gradients of
    the ``wanted`` inputs it writes, allocated: ``(args, [g_means, g_quats,
    g_scales])`` with None for an input not wanted."""
    args = _args(means, quats, scales, cam, image_size, cfg)
    for (name, _), t in zip(_OUTPUTS, cotangents):
        if t is not None and t.dim() == 2 and t.stride(1) != 1:
            t = t.contiguous()
        setattr(args, "g_" + name, _ptr(t))
        setattr(args, "s_g" + name, _row_stride(t))
        # The launch reads the cotangent's memory: keep it alive with args.
        setattr(args, "_keep_" + name, t)
    grads = [torch.empty_like(x, memory_format=torch.contiguous_format) if w else None
             for x, w in zip((means, quats, scales), wanted)]
    args.g_means, args.g_quats, args.g_scales = (_ptr(t) for t in grads)
    return args, grads


class _Preprocess(torch.autograd.Function):
    """The kernel pair as one differentiable op of the means, quaternions and
    scales; the camera is read, never differentiated."""

    @staticmethod
    def forward(ctx, means, quats, scales, fovx, fovy, w2c, full_proj, prcp, image_size, cfg):
        cam = (fovx, fovy, w2c, full_proj, prcp)
        args, outs = forward_args(means, quats, scales, cam, image_size, cfg)
        _launch(args, launch_flags(cfg), False, means.device)
        ctx.save_for_backward(means, quats, scales, *cam)
        ctx.image_size, ctx.cfg = image_size, cfg
        ctx.mark_non_differentiable(outs[0], outs[4])  # valid, radius
        ctx.set_materialize_grads(False)
        return outs

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, _valid, g_xy, g_depth, g_conic, _radius, g_normal, g_view_dot, g_jinv):
        means, quats, scales, *cam = ctx.saved_tensors
        args, grads = backward_args(means, quats, scales, cam, ctx.image_size, ctx.cfg,
                                    (g_xy, g_depth, g_conic, g_normal, g_view_dot, g_jinv),
                                    ctx.needs_input_grad[:3])
        _launch(args, launch_flags(ctx.cfg), True, means.device)
        return (*grads, None, None, None, None, None, None, None)


@spans.spanned("soar.raster.preprocess")
def preprocess(
    g: GaussianInputs,
    camera: Camera,
    image_size: Tuple[int, int],
    cfg: RasterConfig,
) -> Preprocessed:
    """The per-surfel screen-space quantities of one view.  On CUDA the
    kernel computes them, and its backward gives the means', quaternions'
    and scales' gradients; a CUDA call it is not built for raises
    NotImplementedError."""
    if not g.means3d.is_cuda:
        preprocess.eager += 1
        return preprocess_plain(g, camera, image_size, cfg)
    why = refusal(g, camera)
    if why is not None:
        raise NotImplementedError(f"preprocess's CUDA kernel is not built for {why}")
    H, W = image_size
    valid, xy, depth, conic, radius, normal, view_dot, jinv = _Preprocess.apply(
        g.means3d, g.quats, g.scales, camera.fovx, camera.fovy, camera.w2c,
        camera.full_proj, camera.prcppoint, (int(H), int(W)), cfg)
    return Preprocessed(valid=valid, xy=xy, depth=depth, conic=conic, radius=radius,
                        normal_view=normal, view_dot=view_dot, jinv=jinv, colors=g.colors,
                        opacities=g.opacities)


# Kernel launches (forward, backward) and plain calls since import.
preprocess.kernel = preprocess.kernel_bwd = preprocess.eager = 0
