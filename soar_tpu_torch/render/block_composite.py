"""Per-tile alpha composite: the CUDA kernels' wrappers (port of
``soar_tpu.render.block_composite``).

:func:`composite_block` has the signature and outputs of the JAX
``composite_block``.  A CPU tensor goes to the plain PyTorch version
(:func:`soar_tpu_torch.render.composite.composite_block_plain`), with
autograd through it; a CUDA tensor launches ``csrc/composite_fwd.cu``, and
its gradient launches ``csrc/composite_bwd.cu`` — there is no fallback.
The pair is one ``torch.autograd.Function`` (the JAX package's custom VJP):
its forward saves only the packed features and the pixel centres, and the
backward recomputes the walk.  Gradients reach xy, conic, opacity, e and
attrs; ``valid`` and ``pixf`` get none.

Feature packing handed to the kernels (one [NT, K, F] array, F = 9 + C),
as in the JAX package:

    0:2  xy        splat mean (pixels)
    2:5  conic     inverse 2D covariance (a, b, c)
    5    opacity
    6    valid     1.0 / 0.0 slot mask
    7:9  e         depth-correction coefficients: dif_z = dx*e0 + dy*e1
    9:9+C attrs    channels composited linearly (colors, normals, depth)
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .composite import composite_block_bwd_plain, composite_block_plain

MAX_CHANNELS = 16  # the kernels are instantiated for C = 1..16
MAX_PIXELS = 256  # pixels per tile: 16x16 tiles
# Shared memory a block may opt into on sm_90 (kSmemOptin in
# csrc/composite_common.cuh); both kernels ask for it as dynamic memory.
SMEM_OPTIN = 227 * 1024
_MAX_WARPS = MAX_PIXELS // 32


def _padded_row(F: int) -> int:
    return (F + 3) // 4 * 4


def fwd_smem_bytes(K: int, C: int, P: int) -> int:
    """Shared memory composite_fwd.cu asks for: K rows padded to a multiple
    of 4 floats, and one int a warp for the slot bound."""
    return 4 * (K * _padded_row(9 + C) + _MAX_WARPS)


def bwd_smem_bytes(K: int, C: int, P: int) -> int:
    """Shared memory composite_bwd.cu asks for: the padded rows, each warp's
    partial sums of the 8 + C gradients of every slot (one thread a pixel,
    rounded up to whole warps), and two ints a warp (the slot bound and the
    warp's last blended slot)."""
    F = 9 + C
    warps = -(-P // 32)
    return 4 * (K * (_padded_row(F) + warps * (F - 1)) + 2 * _MAX_WARPS)


def _pack(xy, conic, opac, valid, attrs, e) -> torch.Tensor:
    return torch.cat(
        [xy, conic, opac[..., None], valid.to(xy.dtype)[..., None], e, attrs], dim=-1
    )


def _check(feat: torch.Tensor, pixf: torch.Tensor, smem_bytes, name: str):
    """Shapes, types and the kernel's shared-memory footprint: a shape the
    kernel cannot launch raises here, not as a CUDA error at launch."""
    NT, K, F = feat.shape
    C, P = F - 9, pixf.shape[1]
    if feat.dtype != torch.float32 or pixf.dtype != torch.float32:
        raise TypeError("the composite kernels take float32 inputs")
    if not (1 <= C <= MAX_CHANNELS) or not (1 <= P <= MAX_PIXELS):
        raise ValueError(f"kernels take 1..{MAX_CHANNELS} channels and "
                         f"1..{MAX_PIXELS} pixels per tile, got C={C}, P={P}")
    need = smem_bytes(K, C, P)
    if need > SMEM_OPTIN:
        raise ValueError(f"{name}: K={K} slots at C={C}, P={P} need {need} B of shared "
                         f"memory, over the {SMEM_OPTIN} B a block may have")
    if tuple(pixf.shape) != (NT, P, 2):
        raise ValueError("composite_block: inconsistent tile/slot shapes")
    return NT, K, C, P


def _launch_fwd(feat, pixf, alpha_clamp, alpha_min, t_min):
    """composite_fwd.cu: returns accum [NT, C, P], corr [NT, P], T [NT, P]."""
    NT, K, C, P = _check(feat, pixf, fwd_smem_bytes, "composite_fwd")
    accum = torch.empty((NT, C, P), dtype=torch.float32, device=feat.device)
    corr = torch.empty((NT, P), dtype=torch.float32, device=feat.device)
    T = torch.empty((NT, P), dtype=torch.float32, device=feat.device)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = kernels.load("composite_fwd").composite_fwd(
        feat.data_ptr(), pixf.data_ptr(), accum.data_ptr(), corr.data_ptr(),
        T.data_ptr(), NT, K, P, C,
        float(alpha_clamp), float(alpha_min), float(t_min), stream,
    )
    if err != 0:
        raise RuntimeError(f"composite_fwd kernel launch failed: CUDA error {err}")
    composite_block.launches += 1
    return accum, corr, T


def _launch_bwd(feat, pixf, gacc, gcorr, gT, alpha_clamp, alpha_min, t_min):
    """composite_bwd.cu: returns gfeat [NT, K, F] (zero ``valid`` column)."""
    NT, K, C, P = _check(feat, pixf, bwd_smem_bytes, "composite_bwd")
    gacc = gacc.to(torch.float32).contiguous()
    gcorr = gcorr.to(torch.float32).contiguous()
    gT = gT.to(torch.float32).contiguous()
    if (tuple(gacc.shape) != (NT, C, P) or tuple(gcorr.shape) != (NT, P)
            or tuple(gT.shape) != (NT, P)):
        raise ValueError("composite_block_bwd: cotangent shapes do not match")
    gfeat = torch.empty_like(feat)
    stream = torch.cuda.current_stream(feat.device).cuda_stream
    err = kernels.load("composite_bwd").composite_bwd(
        feat.data_ptr(), pixf.data_ptr(), gacc.data_ptr(), gcorr.data_ptr(),
        gT.data_ptr(), gfeat.data_ptr(), NT, K, P, C,
        float(alpha_clamp), float(alpha_min), float(t_min), stream,
    )
    if err != 0:
        raise RuntimeError(f"composite_bwd kernel launch failed: CUDA error {err}")
    composite_block.bwd_launches += 1
    return gfeat


class _Composite(torch.autograd.Function):
    """The kernel pair as one differentiable op on the packed features."""

    @staticmethod
    def forward(ctx, feat, pixf, alpha_clamp, alpha_min, t_min):
        ctx.save_for_backward(feat, pixf)
        ctx.consts = (alpha_clamp, alpha_min, t_min)
        return _launch_fwd(feat, pixf, alpha_clamp, alpha_min, t_min)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gacc, gcorr, gT):
        feat, pixf = ctx.saved_tensors
        gfeat = _launch_bwd(feat, pixf, gacc, gcorr, gT, *ctx.consts)
        return gfeat, None, None, None, None


def _on_one_device(name, args):
    dev = args[0].device
    if dev.type != "cuda" or any(t.device != dev for t in args):
        raise ValueError(
            f"{name} takes CPU or CUDA tensors on one device, got "
            f"{sorted({str(t.device) for t in args})}"
        )


def composite_block(
    xy: torch.Tensor,  # [NT, K, 2]
    conic: torch.Tensor,  # [NT, K, 3]
    opac: torch.Tensor,  # [NT, K]
    valid: torch.Tensor,  # [NT, K] bool
    attrs: torch.Tensor,  # [NT, K, C] linear channels
    e: torch.Tensor,  # [NT, K, 2] depth-correction coeffs (zeros -> corr 0)
    pixf: torch.Tensor,  # [NT, P, 2]
    alpha_clamp: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    t_min: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(accum [NT, P, C], corr [NT, P], T [NT, P])``; the depth
    channel's plane correction ``corr`` must be SUBTRACTED by the caller."""
    args = (xy, conic, opac, valid, attrs, e, pixf)
    if xy.device.type == "cpu":
        return composite_block_plain(*args, alpha_clamp, alpha_min, t_min)
    _on_one_device("composite_block", args)
    # The packing stays outside the Function, so autograd splits the packed
    # gradient back onto xy, conic, opac, e and attrs.
    return kernel_outputs(*composite_kernel(*kernel_inputs(*args), alpha_clamp, alpha_min, t_min))


def composite_kernel(feat: torch.Tensor, pixf: torch.Tensor, alpha_clamp: float,
                     alpha_min: float, t_min: float):
    """The kernel pair on packed inputs (:func:`kernel_inputs`), as one
    differentiable op: the forward kernel's raw ``(accum [NT, C, P], corr,
    T)`` (:func:`kernel_outputs` turns them into :func:`composite_block`'s);
    its gradient launches the backward kernel."""
    return _Composite.apply(feat, pixf, float(alpha_clamp), float(alpha_min), float(t_min))


def kernel_inputs(xy, conic, opac, valid, attrs, e, pixf):
    """The forward kernel's inputs from :func:`composite_block`'s seven
    tensor arguments: the packed features [NT, K, 9 + C] and the pixel
    centres, both contiguous."""
    return _pack(xy, conic, opac, valid, attrs, e).contiguous(), pixf.contiguous()


def kernel_outputs(accum, corr, T):
    """:func:`composite_block`'s outputs from the forward kernel's."""
    return accum.transpose(1, 2), corr, T


def composite_block_bwd(
    xy, conic, opac, valid, attrs, e, pixf,
    gacc: torch.Tensor,  # [NT, C, P] cotangent of accum (the kernel's layout)
    gcorr: torch.Tensor,  # [NT, P]
    gT: torch.Tensor,  # [NT, P]
    alpha_clamp: float = 0.99,
    alpha_min: float = 1.0 / 255.0,
    t_min: float = 1e-4,
) -> torch.Tensor:
    """The backward as a function: per-slot gradients in the [NT, K, F]
    packing (zero ``valid`` column).  CPU tensors go to
    :func:`composite_block_bwd_plain`; CUDA tensors launch the kernel."""
    args = (xy, conic, opac, valid, attrs, e, pixf)
    if xy.device.type == "cpu":
        return composite_block_bwd_plain(*args, gacc, gcorr, gT,
                                         alpha_clamp, alpha_min, t_min)
    _on_one_device("composite_block_bwd", args + (gacc, gcorr, gT))
    with torch.no_grad():
        feat = _pack(xy, conic, opac, valid, attrs, e).contiguous()
    return _launch_bwd(feat, pixf.contiguous(), gacc, gcorr, gT,
                       alpha_clamp, alpha_min, t_min)


# Kernel launches since the last reset, forward and backward; chip_smoke.py
# reads them to show the render and training paths went through the kernels.
composite_block.launches = 0
composite_block.bwd_launches = 0
