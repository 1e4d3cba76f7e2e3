"""Operations and bytes of the block composites, and their least time on
the H100 (copied from ``chip_smoke.py``: ``walk_masks``, ``walk_counts``,
``_bound``, ``composite_bound_ms``, ``composite_bwd_bound_ms`` and their
constants).  A launch is given as its packed ``feat`` [NT, K, 9 + C] and
``pixf`` [NT, P, 2], as ``render.block_composite`` hands them to the
kernels; the pairs walked are counted on that data with the reference's
plain composite."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .peaks import H100_BYTES_PER_S, H100_F32_FLOPS

# Per pixel-slot operation counts of the composite: an evaluated slot costs
# offsets, power, exp, clamp, the skip tests and the T update (19); a
# blended slot adds w = a*T, C channel FMAs and corr (2C+6).
OPS_PER_EVAL = 19
# The backward walks every evaluated slot twice (2 * 19); a blended slot
# costs gw and the running sum in pass 1 (2C+7), and in pass 2 gw again,
# the prefix, S_k, dL/dalpha, the clamp and exp chain and the 8 + C
# per-slot gradients (3C+41); every slot some pixel of the tile blended
# adds its 8 + C sums over the tile's P pixels.
BWD_OPS_PER_BLEND_C = 5
BWD_OPS_PER_BLEND = 48
T_MIN = 1e-4  # the transmittance stop the paths pass


def unpack_feat(feat: torch.Tensor, pixf: torch.Tensor) -> Tuple:
    """The packed features as the composite's arguments (xy, conic, opacity,
    valid, e, attrs, pixf)."""
    return (feat[..., 0:2], feat[..., 2:5], feat[..., 5], feat[..., 6] > 0.5,
            feat[..., 9:], feat[..., 7:9], pixf)


def walk_masks(args):
    """[NT, P, K] masks of the pixel-slot pairs this data makes the
    composite walk: evaluated (up to and including a pixel's early-stop
    slot, valid slots only) and blended (weight > 0)."""
    from ..reference.render.composite import composite_weights, splat_alpha

    xy, conic, opac, valid, attrs, e, pixf = args
    K = valid.shape[1]
    d = xy[:, None] - pixf[:, :, None]
    alpha = splat_alpha(d, conic[:, None], opac[:, None], valid[:, None])
    w, _ = composite_weights(alpha)
    one_minus = 1.0 - alpha
    t_excl = torch.cat([torch.ones_like(alpha[..., :1]),
                        torch.cumprod(one_minus[..., :-1], -1)], -1)
    viol = (t_excl * one_minus) < T_MIN
    stop = torch.where(viol.any(-1), viol.float().argmax(-1),
                       torch.full_like(viol[..., 0], K - 1, dtype=torch.long))
    walked = torch.arange(K, device=xy.device)[None, None] <= stop[..., None]
    return walked & valid[:, None], w > 0


def walk_counts(args) -> Tuple[int, int, int]:
    """The pairs of :func:`walk_masks` counted: evaluated, blended, and the
    (tile, slot) pairs some pixel blended."""
    evaluated, blended = walk_masks(args)
    return int(evaluated.sum()), int(blended.sum()), int(blended.any(1).sum())


def bound(ops: float, nbytes: float) -> Dict:
    t_ops, t_bytes = ops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return {"bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def fwd_bound(feat: torch.Tensor, pixf: torch.Tensor) -> Dict:
    """Least time of a composite_fwd launch: max(bytes / HBM rate, ops / f32
    rate) with the pixel-slot pairs this data makes the kernel walk."""
    NT, K, F = feat.shape
    C, P = F - 9, pixf.shape[1]
    evals, blends, _ = walk_counts(unpack_feat(feat, pixf))
    return bound(evals * OPS_PER_EVAL + blends * (2 * C + 6),
                 4 * (NT * K * (9 + C) + NT * P * 2 + NT * P * (C + 2)))


def bwd_bound(feat: torch.Tensor, pixf: torch.Tensor) -> Dict:
    """The backward's least time: it reads feat, pixf and the three
    cotangents once and writes gfeat once; its operations are two walks
    over the evaluated pairs, the gradient chain over the blended pairs and
    the per-slot pixel sums."""
    NT, K, F = feat.shape
    C, P = F - 9, pixf.shape[1]
    evals, blends, slots = walk_counts(unpack_feat(feat, pixf))
    ops = (2 * evals * OPS_PER_EVAL + blends * (BWD_OPS_PER_BLEND_C * C + BWD_OPS_PER_BLEND)
           + slots * (F - 1) * P)
    return bound(ops, 4 * (2 * NT * K * F + NT * P * 2 + NT * P * (C + 2)))


def launch_bounds(ctx: Dict) -> Dict[str, Dict]:
    """Per kernel, the summed bound seconds and operations of the launches
    recorded in the traced unit (computed once and kept in ``ctx``)."""
    if "_composite_bounds" not in ctx:
        out = {}
        for name, fn in (("composite_fwd", fwd_bound), ("composite_bwd", bwd_bound)):
            rows = [fn(f, p) for f, p in ctx.get("launches", {}).get(name, [])]
            out[name] = {"launches": len(rows), "bound_s": sum(r["bound_s"] for r in rows),
                         "ops": sum(r["ops"] for r in rows)}
        ctx["_composite_bounds"] = out
    return ctx["_composite_bounds"]
