"""Adaptive densification at a static capacity (the benchmark's copy of
``soar_tpu_torch.avatar.densify``, cut to what the GaussianDreamer cell's
check calls: the padding, the statistics, the densify and the prune).

The arrays keep a static capacity with an ``alive`` mask: clones and split
children are written into dead slots, pruning clears ``alive``.  Dead slots
are parked at 1e6 with opacity logits -10.  The functions that change the
surfels write into the parameters in place, under ``no_grad``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.transforms import quat_to_rotmat
from .state import AvatarParams

_SURFEL_FIELDS = ("xyz", "rotation", "scaling", "opacity", "colors", "occ")


class DensifyState(NamedTuple):
    alive: torch.Tensor  # [C] bool
    xyz_grad_accum: torch.Tensor  # [C]
    scale_grad_accum: torch.Tensor  # [C]
    opac_accum: torch.Tensor  # [C]
    denom: torch.Tensor  # [C]

    @staticmethod
    def create(capacity: int, num_alive: int, device="cuda") -> "DensifyState":
        alive = torch.arange(capacity, device=device) < num_alive
        z = torch.zeros((capacity,), device=device)
        return DensifyState(alive, z, z, z, z)


def pad_to_capacity(params: AvatarParams, capacity: int) -> AvatarParams:
    """A new ``AvatarParams`` with the per-surfel arrays grown to
    ``capacity`` (the field and ``latent_pose`` shared): dead slots at 1e6,
    unit quats, log-scale, opacity and occ logits -10, colours 0."""
    n = params.xyz.shape[0]
    pad = capacity - n
    if pad <= 0:
        return params

    def pad_arr(a, fill=0.0):
        a = a.detach()
        return torch.cat([a, torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                                        device=a.device)])

    rotation = pad_arr(params.rotation)
    rotation[n:, 0] = 1.0
    return AvatarParams(
        xyz=pad_arr(params.xyz, 1e6),
        rotation=rotation,
        scaling=pad_arr(params.scaling, -10.0),
        opacity=pad_arr(params.opacity, -10.0),
        colors=pad_arr(params.colors),
        occ=pad_arr(params.occ, -10.0),
        field=params.field,
        latent_pose=params.latent_pose.detach(),
    )


def accumulate_stats(state: DensifyState, xyz_grads: torch.Tensor, scale_grads: torch.Tensor,
                     opacity: torch.Tensor, visible: torch.Tensor) -> DensifyState:
    """``add_densification_stats`` (``surfel_base.py:1113-1136``) with the
    canonical-position gradient's norm."""
    v = visible.to(state.denom.dtype)
    return DensifyState(
        alive=state.alive,
        xyz_grad_accum=state.xyz_grad_accum + v * torch.linalg.norm(xyz_grads, dim=-1),
        scale_grad_accum=state.scale_grad_accum + v * scale_grads[:, 0],
        opac_accum=state.opac_accum + v * opacity[:, 0],
        denom=state.denom + v,
    )


@torch.no_grad()
def _scatter_into_dead(params: AvatarParams, state: DensifyState, src_mask: torch.Tensor,
                       new_vals) -> DensifyState:
    """The rows of ``new_vals`` selected by ``src_mask``, in ascending
    order, into the dead slots in ascending order; sources past the number
    of dead slots are dropped.  A plain loop-free gather: the host reads
    the counts."""
    dead_idx = torch.nonzero(~state.alive)[:, 0]
    src_idx = torch.nonzero(src_mask)[:, 0]
    n = min(int(dead_idx.numel()), int(src_idx.numel()))
    dst, src = dead_idx[:n], src_idx[:n]
    for name in _SURFEL_FIELDS:
        p = getattr(params, name)
        p[dst] = new_vals[name][src].to(p.dtype)
    alive = state.alive.clone()
    alive[dst] = True
    return state._replace(alive=alive)


@torch.no_grad()
def adaptive_densify(
    params: AvatarParams,
    state: DensifyState,
    noise: torch.Tensor,
    grad_threshold: float = 0.0001,
    extent: float = 2.0,
    percent_dense: float = 0.01,
    surface: bool = True,
) -> Tuple[AvatarParams, DensifyState]:
    """Clone small high-gradient surfels, then split large ones
    (``surfel_base.py:982-1111``): the split set is decided before the
    clones, its values read after them; each child is the parent's
    position plus ``noise`` [C, 3] in the parent's frame scaled by its
    scale (third axis zeroed for surfels), with the scale divided by 1.6,
    which the parent takes too.  The accumulators are reset."""
    denom = torch.clamp_min(state.denom, 1.0)
    grad_pos = torch.nan_to_num(state.xyz_grad_accum / denom)
    grad_scale = torch.nan_to_num(state.scale_grad_accum / denom)
    grad_opac = torch.nan_to_num(state.opac_accum / denom)
    pre_mask = (grad_scale <= 1e-7) & (grad_opac <= 2.0)

    scales = torch.exp(params.scaling[:, 0])
    high_grad = (grad_pos >= grad_threshold) & state.alive & (state.denom > 0)

    clone_mask = high_grad & (scales <= percent_dense * extent) & pre_mask
    state = _scatter_into_dead(params, state, clone_mask,
                               {k: getattr(params, k).clone() for k in _SURFEL_FIELDS})

    split_mask = high_grad & (scales > percent_dense * extent)
    rot = params.rotation
    R = quat_to_rotmat(rot / torch.clamp_min(torch.linalg.norm(rot, dim=-1, keepdim=True),
                                             1e-12))
    local = noise.to(params.xyz.dtype) * torch.exp(params.scaling[:, 0:1])
    if surface:
        local = torch.cat([local[:, :2], torch.zeros_like(local[:, 2:])], dim=-1)
    offset = (R @ local[:, :, None])[:, :, 0]
    new_scaling = params.scaling - math.log(1.6)
    split_vals = {k: getattr(params, k).clone() for k in _SURFEL_FIELDS}
    split_vals.update(xyz=params.xyz + offset, scaling=new_scaling)
    state = _scatter_into_dead(params, state, split_mask, split_vals)
    params.scaling[split_mask] = new_scaling[split_mask]

    z = torch.zeros_like(state.denom)
    return params, state._replace(xyz_grad_accum=z, scale_grad_accum=z, opac_accum=z, denom=z)


@torch.no_grad()
def adaptive_prune(params: AvatarParams, state: DensifyState, min_opacity: float = 0.05,
                   extent: float = 2.0) -> Tuple[AvatarParams, DensifyState]:
    """``adaptive_prune`` (``surfel_base.py:1068-1093``): low-opacity,
    extreme-scale and never-visible surfels lose ``alive`` and are
    parked."""
    opac = torch.sigmoid(params.opacity[:, 0])
    s = torch.exp(params.scaling[:, 0])
    prune = ((opac < min_opacity) | (s > 0.5 * extent) | (s * s < 1e-8 * extent**2)
             | (state.denom == 0)) & state.alive
    params.xyz[prune] = 1e6
    params.opacity[prune] = -10.0
    return params, state._replace(alive=state.alive & ~prune)
