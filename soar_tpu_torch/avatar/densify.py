"""Adaptive densification and pruning at a static capacity (port of
``soar_tpu.avatar.densify``).

The 3DGS densify machinery (``geometry/surfel_base.py:884-1230``:
``add_densification_stats``, ``adaptive_densify``'s clone and split,
``adaptive_prune``, ``update_states``).  The SOAR system never calls it:
the surfel count is fixed there (SURVEY §2.1); only the GaussianDreamer
system drives it (:mod:`soar_tpu_torch.train.systems`).

As in the JAX package the arrays keep a static capacity with an ``alive``
mask: clones and split children are written into dead slots, pruning
clears ``alive``, and the optimizer is never rebuilt (a revived slot keeps
its Adam moments).  Dead slots are parked far outside every frustum
(1e6) with opacity logits -10, so they composite nothing.  The functions
that change the surfels write into the parameters in place, under
``no_grad``, outside the training step; none reads a device value on the
host.  With tracing on (:mod:`soar_tpu_torch.core.spans`) a densify counts
the slots it filled as ``densify.cloned`` and ``densify.split``, and a
prune the surfels it took away as ``densify.pruned``, as device tensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core import spans
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
    ``capacity`` (the field and ``latent_pose`` are shared): dead slots at
    1e6, unit quats, log-scale, opacity and occ logits -10, colours 0.
    Build the optimizer after padding."""
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


def accumulate_stats(
    state: DensifyState,
    xyz_grads: torch.Tensor,  # [C, 3] this step's gradient of the positions
    scale_grads: torch.Tensor,  # [C, 1]
    opacity: torch.Tensor,  # [C, 1] current opacity logits
    visible: torch.Tensor,  # [C] bool (on screen in some view)
) -> DensifyState:
    """``add_densification_stats`` (``surfel_base.py:1113-1136``), with the
    canonical-position gradient's norm in place of the reference's
    screen-space one, as the JAX package does."""
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
                       new_vals, counter: str) -> DensifyState:
    """Write the rows of ``new_vals`` selected by ``src_mask`` into dead
    slots, the k-th source into the k-th dead slot in ascending index
    order; sources past the number of dead slots are dropped.  Updates
    ``params`` in place and returns the state with the slots alive; the
    slots filled count as ``counter``."""
    C = state.alive.shape[0]
    dev = state.alive.device
    src_rank = torch.cumsum(src_mask.to(torch.int64), 0) - 1
    dead = ~state.alive
    # dead_idx[r]: the r-th dead slot; C - 1 past the last (jnp.nonzero's
    # fill value), built with a scatter so the host reads nothing.
    dead_idx = torch.full((C + 1,), C - 1, dtype=torch.int64, device=dev)
    dead_idx.scatter_(0, torch.where(dead, torch.cumsum(dead.to(torch.int64), 0) - 1, C),
                      torch.arange(C, device=dev))
    ok = src_mask & (src_rank < dead.sum())
    dst = torch.where(ok, dead_idx[src_rank.clamp(0, C - 1)], C)  # C: dropped
    for name in _SURFEL_FIELDS:
        p = getattr(params, name)
        buf = torch.cat([p, p.new_zeros((1,) + tuple(p.shape[1:]))])
        buf.index_copy_(0, dst, new_vals[name].to(p.dtype))
        p.copy_(buf[:C])
    used = torch.zeros((C + 1,), dtype=torch.bool, device=dev).index_fill_(0, dst, True)[:C]
    if spans.on():
        spans.count(counter, ok.sum())
    return state._replace(alive=state.alive | used)


@torch.no_grad()
def adaptive_densify(
    params: AvatarParams,
    state: DensifyState,
    generator: Optional[torch.Generator] = None,
    grad_threshold: float = 0.0001,
    extent: float = 2.0,
    percent_dense: float = 0.01,
    surface: bool = True,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[AvatarParams, DensifyState]:
    """Clone small high-gradient surfels, split large ones
    (``surfel_base.py:982-1111``), in this order: the clones copy their
    source verbatim into dead slots; then each split child is drawn in its
    parent's local frame from N(0, 1) scaled by the parent's scale (the
    third axis zeroed for surfels) and goes into the next dead slot with
    the scale divided by 1.6, which the parent takes too.  The split set is
    decided before the clones (``high_grad`` of the accumulated stats), its
    values read after them.  The normal draw is ``noise`` [C, 3] when
    given, else drawn from ``generator``.  ``params`` changes in place;
    the accumulators are reset."""
    C = state.alive.shape[0]
    if noise is None:
        if generator is None:
            raise ValueError("adaptive_densify needs a generator or the split's noise")
        noise = torch.randn((C, 3), generator=generator, device=generator.device)
    denom = torch.clamp_min(state.denom, 1.0)
    grad_pos = torch.nan_to_num(state.xyz_grad_accum / denom)
    grad_scale = torch.nan_to_num(state.scale_grad_accum / denom)
    grad_opac = torch.nan_to_num(state.opac_accum / denom)
    pre_mask = (grad_scale <= 1e-7) & (grad_opac <= 2.0)

    scales = torch.exp(params.scaling[:, 0])
    high_grad = (grad_pos >= grad_threshold) & state.alive & (state.denom > 0)

    clone_mask = high_grad & (scales <= percent_dense * extent) & pre_mask
    state = _scatter_into_dead(params, state, clone_mask,
                               {k: getattr(params, k) for k in _SURFEL_FIELDS}, "densify.cloned")

    # Split: the reference prunes the parent and adds N=2 children; keeping
    # the parent as one child is the static-shape equivalent.
    split_mask = high_grad & (scales > percent_dense * extent)
    rot = params.rotation
    R = quat_to_rotmat(rot / torch.clamp_min(torch.linalg.norm(rot, dim=-1, keepdim=True),
                                             1e-12))
    local = noise.to(params.xyz.dtype) * torch.exp(params.scaling[:, 0:1])
    if surface:
        local = torch.cat([local[:, :2], torch.zeros_like(local[:, 2:])], dim=-1)
    offset = torch.einsum("nij,nj->ni", R, local)
    new_scaling = params.scaling - math.log(1.6)
    split_vals = {k: getattr(params, k) for k in _SURFEL_FIELDS}
    split_vals.update(xyz=params.xyz + offset, scaling=new_scaling)
    state = _scatter_into_dead(params, state, split_mask, split_vals, "densify.split")
    params.scaling.copy_(torch.where(split_mask[:, None], new_scaling, params.scaling))

    z = torch.zeros_like(state.denom)
    return params, state._replace(xyz_grad_accum=z, scale_grad_accum=z, opac_accum=z, denom=z)


@torch.no_grad()
def adaptive_prune(
    params: AvatarParams,
    state: DensifyState,
    min_opacity: float = 0.05,
    extent: float = 2.0,
) -> Tuple[AvatarParams, DensifyState]:
    """``adaptive_prune`` (``surfel_base.py:1068-1093``): low-opacity,
    extreme-scale and never-visible surfels lose ``alive`` and are parked
    (in place)."""
    opac = torch.sigmoid(params.opacity[:, 0])
    s = torch.exp(params.scaling[:, 0])
    prune = ((opac < min_opacity) | (s > 0.5 * extent) | (s * s < 1e-8 * extent**2)
             | (state.denom == 0)) & state.alive
    if spans.on():
        spans.count("densify.pruned", prune.sum())
    params.xyz.copy_(torch.where(prune[:, None], 1e6, params.xyz))
    params.opacity.copy_(torch.where(prune[:, None], -10.0, params.opacity))
    return params, state._replace(alive=state.alive & ~prune)
