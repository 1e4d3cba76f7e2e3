"""Multi-device parallelism: shard the step's camera/view axis and the GT
passes' tile rows over one process per device (port of
``soar_tpu.parallel.views``).

The JAX package replicates the surfel and field state, puts sharding
constraints on the gen views and the GT images, and lets GSPMD insert the
collectives.  Eager PyTorch has no partitioner, so here each constraint is
an explicit split and gather on ``torch.distributed`` (NCCL on CUDA, gloo
on the CPU), one process per device:

- a :class:`ViewMesh` holds the group, this process's rank, the world size
  and its device (:func:`make_view_mesh`);
- :func:`view_sharder` and :func:`row_sharder` give a :class:`Sharder` that
  the trainer asks for this rank's block of an axis (``block``, the
  ``torch.tensor_split`` of it) and for the autograd-aware gather of the
  blocks (``gather``), which pads uneven blocks;
- :func:`replicate` broadcasts parameters, optimizer moments and the
  background MLP from rank 0, the counterpart of ``device_put`` with
  ``P()``;
- :meth:`Sharder.average_gradients` averages every gradient over the group
  before the optimizer steps.

Every rank computes the same loss from the gathered renders.  The gather's
backward is a reduce-scatter sum of a gradient that every rank holds whole,
so it hands each rank ``world`` times its own block's gradient, while the
replicated terms (preprocess, GT post ops, losses) give each rank the full
gradient once: averaging over the group (not summing, which would count the
replicated part ``world`` times) then equals the unsharded step.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

VIEW_AXIS = "view"


@dataclasses.dataclass(frozen=True)
class ViewMesh:
    """A 1-D mesh: ``world`` processes of ``group``, one device each."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    world: int
    device: torch.device


def make_view_mesh(devices: Optional[Sequence] = None) -> ViewMesh:
    """The mesh over the default process group, which is initialised from
    the ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when there is none yet: NCCL when CUDA is available,
    else gloo.  This rank's device is ``devices[rank]``; without
    ``devices``, ``cuda:LOCAL_RANK`` on NCCL and the CPU on gloo."""
    if not dist.is_initialized():
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method="env://")
    rank, world = dist.get_rank(), dist.get_world_size()
    if devices is not None:
        if len(devices) != world:
            raise ValueError(f"make_view_mesh: {len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
    elif dist.get_backend() == "nccl":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    else:
        device = torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return ViewMesh(group=None, rank=rank, world=world, device=device)


class _GatherBlocks(torch.autograd.Function):
    """All-gather of the ranks' blocks along dim 0, each padded to the
    largest; backward: the sum of every rank's gradient of the whole
    (an all-reduce), this rank's block of it."""

    @staticmethod
    def forward(ctx, x, mesh, sizes):
        ctx.mesh, ctx.sizes = mesh, sizes
        pad = max(sizes)
        buf = x.new_zeros((pad,) + tuple(x.shape[1:]))
        buf[: x.shape[0]] = x
        parts = [torch.empty_like(buf) for _ in sizes]
        dist.all_gather(parts, buf, group=mesh.group)
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mesh.group)
        start = sum(ctx.sizes[: ctx.mesh.rank])
        return g[start: start + ctx.sizes[ctx.mesh.rank]], None, None


class Sharder:
    """This rank's block of an axis and the gather of every rank's block;
    one class serves the view axis and the tile-row axis."""

    def __init__(self, mesh: ViewMesh):
        self.mesh = mesh

    def sizes(self, n: int) -> Tuple[int, ...]:
        """Every rank's block length of an axis of ``n``, as
        ``torch.tensor_split`` splits it (uneven splits allowed)."""
        world = self.mesh.world
        if n < world:
            raise ValueError(f"cannot shard an axis of {n} over {world} ranks")
        return tuple(n // world + (r < n % world) for r in range(world))

    def block(self, n: int) -> Tuple[int, int]:
        """``(start, stop)`` of this rank's block of an axis of ``n``."""
        sizes = self.sizes(n)
        start = sum(sizes[: self.mesh.rank])
        return start, start + sizes[self.mesh.rank]

    def gather(self, x: torch.Tensor, n: int, unit: int = 1) -> torch.Tensor:
        """The whole axis from every rank's block ``x`` (dim 0 = this
        rank's ``block(n)``, ``unit`` rows of ``x`` per element of the
        axis), on every rank; differentiable for floating tensors.  A bool
        tensor travels as uint8."""
        sizes = tuple(s * unit for s in self.sizes(n))
        if x.shape[0] != sizes[self.mesh.rank]:
            raise ValueError(f"gather: block of {x.shape[0]} rows, want "
                             f"{sizes[self.mesh.rank]}")
        if x.dtype == torch.bool:
            return _GatherBlocks.apply(x.to(torch.uint8), self.mesh, sizes).to(torch.bool)
        return _GatherBlocks.apply(x.contiguous(), self.mesh, sizes)

    def average_gradients(self, params: torch.nn.Module) -> None:
        """Every parameter's gradient averaged over the group, in one
        all-reduce of the gradients flattened together (SUM, then / world:
        gloo has no AVG)."""
        grads = [p.grad for p in params.parameters() if p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.group)
        flat.div_(self.mesh.world)
        offset = 0
        for g in grads:
            g.copy_(flat[offset: offset + g.numel()].view_as(g))
            offset += g.numel()


def view_sharder(mesh: ViewMesh) -> Sharder:
    """The gen views' sharder: rank r renders its ``block(n_views)`` of the
    step's cameras and the renders are gathered before the losses."""
    return Sharder(mesh)


def row_sharder(mesh: ViewMesh) -> Sharder:
    """The GT passes' sharder: preprocess, binning, sort and gather run
    whole on every rank; rank r composites its ``block(tile rows)`` band
    of tiles, and the band's composite outputs (its image rows) are
    gathered before the output assembly and the losses.  The overflow
    canaries stay whole-image counts."""
    return Sharder(mesh)


def replicate(mesh: ViewMesh, tree):
    """Broadcast every tensor of ``tree`` from rank 0, in place, and return
    ``tree``: a tensor, an ``nn.Module`` (its state_dict), a
    ``torch.optim.Optimizer`` (its state), an object with an ``adam``
    optimizer (the avatar's), or a dict / list / tuple of those."""
    if isinstance(tree, torch.Tensor):
        buf = tree.detach() if tree.is_contiguous() else tree.detach().contiguous()
        dist.broadcast(buf, src=0, group=mesh.group)
        if buf.data_ptr() != tree.data_ptr():
            with torch.no_grad():
                tree.copy_(buf)
    elif isinstance(tree, torch.nn.Module):
        replicate(mesh, list(tree.state_dict().values()))
    elif isinstance(tree, torch.optim.Optimizer):
        replicate(mesh, [tree.state[p] for g in tree.param_groups for p in g["params"]
                         if p in tree.state])
    elif isinstance(tree, dict):
        replicate(mesh, list(tree.values()))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            replicate(mesh, x)
    elif isinstance(getattr(tree, "adam", None), torch.optim.Optimizer):
        replicate(mesh, tree.adam)
    return tree
