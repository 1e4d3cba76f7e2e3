"""A training step replayed from CUDA graphs around its composite launches.

Eager, a guided 512x512 step dispatches about 17,000 aten ops, and on an
H100 the host's dispatch takes twice as long as the device's work.  The
step has fixed shapes (the slot grid, the first-K gathers, the networks'
batches), so it can be captured once and replayed.  The composite kernels
stay outside the graphs: every launch, forward and backward, goes through
:func:`soar_tpu_torch.render.block_composite._launch_fwd` /
``_launch_bwd``, looked up at call time.  A step runs in three phases:

- segment A (graphed): the field query, the regularisers that read the
  parameters, and every render's front end (pose, preprocess, binning,
  sort, gathers) up to each composite's packed kernel inputs;
- eager: the composite launches, each an autograd node whose backward
  launches the backward kernel eagerly;
- segment B (graphed): the composites' finish and post ops, the neural
  background, every loss, the guidance and LPIPS, and the summed loss.

Each segment is an autograd function that replays a forward graph and, in
its backward, a backward graph, so the autograd engine runs a handful of
nodes instead of thousands.  Segment A is captured on aliases of the
parameters (the same memory, fresh autograd leaves), and its backward
graph writes their gradients into tensors of its own, which become the
parameters' ``.grad`` after each replayed backward; Adam runs eagerly.

Per step, the values that change (the batch, the draws, the frame's SMPL
parameters and the loss's step scalars) are copied into the graphs' own
input tensors; everything else (the parameters, the field, the body, the
skinning data, the networks' weights) is read in place, so an in-place
update shows in the next replay.  The metrics are cloned, so callers own
what they get.

The caller keys a step by everything a capture depends on beyond the
values copied in.  A key's first call runs eagerly; its second captures
the four graphs (which run nothing) and replays them; later calls replay.
One capture is held at a time (its private memory pool holds the step's
activations).  ``eager``, ``captures`` and ``replays`` on the caller's
step function count the calls of each kind.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, NamedTuple, Sequence

import torch
from torch.utils import _pytree as pytree

from ..core import spans
from ..render import block_composite

HELD = 1  # captured steps held at once (each four graphs and a pool)


class Segments(NamedTuple):
    """The step's work, split where the composites launch.

    - ``params``: the module whose parameters segment A reads and
      differentiates (the avatar);
    - ``front(x) -> (mid, regs, jobs)``: segment A on the step inputs
      ``x``; ``jobs`` is each composite's ``(feat, pixf, consts)`` (its
      packed kernel inputs and constants), ``regs`` the other outputs that
      carry a gradient to segment B, ``mid`` what segment B reads of A that
      carries none (the renders' finish closures);
    - ``back(x, mid, results, regs) -> (loss, metrics)``: segment B, with
      ``results`` each composite's raw ``(accum, corr, T)``;
    - ``eager(x) -> metrics``: the whole step eagerly, its backward
      included (a key's first call, and every call that is not eligible).
    """

    params: torch.nn.Module
    front: Callable
    back: Callable
    eager: Callable


class _Call(torch.nn.Module):
    """``fn`` as the forward of a module that holds ``params``, so that
    :func:`torch.func.functional_call` can swap their tensors for a call."""

    def __init__(self, params: torch.nn.Module, fn: Callable):
        super().__init__()
        self.params, self.fn = params, fn

    def forward(self, *args):
        return self.fn(*args)


def leaves(x) -> List[torch.Tensor]:
    """The step inputs' tensors, in a fixed order."""
    return pytree.tree_flatten(x)[0]


def structure(x) -> Hashable:
    """The step inputs' structure and each tensor's shape, stride, dtype
    and device: what a capture depends on besides their values."""
    flat, spec = pytree.tree_flatten(x)
    return spec, tuple((tuple(t.shape), t.stride(), t.dtype, t.device) for t in flat)


def hooked(modules: Sequence[torch.nn.Module]) -> bool:
    """Whether a forward or backward hook is registered on any of
    ``modules`` or globally: a replay would skip it."""
    from torch.nn.modules import module as M

    if (M._global_forward_hooks or M._global_forward_pre_hooks or M._global_backward_hooks
            or M._global_backward_pre_hooks):
        return True
    return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
               or m._backward_pre_hooks for m in modules)


def on_the_card(x, device: torch.device) -> bool:
    """Whether ``device`` is the current CUDA device and every step input
    is on it."""
    return (device.type == "cuda" and device.index == torch.cuda.current_device()
            and all(t.device == device for t in leaves(x)))


def replayable() -> bool:
    """Autograd on, autocast off, tracing off (a traced step runs eagerly,
    so that its spans and counters read) and no capture already open."""
    return (torch.is_grad_enabled() and not torch.is_autocast_enabled("cuda")
            and not spans.on() and not torch.cuda.is_current_stream_capturing())


def eligible(x, device: torch.device) -> bool:
    """Whether a step on ``device`` with inputs ``x`` can replay
    (:func:`on_the_card` and :func:`replayable`).  The caller adds what
    only it can see: the step's options and the networks' hooks."""
    return on_the_card(x, device) and replayable()


def _leaves_reached(roots: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The leaves whose ``.grad`` a backward from ``roots`` accumulates,
    each once, in the order first reached."""
    seen, out, stack = set(), [], [t.grad_fn for t in roots if t.grad_fn is not None]
    found = set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, "variable", None)
        if var is not None and id(var) not in found:
            found.add(id(var))
            out.append(var)
        stack.extend(f for f, _ in fn.next_functions)
    return out


def _result_shapes(feat: torch.Tensor, pixf: torch.Tensor):
    """``_launch_fwd``'s outputs' shapes: accum [NT, C, P], corr and T [NT, P]."""
    NT, _, F = feat.shape
    P = pixf.shape[1]
    return (NT, F - 9, P), (NT, P), (NT, P)


class _Captured:
    """One step's four graphs (A and B, forward and backward, in one
    memory pool), their input tensors and their outputs."""

    def __init__(self, seg: Segments, x):
        flat, spec = pytree.tree_flatten(x)
        self.static = [t.detach().clone() for t in flat]
        xs = pytree.tree_unflatten(self.static, spec)
        pool = torch.cuda.graph_pool_handle()
        self.fa, self.ba, self.fb, self.bb = (torch.cuda.CUDAGraph() for _ in range(4))
        # Segment A reads the parameters through aliases (the same memory,
        # fresh autograd leaves): a graph of an earlier step that is still
        # alive holds the parameters' gradient accumulators, made on another
        # stream, and the capture must not wait on that stream.
        named = list(seg.params.named_parameters())
        aliases = {f"params.{n}": p.detach().requires_grad_(p.requires_grad) for n, p in named}
        param_of = {id(a): p for a, (_, p) in zip(aliases.values(), named)}
        with torch.enable_grad():
            with torch.cuda.graph(self.fa, pool=pool):
                mid, regs, jobs = torch.func.functional_call(_Call(seg.params, seg.front),
                                                             aliases, (xs,))
            a_out = [f for f, _, _ in jobs] + list(regs)
            self.pixf = [p for _, p, _ in jobs]
            self.consts = [tuple(map(float, c)) for _, _, c in jobs]
            self.b_in = [torch.empty(s, dtype=torch.float32, device=f.device, requires_grad=True)
                         for f, p, _ in jobs for s in _result_shapes(f, p)]
            self.b_in += [torch.empty_like(r).requires_grad_() for r in regs]
            n_res = 3 * len(jobs)
            results = [tuple(self.b_in[i:i + 3]) for i in range(0, n_res, 3)]
            with torch.cuda.graph(self.fb, pool=pool):
                loss, metrics = seg.back(xs, mid, results, self.b_in[n_res:])
            del mid, results
            stray = [t for t in _leaves_reached([loss]) if not any(t is b for b in self.b_in)]
            if stray:
                raise RuntimeError(f"segment B reads {len(stray)} leaf tensor(s) that need a "
                                   "gradient other than its inputs; route them through "
                                   "segment A's outputs")
            self.g_loss = torch.empty_like(loss)
            with torch.cuda.graph(self.bb, pool=pool):
                torch.autograd.backward([loss], [self.g_loss], inputs=self.b_in)
            self.b_grads = [t.grad for t in self.b_in]
            # The composite outputs the loss does not differentiate (a gen
            # view's occ pass) go to segment B detached, so that, as in
            # the eager step, their composites launch no backward kernel;
            # segment A's backward leaves out their kernel inputs.
            self.need = [g is not None for g in self.b_grads]
            self.need_a = [any(self.need[3 * j:3 * j + 3]) for j in range(len(jobs))]
            self.need_a += [True] * len(regs)
            a_diff = [o for o, n in zip(a_out, self.need_a) if n]
            # Segment A's backward leaves each alias's gradient in a tensor
            # of its own (the aliases have no .grad yet, so none is added to).
            reached = _leaves_reached(a_diff)
            if any(id(t) not in param_of for t in reached):
                raise RuntimeError("segment A reads a leaf tensor that needs a gradient and is "
                                   "not a parameter of the step's module")
            self.g_a = [torch.empty_like(o) for o in a_diff]
            with torch.cuda.graph(self.ba, pool=pool):
                torch.autograd.backward(a_diff, self.g_a, inputs=reached)
            # Each parameter's gradient: the tensor the backward graph
            # writes, which becomes its .grad after every replay.
            self.leaves = [param_of[id(t)] for t in reached]
            self.grads = [t.grad for t in reached]
        self.n_feats = len(jobs)
        self.a_out = [o.detach() for o in a_out]
        self.loss = loss.detach()
        self.metrics = {k: v.detach() for k, v in metrics.items()}

    def run(self, flat: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        for s, t in zip(self.static, flat):
            s.copy_(t)
        outs = _ReplayA.apply(self, *self.leaves)
        feats, regs = outs[:self.n_feats], outs[self.n_feats:]
        results = [t for f, p, c in zip(feats, self.pixf, self.consts)
                   for t in block_composite.composite_kernel(f, p, *c)]
        results = [t if n else t.detach() for t, n in zip(results, self.need)]
        loss = _ReplayB.apply(self, *results, *regs)
        del results
        metrics = {k: v.clone() for k, v in self.metrics.items()}
        loss.backward()
        for leaf, g in zip(self.leaves, self.grads):
            leaf.grad = g
        return metrics


class _ReplayA(torch.autograd.Function):
    """Segment A: replays its forward graph; the backward copies the
    incoming gradients in and replays its backward graph, which leaves the
    parameters' gradients in the capture's own tensors."""

    @staticmethod
    def forward(ctx, cap: _Captured, *leaves):
        ctx.cap, ctx.n = cap, len(leaves)
        ctx.set_materialize_grads(False)
        cap.fa.replay()
        return tuple(o.detach() for o in cap.a_out)

    @staticmethod
    def backward(ctx, *grads):
        cap = ctx.cap
        for s, g in zip(cap.g_a, (g for g, n in zip(grads, cap.need_a) if n)):
            s.copy_(g)
        cap.ba.replay()
        return (None,) * (1 + ctx.n)


class _ReplayB(torch.autograd.Function):
    """Segment B: copies the composites' outputs and A's other outputs in
    and replays its forward graph; the backward replays its backward graph
    and hands back their gradients."""

    @staticmethod
    def forward(ctx, cap: _Captured, *inputs):
        ctx.cap = cap
        for s, t in zip(cap.b_in, inputs):
            s.copy_(t)
        cap.fb.replay()
        return cap.loss.detach()

    @staticmethod
    def backward(ctx, g_loss):
        cap = ctx.cap
        cap.g_loss.copy_(g_loss)
        cap.bb.replay()
        return (None,) + tuple(g if g is None else g.detach() for g in cap.b_grads)


def step(policy, key: Hashable, seg: Segments, x, counts) -> Dict[str, torch.Tensor]:
    """An eligible step's metrics, its backward run and the parameters'
    gradients in ``.grad``: eager on a key's first call, captured and
    replayed on its second, replayed after.  ``policy`` is a
    :class:`soar_tpu_torch.avatar.view_graph.Policy`; ``counts`` (the
    step function) gets ``eager``, ``captures`` and ``replays`` counted."""
    entry, kind = policy.lookup(key)
    name = {"eager": "eager", "capture": "captures", "replay": "replays"}[kind]
    setattr(counts, name, getattr(counts, name) + 1)
    if kind == "eager":
        return seg.eager(x)
    if entry is None:
        policy.make_room()
        entry = _Captured(seg, x)
        policy.hold(key, entry)
    return entry.run(leaves(x))
