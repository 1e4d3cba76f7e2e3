"""A view's render or a training step replayed from CUDA graphs around its
composite launches.

Eager, a 512x512 turntable view dispatches about 1,400 aten ops and a
guided 512x512 step about 17,000, and on an H100 the host's dispatch takes
longer than the device's work.  Both have fixed shapes (the slot grid, the
first-K gathers, the networks' batches), so they can be captured once and
replayed.  The split is :class:`soar_tpu_torch.render.tiled.Passes`': the
work before the composites and the work after them.  The composite kernels
stay outside the graphs: every launch, forward and backward, goes through
:func:`soar_tpu_torch.render.block_composite.composite_kernel`, which looks
up ``_launch_fwd`` / ``_launch_bwd`` at call time.  The work runs in three
phases:

- graph A: everything up to each composite's packed kernel inputs (a view's
  pose, field query, preprocess, binning, sort and gathers; a step's field
  query, regularisers and every render's front end);
- eager: the composite launches;
- graph B: the composites' finish and everything after (a view's post ops;
  a step's post ops, neural background, losses, guidance and LPIPS).

With autograd on (a step), A and B are each an autograd function that
replays a forward graph and, in its backward, a backward graph, so the
autograd engine runs a handful of nodes instead of thousands.  A is
captured on aliases of the parameters (the same memory, fresh autograd
leaves), and its backward graph writes their gradients into tensors of its
own, which become the parameters' ``.grad`` after each replayed backward.
The four graphs share one memory pool.  With autograd off (a view), A and B
share one pool and no backward is captured.

Per call, the inputs ``x`` (a pytree of tensors) are copied into the
graphs' own input tensors; everything else (the parameters, the field, the
body, the skinning data, the networks' weights) is read in place, so an
in-place update shows in the next replay.  The outputs are cloned once, so
callers own what they get, and a tensor shared by two outputs stays shared.

The caller keys the work by what a capture reads in place; :func:`run` adds
the inputs' structure and the TF32 flags.  A key's first call runs eagerly;
its second captures the graphs (which run nothing) and replays them; later
calls replay.  A :class:`Policy` bounds what is held.  Work that is traced
(:mod:`soar_tpu_torch.core.spans` on) runs eagerly, so that its spans and
counters read as they do everywhere else.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Hashable, List, NamedTuple, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ..core import spans
from . import block_composite

HELD_VIEWS = 2  # captured views held at once (each a pair of graphs and a pool)
HELD_STEPS = 1  # captured steps held at once (each four graphs and a pool of activations)
REMEMBERED = 16  # keys seen once that are remembered
IDLE = 32  # views rendered with autograd on after which an unused capture is dropped


class Policy:
    """Which calls capture: a key's first call runs eagerly, its second
    captures, later ones replay; at most ``held`` captures are kept, the
    least recently used dropped first, a capture unused over ``idle``
    views rendered with autograd on is dropped, and the last
    ``remembered`` keys seen once are remembered."""

    def __init__(self, held: int = HELD_VIEWS, remembered: int = REMEMBERED, idle: int = IDLE):
        self.held, self.remembered, self.idle = held, remembered, idle
        self.graphs: OrderedDict = OrderedDict()
        self.seen: OrderedDict = OrderedDict()
        self.used = {}  # key -> grad_views at its last use
        self.grad_views = 0

    def lookup(self, key: Hashable):
        """``(entry, kind)``: kind ``"replay"`` (a held capture),
        ``"capture"`` (seen before: the caller captures it and
        :meth:`hold` s it; entry None) or ``"eager"`` (entry None)."""
        entry = self.graphs.get(key)
        if entry is not None:
            self.graphs.move_to_end(key)
            self.used[key] = self.grad_views
            return entry, "replay"
        if key in self.seen:
            self.seen.move_to_end(key)
            return None, "capture"
        self.seen[key] = None
        while len(self.seen) > self.remembered:
            self.seen.popitem(last=False)
        return None, "eager"

    def make_room(self):
        """Drops the least recently used captures until one more fits, so
        that a capture's memory is free before the next is made."""
        while self.graphs and len(self.graphs) >= self.held:
            self._drop(next(iter(self.graphs)))

    def hold(self, key: Hashable, entry):
        self.graphs[key] = entry
        self.used[key] = self.grad_views
        while len(self.graphs) > self.held:
            self._drop(next(iter(self.graphs)))

    def grad_view(self, n: int = 1):
        """``n`` views rendered with autograd on: drop the captures unused
        over the last ``idle`` such views."""
        self.grad_views += n
        for key in [k for k in self.graphs if self.grad_views - self.used[k] > self.idle]:
            self._drop(key)

    def _drop(self, key: Hashable):
        del self.graphs[key], self.used[key]


# The views' captures, shared by every view of the process.  Its grad count
# is ticked by every render with autograd on: an eager one in
# :func:`soar_tpu_torch.render.tiled.composite_passes`, a replayed step's
# here, once per ``Passes``.
VIEWS = Policy()


# ------------------------------------------------------------------ keys


def tensor_key(x) -> Hashable:
    """A tensor's (address, shape, stride, dtype); tuples, dicts and
    anything else hashable as they are."""
    if isinstance(x, torch.Tensor):
        return x.data_ptr(), tuple(x.shape), x.stride(), x.dtype
    if isinstance(x, dict):
        return tuple((k, tensor_key(v)) for k, v in x.items())
    if isinstance(x, tuple):
        return tuple(map(tensor_key, x))
    return x


def leaves(x) -> List[torch.Tensor]:
    """The pytree ``x``'s tensors, in a fixed order (a None holds none)."""
    return [t for t in pytree.tree_leaves(x) if t is not None]


def rebuild(x, tensors: Sequence[torch.Tensor]):
    """``x`` with its tensors replaced by ``tensors`` (in :func:`leaves`'
    order)."""
    flat, spec = pytree.tree_flatten(x)
    it = iter(tensors)
    return pytree.tree_unflatten([t if t is None else next(it) for t in flat], spec)


def structure(x) -> Hashable:
    """The pytree ``x``'s structure and each tensor's shape, stride, dtype
    and device: what a capture depends on besides their values."""
    flat, spec = pytree.tree_flatten(x)
    return spec, tuple((tuple(t.shape), t.stride(), t.dtype, t.device)
                       if isinstance(t, torch.Tensor) else t for t in flat)


def addresses(modules: Sequence[torch.nn.Module]) -> Hashable:
    """The addresses of ``modules``' own parameters and buffers (a child's
    count where the child is in ``modules``)."""
    return tuple(t.data_ptr() for m in modules
                 for t in (*m._parameters.values(), *m._buffers.values()) if t is not None)


def tf32_key() -> Hashable:
    """The TF32 flags, which a captured matmul or convolution keeps."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def hooked(modules: Sequence[torch.nn.Module]) -> bool:
    """Whether a forward or backward hook is registered on any of
    ``modules`` or globally: a replay would skip it."""
    from torch.nn.modules import module as M

    if (M._global_forward_hooks or M._global_forward_pre_hooks or M._global_backward_hooks
            or M._global_backward_pre_hooks):
        return True
    return any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
               or m._backward_pre_hooks for m in modules)


def eligible(device: torch.device, leaves: Sequence) -> bool:
    """Whether work on ``device`` whose inputs are ``leaves`` can replay:
    ``device`` the current CUDA device with every input a tensor on it,
    autocast off, tracing off and no capture already open.  The caller adds
    what only it can see (the autograd mode it captures in, its options)."""
    return (device.type == "cuda" and device.index == torch.cuda.current_device()
            and all(isinstance(t, torch.Tensor) and t.device == device for t in leaves)
            and not torch.is_autocast_enabled("cuda") and not spans.on()
            and not torch.cuda.is_current_stream_capturing())


# --------------------------------------------------------------- capture


class Segments(NamedTuple):
    """The work of a view or a step, split where its composites launch.

    - ``front(x) -> (mid, passes, regs)``: graph A on the inputs ``x``:
      every render's :class:`soar_tpu_torch.render.tiled.Passes`, the
      other outputs that carry a gradient to graph B (``regs``: a step's
      regularisers) and ``mid``, what B reads of A that carries none
      (each render's ``Passes.finish``, not the passes, so that graph B's
      capture can reuse the memory of the composites' unpacked arguments);
    - ``back(x, mid, results, regs)``: graph B, with ``results[i]`` the
      composite outputs of ``passes[i]`` as
      :func:`soar_tpu_torch.render.block_composite.composite_block`
      returns them; it returns the outputs, or ``(loss, outputs)`` with
      autograd on;
    - ``eager(x)``: the whole work eagerly, a step's backward included (a
      key's first call);
    - ``params``: with autograd on, the module whose parameters graph A
      reads and differentiates.
    """

    front: Callable
    back: Callable
    eager: Callable
    params: Optional[torch.nn.Module] = None


class _Call(torch.nn.Module):
    """``fn`` as the forward of a module that holds ``params``, so that
    :func:`torch.func.functional_call` can swap their tensors for a call."""

    def __init__(self, params: torch.nn.Module, fn: Callable):
        super().__init__()
        self.params, self.fn = params, fn

    def forward(self, *args):
        return self.fn(*args)


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


def _each_once(fn: Callable, tree):
    """``tree`` with ``fn`` applied to each tensor once: a tensor two
    leaves share stays shared."""
    memo = {}

    def one(v):
        if not isinstance(v, torch.Tensor):
            return v
        if id(v) not in memo:
            memo[id(v)] = fn(v)
        return memo[id(v)]

    return pytree.tree_map(one, tree)


class _Captured:
    """One capture of :class:`Segments` on the inputs ``x``: graphs A and B
    (and, with autograd on, their backward graphs) in one memory pool,
    their input tensors and their outputs."""

    def __init__(self, seg: Segments, x):
        self.static = [t.detach().clone() for t in leaves(x)]
        xs = rebuild(x, self.static)
        self.grad = torch.is_grad_enabled()
        pool = torch.cuda.graph_pool_handle()
        self.fa, self.fb = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        front = seg.front
        if self.grad:
            # Graph A reads the parameters through aliases (the same memory,
            # fresh autograd leaves): a graph of an earlier step that is
            # still alive holds the parameters' gradient accumulators, made
            # on another stream, and the capture must not wait on that stream.
            named = list(seg.params.named_parameters())
            aliases = {f"params.{n}": p.detach().requires_grad_(p.requires_grad) for n, p in named}
            param_of = {id(a): p for a, (_, p) in zip(aliases.values(), named)}
            call = _Call(seg.params, seg.front)

            def front(xs):
                return torch.func.functional_call(call, aliases, (xs,))

        with torch.cuda.graph(self.fa, pool=pool):
            mid, passes, regs = front(xs)
            packed = [(block_composite.kernel_inputs(*job), p.consts)
                      for p in passes for job in p.jobs]
            counts = [len(p.jobs) for p in passes]
            del passes  # the composites' unpacked arguments: A's memory to reuse
        self.n_passes = len(counts)
        a_out = [f for (f, _), _ in packed] + list(regs)
        self.pixf = [p for (_, p), _ in packed]
        self.consts = [tuple(map(float, c)) for _, c in packed]
        self.b_in = [torch.empty(s, dtype=torch.float32, device=f.device, requires_grad=self.grad)
                     for (f, p), _ in packed for s in _result_shapes(f, p)]
        self.b_in += [torch.empty_like(r).requires_grad_(self.grad) for r in regs]
        n_res = 3 * len(packed)
        with torch.cuda.graph(self.fb, pool=pool):
            it = (block_composite.kernel_outputs(*self.b_in[i:i + 3]) for i in range(0, n_res, 3))
            results = [[next(it) for _ in range(n)] for n in counts]
            out = seg.back(xs, mid, results, self.b_in[n_res:])
        del mid, results
        self.need = [True] * n_res
        self.leaves = []
        if self.grad:
            loss, out = out
            self._capture_backward(loss, a_out, len(packed), len(regs), pool, param_of)
            self.loss = loss.detach()
        self.n_feats = len(packed)
        self.a_out = [o.detach() for o in a_out]
        self.out = _each_once(torch.Tensor.detach, out)

    def _capture_backward(self, loss, a_out, n_jobs, n_regs, pool, param_of):
        """B's and A's backward graphs, B's first (its input gradients are
        A's output gradients)."""
        stray = [t for t in _leaves_reached([loss]) if not any(t is b for b in self.b_in)]
        if stray:
            raise RuntimeError(f"graph B reads {len(stray)} leaf tensor(s) that need a gradient "
                               "other than its inputs; route them through graph A's outputs")
        self.g_loss = torch.empty_like(loss)
        self.bb = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.bb, pool=pool):
            torch.autograd.backward([loss], [self.g_loss], inputs=self.b_in)
        self.b_grads = [t.grad for t in self.b_in]
        # The composite outputs the loss does not differentiate (a gen view's
        # occ pass) go to graph B detached, so that, as in the eager step,
        # their composites launch no backward kernel; A's backward leaves
        # out their kernel inputs.
        self.need = [g is not None for g in self.b_grads[:3 * n_jobs]]
        self.need_a = [any(self.need[3 * j:3 * j + 3]) for j in range(n_jobs)] + [True] * n_regs
        a_diff = [o for o, n in zip(a_out, self.need_a) if n]
        # A's backward leaves each alias's gradient in a tensor of its own
        # (the aliases have no .grad yet, so none is added to).
        reached = _leaves_reached(a_diff)
        if any(id(t) not in param_of for t in reached):
            raise RuntimeError("graph A reads a leaf tensor that needs a gradient and is not a "
                               "parameter of the segments' module")
        self.g_a = [torch.empty_like(o) for o in a_diff]
        self.ba = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.ba, pool=pool):
            torch.autograd.backward(a_diff, self.g_a, inputs=reached)
        # Each parameter's gradient: the tensor the backward graph writes,
        # which becomes its .grad after every replay.
        self.leaves = [param_of[id(t)] for t in reached]
        self.grads = [t.grad for t in reached]

    def replay_a(self) -> List[torch.Tensor]:
        self.fa.replay()
        return self.a_out

    def replay_b(self, inputs: Sequence[torch.Tensor]):
        for s, t in zip(self.b_in, inputs):
            s.copy_(t)
        self.fb.replay()

    def run(self, flat: Sequence[torch.Tensor]):
        for s, t in zip(self.static, flat):
            s.copy_(t)
        if self.grad:
            VIEWS.grad_view(self.n_passes)
            outs = _ReplayA.apply(self, *self.leaves)
        else:
            outs = self.replay_a()
        feats, regs = outs[:self.n_feats], outs[self.n_feats:]
        results = [t for f, p, c in zip(feats, self.pixf, self.consts)
                   for t in block_composite.composite_kernel(f, p, *c)]
        results = [t if n else t.detach() for t, n in zip(results, self.need)]
        if not self.grad:
            self.replay_b([*results, *regs])
            return _each_once(torch.Tensor.clone, self.out)
        loss = _ReplayB.apply(self, *results, *regs)
        del results
        out = _each_once(torch.Tensor.clone, self.out)
        loss.backward()
        for leaf, g in zip(self.leaves, self.grads):
            leaf.grad = g
        return out


class _ReplayA(torch.autograd.Function):
    """Graph A: replays its forward graph; the backward copies the incoming
    gradients in and replays its backward graph, which leaves the
    parameters' gradients in the capture's own tensors."""

    @staticmethod
    def forward(ctx, cap: _Captured, *leaves):
        ctx.cap, ctx.n = cap, len(leaves)
        ctx.set_materialize_grads(False)
        return tuple(o.detach() for o in cap.replay_a())

    @staticmethod
    def backward(ctx, *grads):
        cap = ctx.cap
        for s, g in zip(cap.g_a, (g for g, n in zip(grads, cap.need_a) if n)):
            s.copy_(g)
        cap.ba.replay()
        return (None,) * (1 + ctx.n)


class _ReplayB(torch.autograd.Function):
    """Graph B: copies the composites' outputs and A's other outputs in and
    replays its forward graph; the backward replays its backward graph and
    hands back their gradients."""

    @staticmethod
    def forward(ctx, cap: _Captured, *inputs):
        ctx.cap = cap
        cap.replay_b(inputs)
        return cap.loss.detach()

    @staticmethod
    def backward(ctx, g_loss):
        cap = ctx.cap
        cap.g_loss.copy_(g_loss)
        cap.bb.replay()
        return (None,) + tuple(g if g is None else g.detach() for g in cap.b_grads)


def run(policy: Policy, key: Hashable, seg: Segments, x, counts):
    """The outputs of :class:`Segments` on the inputs ``x`` (an
    :func:`eligible` call), with autograd on after their backward, the
    parameters' gradients in ``.grad``: eager on a key's first call,
    captured and replayed on its second, replayed after.  ``key`` is what
    the work reads in place; ``counts`` (the caller's function) gets
    ``eager``, ``captures`` and ``replays`` counted."""
    key = (key, structure(x), tf32_key())
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
