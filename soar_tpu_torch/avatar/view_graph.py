"""A view's render replayed from two CUDA graphs around its composite
launches.

Eager, a 512x512 turntable view dispatches about 1,400 aten ops, and on an
H100 the host's dispatch takes longer than the device's work.  With
autograd off a view has fixed shapes (the slot grid, the first-K gather),
so it can be captured once and replayed.  The composite kernel stays
outside the graphs: each launch goes through
:func:`soar_tpu_torch.render.block_composite._launch_fwd`, its own wrapper
with its shape and shared-memory checks, on every call.  A view runs in
three phases:

- graph A: the pose, the field query, preprocess, binning, sort, gathers
  and the packing of each composite's inputs;
- eager: the composite launches (main and occ pass; one with ``lite``,
  three with ``both_faces``), their outputs copied into graph B's inputs;
- graph B: the composites' finish, the untiles and the post ops.

Per call, the inputs that change (the frame's SMPL parameters, the camera,
the background, ``attrs``) are copied into the graphs' own input tensors;
everything else the view reads (the parameters, the field, the body, the
skinning data) is read in place, so an in-place update shows in the next
replay.  The outputs are cloned, so callers own what they get.

A view's key is the image size, the settings, the copied inputs' shapes,
strides and dtypes, and the (address, shape, stride, dtype) of every
tensor of the parameters and of the model.  A key's first call runs the
three phases eagerly; its second runs them eagerly too and then captures
them, so every call launches each composite once; later calls replay.  At
most :data:`HELD` captured views are held, the least recently used dropped
first, and a capture that no view has used in the last :data:`IDLE` views
rendered with autograd on is dropped, so that a training process does not
keep the memory of a view it renders seldom.  A traced view
(:mod:`soar_tpu_torch.core.spans` on) runs eagerly, so that its spans and
counters read as they do everywhere else.  ``render.eager``,
``render.captures`` and ``render.replays`` count the calls of each kind
since import.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Hashable, List

import torch

from ..core import spans
from ..render import block_composite
from ..render.types import RasterConfig

HELD = 2  # captured views held at once (each a pair of graphs and a pool)
REMEMBERED = 16  # keys seen once that are remembered
IDLE = 32  # views rendered with autograd on after which an unused capture is dropped


def _leaves(inputs) -> List:
    """The values copied in per call, in a fixed order: the frame's SMPL
    parameters, the camera's tensors, the background and ``attrs``."""
    fp, camera, bg_color, attrs = inputs
    return [*fp.values(), *camera, bg_color, *(attrs or {}).values()]


def _rebuild(inputs, leaves: List[torch.Tensor]):
    """``inputs`` with its tensors replaced by ``leaves`` (in
    :func:`_leaves`' order)."""
    fp, camera, _, attrs = inputs
    it = iter(leaves)
    return ({k: next(it) for k in fp}, type(camera)(*(next(it) for _ in camera)), next(it),
            None if attrs is None else {k: next(it) for k in attrs})


def eligible(x: torch.Tensor, inputs, cfg: RasterConfig, rows=None) -> bool:
    """Whether a view whose surfels are ``x`` is replayed from graphs: on
    the current CUDA device with every input there, autograd off, autocast
    off, tracing off, the composite kernel, no row sharding and no capture
    already open."""
    return (x.is_cuda and not torch.is_grad_enabled() and rows is None
            and cfg.composite == "kernel" and not torch.is_autocast_enabled("cuda")
            and not spans.on() and not torch.cuda.is_current_stream_capturing()
            and x.device.index == torch.cuda.current_device()
            and all(isinstance(t, torch.Tensor) and t.device == x.device
                    for t in _leaves(inputs)))


class Policy:
    """Which calls capture: a key's first call runs eagerly, its second
    captures, later ones replay; at most ``held`` captures are kept, the
    least recently used dropped first, a capture unused over ``idle``
    views rendered with autograd on is dropped, and the last
    ``remembered`` keys seen once are remembered."""

    def __init__(self, held: int = HELD, remembered: int = REMEMBERED, idle: int = IDLE):
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


_POLICY = Policy()


def grad_view(n: int = 1):
    """Tells the policy that ``n`` views were rendered with autograd on."""
    _POLICY.grad_view(n)


def _tensor_key(x):
    """A tensor's (address, shape, stride, dtype); tuples, dicts and
    anything else hashable as they are."""
    if isinstance(x, torch.Tensor):
        return x.data_ptr(), tuple(x.shape), x.stride(), x.dtype
    if isinstance(x, dict):
        return tuple((k, _tensor_key(v)) for k, v in x.items())
    if isinstance(x, tuple):
        return tuple(map(_tensor_key, x))
    return x


def avatar_key(params, model) -> Hashable:
    """Every tensor of ``params`` and ``model`` by address, and the field's
    configuration: what a capture reads in place of the avatar."""
    return (tuple(map(_tensor_key, params.parameters())),
            tuple(map(_tensor_key, params.buffers())), params.field.cfg,
            tuple(_tensor_key(getattr(model, f.name)) for f in dataclasses.fields(model)))


def tf32_key() -> Hashable:
    """The TF32 flags, which a captured matmul or convolution keeps."""
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def _key(params, model, statics: Hashable, inputs, leaves) -> Hashable:
    """What a captured view depends on beyond the values copied in: the
    image size and settings (``statics``), the copied inputs' structure,
    shapes, strides and dtypes, the avatar (:func:`avatar_key`) and the
    TF32 flags."""
    fp, _, _, attrs = inputs
    return (statics, params.xyz.device, tuple(fp), None if attrs is None else tuple(attrs),
            tuple((tuple(t.shape), t.stride(), t.dtype) for t in leaves),
            avatar_key(params, model), tf32_key())


def _front(passes_fn, inputs):
    """Graph A's work: the passes and each composite's kernel inputs."""
    p = passes_fn(*inputs)
    return p, [block_composite.kernel_inputs(*job) for job in p.jobs]


def _launch(p, feats):
    """The composite launches, each through the kernel's own wrapper,
    looked up at call time."""
    return [block_composite._launch_fwd(feat, pixf, *map(float, p.consts))
            for feat, pixf in feats]


def _back(outputs_fn, p, results, inputs):
    """Graph B's work: the composites' finish and the view's outputs."""
    raster_out = p.finish([block_composite.kernel_outputs(*r) for r in results])
    return outputs_fn(raster_out, inputs[1])


def _clone(out):
    """The render dict (or ``(front, back)`` pair) with every tensor cloned
    once: a tensor the two faces share stays shared."""
    memo = {}

    def clone(v):
        if not isinstance(v, torch.Tensor):
            return v
        if id(v) not in memo:
            memo[id(v)] = v.clone()
        return memo[id(v)]

    def one(d):
        return {k: clone(v) for k, v in d.items()}

    return tuple(map(one, out)) if isinstance(out, tuple) else one(out)


class _Captured:
    """One view's two graphs, their input tensors and their outputs,
    captured after an eager run of the same view whose composites returned
    ``results`` (their shapes are graph B's inputs')."""

    def __init__(self, inputs, leaves, passes_fn, outputs_fn, results):
        self.static = [t.clone() for t in leaves]
        tree = _rebuild(inputs, self.static)
        self.a, self.b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.a):
            self.passes, self.feats = _front(passes_fn, tree)
            self.results = [tuple(torch.empty_like(t) for t in r) for r in results]
        with torch.cuda.graph(self.b, pool=self.a.pool()):
            self.out = _back(outputs_fn, self.passes, self.results, tree)

    def run(self, leaves):
        for s, t in zip(self.static, leaves):
            s.copy_(t)
        self.a.replay()
        for got, static in zip(_launch(self.passes, self.feats), self.results):
            for s, t in zip(static, got):
                s.copy_(t)
        self.b.replay()
        return _clone(self.out)


def render(params, model, statics: Hashable, inputs, passes_fn: Callable,
           outputs_fn: Callable):
    """An :func:`eligible` view's outputs: run eagerly on a key's first
    call, run eagerly and captured on its second, replayed after.

    ``statics`` (hashable: the image size, the settings) and ``inputs``
    (``(fp, camera, bg_color, attrs)``, copied in per call) key the view
    with ``params`` and ``model``, which it reads in place.
    ``passes_fn(*inputs)`` returns the view's
    :class:`soar_tpu_torch.render.tiled.Passes`, ``outputs_fn(raster_out,
    camera)`` its outputs from ``Passes.finish``'s."""
    leaves = _leaves(inputs)
    key = _key(params, model, statics, inputs, leaves)
    entry, kind = _POLICY.lookup(key)
    _tally(kind)
    if entry is not None:
        return entry.run(leaves)
    p, feats = _front(passes_fn, inputs)
    results = _launch(p, feats)
    out = _back(outputs_fn, p, results, inputs)
    if kind == "capture":
        _POLICY.hold(key, _Captured(inputs, leaves, passes_fn, outputs_fn, results))
    return out


def _tally(kind: str):
    name = {"eager": "eager", "capture": "captures", "replay": "replays"}[kind]
    setattr(render, name, getattr(render, name) + 1)


# Calls of each kind since import.
render.eager = 0
render.captures = 0
render.replays = 0
