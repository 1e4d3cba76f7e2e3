"""Spans and counters at the port's layer boundaries, off by default.

With tracing off (the default), :func:`span` returns one shared null
context and :func:`spanned` calls straight through: no allocation, no aten
op, no clock read.  Call sites guard any counter argument that computes on
the device behind :func:`on`, so that tracing off adds no op::

    if spans.on():
        spans.count("raster.keys_in_tiles", counts.sum())

Inside ``with tracing():`` each span is a profiler range on the host
timeline of ``torch.profiler`` (the clock its CUDA kernels are placed on),
so a profiler open around the work sees every span; a span's parent is the
span enclosing it on its thread.  The root span of a unit (``soar.step``,
or ``soar.render`` when no step is open) numbers the unit (``"step 0"``,
``"view 3"``, counted since tracing turned on), and every span of the unit
carries that id as its range's ``unit`` argument (which the profiler keeps
under ``record_shapes``).  Counters add up by name and by the innermost
span open where they are counted; :func:`counters` reads them once.  With
CUDA, every synchronising CUDA operation inside the block (a blocking copy,
``.item()``, a data-dependent shape: ``torch.cuda.set_sync_debug_mode``)
counts as ``host_syncs``.

The spans, outermost first: ``soar.step`` (a training step), ``soar.draws``
(its random draws), ``soar.batch`` (its GT batch), ``soar.render`` (a
view), ``soar.pose`` (LBS and the surfel frames; inside it ``soar.pose.lbs``,
the body model's forward, and ``soar.pose.skin``, the surfels' skinning
blend), ``soar.field`` (the attribute field's query),
``soar.raster.preprocess`` / ``.sort`` / ``.gather`` (the rasterizer's
front end), ``soar.composite`` (one composite call), ``soar.losses``,
``soar.lpips``, ``soar.guidance``, ``soar.backward`` and ``soar.optim``;
beside the steps, ``soar.densify`` (a GaussianDreamer ``maintain`` that
changes the surfels, re-skinning included).  The counters: ``host_syncs``,
``raster.keys`` (the keys a sort sorts), ``raster.keys_in_tiles`` (those
that land in a tile),
``raster.dropped`` and ``raster.capped`` (the overflow canaries), and
``densify.cloned``, ``densify.split``, ``densify.pruned`` (the slots a
densify filled by clone and by split, the surfels a prune took away) and
``densify.alive`` (the surfels alive after a ``soar.densify``).  A view
or step run while tracing is on runs eagerly, never from the CUDA graphs
of :mod:`soar_tpu_torch.render.graphs`, so its spans and counters read the
same in every view and step.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import warnings
from collections import defaultdict
from typing import Dict, Optional

import torch

OUTSIDE = "(outside spans)"
SYNC_MESSAGE = "called a synchronizing CUDA operation"

_NULL = contextlib.nullcontext()


class _State:
    """The process's tracing switch, the span stack of each thread, the
    counters and the open unit."""

    def __init__(self):
        self.on = False
        self.local = threading.local()
        self.lock = threading.Lock()
        self.ints = defaultdict(int)  # (name, span) -> int
        self.tensors: Dict = {}  # (name, span) -> int64 device accumulator
        self.units = defaultdict(int)  # unit kind -> roots opened
        self.unit: Optional[str] = None  # id of the open unit


_S = _State()


def on() -> bool:
    """Whether tracing is on: the guard of a counter whose argument
    computes on the device."""
    return _S.on


def _stack():
    st = getattr(_S.local, "stack", None)
    if st is None:
        st = _S.local.stack = []
    return st


def _innermost() -> str:
    """The innermost span open on this thread, or :data:`OUTSIDE`."""
    st = _stack()
    return st[-1] if st else OUTSIDE


class _Span:
    __slots__ = ("name", "kind", "root", "rf")

    def __init__(self, name: str, kind: Optional[str]):
        self.name, self.kind = name, kind

    def __enter__(self):
        self.root = self.kind is not None and _S.unit is None
        if self.root:
            with _S.lock:
                n = _S.units[self.kind]
                _S.units[self.kind] = n + 1
            _S.unit = f"{self.kind} {n}"
        # The profiler's fast range: no op dispatched (``record_function``
        # dispatches two), and keyword values kept beside the range.
        self.rf = torch._C._profiler._RecordFunctionFast(
            self.name, keyword_values={"unit": _S.unit} if _S.unit else {})
        self.rf.__enter__()
        _stack().append(self.name)
        return self

    def __exit__(self, *exc):
        _stack().pop()
        self.rf.__exit__(*exc)
        if self.root:
            _S.unit = None
        return False


def span(name: str, unit: Optional[str] = None):
    """A span named ``name`` around the block; ``unit`` (``"step"``,
    ``"view"``) makes it the root of a new unit of that kind when no unit is
    open.  Tracing off: the shared null context."""
    if not _S.on:
        return _NULL
    return _Span(name, unit)


def spanned(name: str, unit: Optional[str] = None):
    """Decorates a function with :func:`span` around each call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _S.on:
                return fn(*args, **kwargs)
            with _Span(name, unit):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def count(name: str, value):
    """Adds ``value`` to counter ``name`` of the innermost open span: a
    Python int, or a device tensor added into a device accumulator (int64)
    with no host read.  Tracing off: nothing."""
    if not _S.on:
        return
    key = (name, _innermost())
    if isinstance(value, torch.Tensor):
        v = value.detach().to(torch.int64, copy=True)
        with _S.lock:
            acc = _S.tensors.get(key)
            if acc is None:
                _S.tensors[key] = v
            else:
                acc.add_(v)
    else:
        with _S.lock:
            _S.ints[key] += int(value)


def counters() -> Dict[str, Dict[str, int]]:
    """Every counter by name, then by span, read (one host read per device
    for all the accumulators) and reset.  The read itself is not counted as
    a host sync."""
    with _S.lock:
        ints, tensors = dict(_S.ints), dict(_S.tensors)
        _S.ints.clear()
        _S.tensors.clear()
    out: Dict[str, Dict[str, int]] = defaultdict(dict)
    for (name, sp), v in ints.items():
        out[name][sp] = v
    by_dev = defaultdict(list)
    for key, t in tensors.items():
        by_dev[t.device].append((key, t))
    was, _S.on = _S.on, False
    try:
        for items in by_dev.values():
            vals = torch.stack([t.reshape(()) for _, t in items]).tolist()
            for ((name, sp), _), v in zip(items, vals):
                out[name][sp] = out[name].get(sp, 0) + int(v)
    finally:
        _S.on = was
    return dict(out)


def _on_warning(show):
    """A ``warnings.showwarning`` that counts the synchronising-operation
    warnings as ``host_syncs`` and hands every other warning to ``show``."""
    def hook(message, category, filename, lineno, file=None, line=None):
        if SYNC_MESSAGE in str(message):
            count("host_syncs", 1)
        else:
            show(message, category, filename, lineno, file, line)
    return hook


@contextlib.contextmanager
def tracing(enabled: bool = True):
    """Spans and counters on (``enabled``) or off inside the block; the
    previous state, CUDA's sync-debug mode and the warning filters are
    restored on exit.  Turning tracing on clears the counters and numbers
    the units from 0 again."""
    prev = _S.on
    with contextlib.ExitStack() as stack:
        if enabled and not prev:
            counters()
            _S.units.clear()
            stack.enter_context(warnings.catch_warnings())
            warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
            warnings.filterwarnings("ignore", message="Synchronization debug mode is a prototype")
            warnings.showwarning = _on_warning(warnings.showwarning)
            if torch.cuda.is_available():
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
                stack.callback(torch.cuda.set_sync_debug_mode, mode)
        _S.on = enabled
        try:
            yield
        finally:
            _S.on = prev
