"""What a ``--trace 1`` run reads, from the benchmark's own hooks around the
program: a profiled window of the cell's units (device kernels and the
host's ops and ranges, ``torch.profiler`` / CUPTI), the aten ops one unit
dispatches, and the composite kernels' launches in one unit with their
device time.  The per-layer readers under ``benchmark/metrics`` take their
numbers from the context :func:`traced` returns.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

TOP = 10  # entries of each breakdown list
SCAN = 5000  # host events looked back through for the one open at a gap


def _merge(intervals):
    """Union of [start, end) intervals, sorted and merged."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_units(run_unit, n: int, ranges=contextlib.nullcontext, host: bool = True):
    """Runs ``n`` units under the profiler (CUDA activity, and with ``host``
    the CPU's ops too), with ``ranges()`` open around them, and returns the
    host wall seconds of the window (from a synchronised start to the
    synchronise after the last unit) and the profiler's events."""
    from torch.profiler import ProfilerActivity, profile

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    cuda = torch.cuda.is_available()
    acts = ([ProfilerActivity.CUDA] if cuda else []) + (
        [ProfilerActivity.CPU] if host or not cuda else [])
    with profile(activities=acts) as prof:
        with ranges():
            t0 = time.perf_counter()
            for _ in range(n):
                run_unit()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return wall, prof.events()


def split_events(events):
    """(device events, host events) as (name, start_us, end_us); a host
    range mirrored on the device timeline (``record_function``) is not a
    kernel and is left out of the device events."""
    from torch.autograd import DeviceType

    host, dev = [], []
    for ev in events:
        tr = ev.time_range
        row = (ev.name, tr.start, tr.end)
        (dev if ev.device_type == DeviceType.CUDA else host).append(row)
    host_names = {r[0] for r in host}
    return [r for r in dev if r[0] not in host_names], host


def busy_and_breakdown(dev, host) -> Dict:
    """Device busy seconds (the union of the kernels' intervals), the
    kernels that took most device time by name, and the idle gaps between
    kernels summed by the innermost host op or range open at the gap's
    middle."""
    merged = _merge([(s, e) for _, s, e in dev])
    busy_us = sum(e - s for s, e in merged)
    by_kernel = defaultdict(float)
    for name, s, e in dev:
        by_kernel[name] += (e - s) * 1e-6
    host = sorted(host, key=lambda r: r[1])
    starts = [r[1] for r in host]
    gaps = defaultdict(float)
    for (s0, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        label = "(python, between ops)"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - SCAN, -1), -1):
            if host[j][2] >= mid:  # the latest-started op still open
                label = host[j][0]
                break
        gaps[label] += (s1 - e0) * 1e-6
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k[:120], v] for k, v in idle], "kernel_s": dict(by_kernel)}


def host_ops(fn) -> int:
    """The aten ops ``fn`` dispatches (``chip_smoke.host_ops``'s count)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    rec = Count()
    with rec:
        fn()
    return rec.ops


@contextlib.contextmanager
def record_launches():
    """Inside the block, the inputs of every ``composite_fwd`` and
    ``composite_bwd`` launch through ``render.block_composite``'s launch
    functions are copied (``chip_smoke.record_launches``): yields the two
    lists of (feat, pixf).  Yields two empty lists where the program has no
    such launch functions."""
    from soar_tpu_torch.render import block_composite as bc

    fwd, bwd = [], []
    lf, lb = getattr(bc, "_launch_fwd", None), getattr(bc, "_launch_bwd", None)
    if lf is None or lb is None:
        yield fwd, bwd
        return

    def rec_fwd(feat, pixf, *rest):
        fwd.append((feat.detach().clone(), pixf.clone()))
        return lf(feat, pixf, *rest)

    def rec_bwd(feat, pixf, *rest):
        bwd.append((feat.detach().clone(), pixf.clone()))
        return lb(feat, pixf, *rest)

    bc._launch_fwd, bc._launch_bwd = rec_fwd, rec_bwd
    try:
        yield fwd, bwd
    finally:
        bc._launch_fwd, bc._launch_bwd = lf, lb


@contextlib.contextmanager
def module_ranges(modules: Dict[str, torch.nn.Module], backward: List[str]):
    """``record_function`` ranges named ``bench.<name>.forward`` around each
    module's forward and ``bench.<name>.backward`` around the backward of
    the modules named in ``backward``, opened and closed by hooks."""
    from torch.autograd.profiler import record_function

    handles, open_ = [], {}

    def opener(key):
        def hook(*_):
            r = record_function(key)
            r.__enter__()
            open_[key] = r
        return hook

    def closer(key):
        def hook(*_):
            r = open_.pop(key, None)
            if r is not None:
                r.__exit__(None, None, None)
        return hook

    for name, m in modules.items():
        k = f"bench.{name}.forward"
        handles += [m.register_forward_pre_hook(opener(k)), m.register_forward_hook(closer(k))]
        if name in backward:
            k = f"bench.{name}.backward"
            handles += [m.register_full_backward_pre_hook(opener(k)),
                        m.register_full_backward_hook(closer(k))]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def range_device_s(events, prefix: str) -> float:
    """Device seconds of the kernels launched inside host ranges whose name
    starts with ``prefix`` (a range's ``device_time_total`` sums its ops'
    kernels)."""
    from torch.autograd import DeviceType

    return sum(ev.device_time_total for ev in events
               if ev.device_type == DeviceType.CPU and ev.name.startswith(prefix)) * 1e-6


def traced(cell, mix: Dict) -> Dict:
    """The context the per-layer readers read:

    - a window of ``mix["trace_units"]`` units with the device's activity
      alone traced (the host's op tracing would slow the host and inflate
      the idle share): busy seconds, the window's length, the kernels that
      took most time;
    - a window of ``mix["trace_host_units"]`` units with the host's ops and
      the cell's ranges traced too: the idle gaps by the host op open in
      them, the device seconds inside the cell's ranges;
    - one unit's aten ops;
    - one unit's composite launches, with the composite kernels' device
      seconds in it."""
    n = mix["trace_units"]
    wall, events = profile_units(cell.unit_call, n, host=False)
    dev, _ = split_events(events)
    ctx = {"unit": cell.unit, "units": n, "window_s": wall}
    ctx.update(busy_and_breakdown(dev, []))
    del events, dev
    nh = mix["trace_host_units"]
    ranges = getattr(cell, "trace_ranges", contextlib.nullcontext)
    _, events = profile_units(cell.unit_call, nh, ranges)
    dev, host = split_events(events)
    ctx["idle_gaps"] = busy_and_breakdown(dev, host)["idle_gaps"]
    ctx["range_device_s_per_unit"] = range_device_s(events, "bench.") / nh
    del events, dev, host
    ctx["aten_ops"] = host_ops(cell.unit_call)
    with record_launches() as (fwd, bwd):
        _, ev1 = profile_units(cell.unit_call, 1, host=False)
    d1, _ = split_events(ev1)
    ctx["launches"] = {"composite_fwd": fwd, "composite_bwd": bwd}
    ctx["launch_kernel_s"] = {
        k: sum((e - s) * 1e-6 for name, s, e in d1 if k in name)
        for k in ("composite_fwd", "composite_bwd")}
    if hasattr(cell, "flops"):
        ctx["flops"] = cell.flops()
    return ctx


# ------------------------------------------------- what the readers compute


def idle_share(ctx: Dict, unit: str):
    """% of the traced window with no kernel on the device."""
    if ctx.get("unit") != unit or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])


def mfu(ctx: Dict, unit: str):
    """% of the peaks that a unit's useful work reaches in the traced
    window's time a unit."""
    from .counts.composite import launch_bounds
    from .counts.peaks import H100_BF16_FLOPS, H100_F32_FLOPS

    if ctx.get("unit") != unit or "flops" not in ctx:
        return None
    ops = sum(v["ops"] for v in launch_bounds(ctx).values())
    need_s = (ctx["flops"]["bf16"] / H100_BF16_FLOPS
              + (ctx["flops"]["f32"] + ops) / H100_F32_FLOPS)
    return 100.0 * need_s / (ctx["window_s"] / ctx["units"])


def roofline(ctx: Dict, unit: str, kernel: str):
    """% of its roofline a composite kernel reaches over the recorded
    unit: the launches' summed least time over the kernel's device time."""
    from .counts.composite import launch_bounds

    if ctx.get("unit") != unit:
        return None
    spent = ctx.get("launch_kernel_s", {}).get(kernel, 0.0)
    b = launch_bounds(ctx).get(kernel, {})
    if spent <= 0.0 or not b.get("launches"):
        return None
    return 100.0 * b["bound_s"] / spent
