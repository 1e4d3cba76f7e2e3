"""The program's spans and counters (``soar_tpu_torch.core.spans``) in a
profiled window of a cell's units: each span's device, idle and host time a
unit, the counters a unit, and the per-layer numbers they give.

    python3 -m benchmark.spans --workload <cell> --seed <n> [--units <k>]

sets the cell up as a run does, profiles ``--units`` units (the mix's
``trace_host_units`` by default; the host's ops and the device) with the
program's tracing on, and prints one JSON object as the last line of
standard output (and to ``--out``): ``spans`` (per span: calls, host ms
inclusive and self, device ms, idle ms, each a unit, and the kernels that
took most of its device time), ``counters`` (a unit, by span), the shares
of device time and of idle time the spans hold, and ``readings`` (the
per-layer numbers, below).  Needs a program with ``core/spans.py``; not
part of a run.  The command stands in until the readings are registered as
per-layer metrics; then ``benchmark/trace.py:traced`` calls
:func:`span_table` and :func:`readings` and the command goes.

Attribution, on the profiler's one clock:

- a kernel goes to the innermost ``soar.*`` span open around the host op
  that launched it, on the launching thread;
- a kernel that a backward node launched goes to the span of the forward op
  that made the node (the same forward thread and ``sequence_nr``); a node
  that matches no forward op in a span stays in ``soar.backward``;
- each gap between the merged kernel intervals goes to the innermost
  ``soar.*`` span open at its middle, else to ``(outside spans)``.

The readings, a unit (``.train`` a step, ``.view`` a view):
``field_ms`` (``soar.field``'s device ms, forward and backward),
``raster_front_ms`` (``soar.raster.preprocess``, ``.sort`` and ``.gather``),
``lpips_ms`` and ``optim_ms`` (steps only), ``host_syncs`` (all spans) and
``sort_key_use`` (100 × ``raster.keys_in_tiles`` / ``raster.keys``: the
share of the sorted keys that land in a tile).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
from collections import defaultdict
from typing import Dict, Optional

PREFIX = "soar."
BACKWARD = "soar.backward"
OUTSIDE = "(outside spans)"
NODE = "autograd::engine::evaluate_function: "
FRONT_END = ("soar.raster.preprocess", "soar.raster.sort", "soar.raster.gather")
SUFFIX = {"step": "train", "view": "view"}
TOP_KERNELS = 5  # kernels listed under each span, by device time


def _host(events):
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CPU]


def owner_of(host_events):
    """``owner(event) -> span name`` over the host events of one profile:
    the innermost ``soar.*`` span enclosing the event on its thread, the
    span of the forward op behind an enclosing backward node, or
    :data:`OUTSIDE`."""
    in_node: Dict[int, bool] = {}

    def under_node(e) -> bool:
        chain, p, found = [], e, False
        while p is not None:
            if id(p) in in_node:
                found = in_node[id(p)]
                break
            chain.append(p)
            if p.name.startswith(NODE):
                found = True
                break
            p = p.cpu_parent
        for c in chain:
            in_node[id(c)] = found
        return found

    forward = {}
    for e in host_events:
        if e.sequence_nr >= 0 and not under_node(e):
            key = (e.thread, e.sequence_nr)
            if key not in forward or e.time_range.start >= forward[key].time_range.start:
                forward[key] = e  # the node's maker: the last op to record its number
    memo: Dict[int, str] = {}

    def owner(e) -> str:
        chain, p, found = [], e, OUTSIDE
        while p is not None:
            if id(p) in memo:
                found = memo[id(p)]
                break
            chain.append(p)
            if p.name.startswith(PREFIX):
                found = p.name
                break
            if p.name.startswith(NODE):
                f = forward.get((p.fwd_thread, p.sequence_nr)) if p.sequence_nr >= 0 else None
                found = owner(f) if f is not None else OUTSIDE
                if found == OUTSIDE:
                    found = BACKWARD
                break
            p = p.cpu_parent
        for c in chain:
            memo[id(c)] = found
        return found

    return owner


def span_intervals(host_events):
    """The ``soar.*`` span events as (start_us, end_us, name, parent span),
    sorted by start; the parent is the nearest enclosing span on the
    thread, or None."""
    out = []
    for e in host_events:
        if not e.name.startswith(PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIX):
            p = p.cpu_parent
        out.append((e.time_range.start, e.time_range.end, e.name,
                    None if p is None else p.name))
    return sorted(out)


def idle_by_span(merged, spans) -> Dict[str, float]:
    """Seconds of each gap between the merged kernel intervals, by the
    innermost span (the latest started one still open) at its middle."""
    starts = [s[0] for s in spans]
    out = defaultdict(float)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        label = OUTSIDE
        for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if spans[j][1] >= mid:
                label = spans[j][2]
                break
        out[label] += (s1 - e0) * 1e-6
    return dict(out)


def span_table(events, units: int, counts: Optional[Dict] = None) -> Optional[Dict]:
    """Per span: calls, host ms (inclusive, self), device ms (self,
    forward and mapped backward) and idle ms, each a unit; the counters a
    unit; the shares of device and idle time the spans hold.  None where
    the window has no span."""
    from .trace import _merge, split_events

    host = _host(events)
    spans = span_intervals(host)
    if not spans:
        return None
    owner = owner_of(host)
    device = defaultdict(float)
    by_kernel = defaultdict(lambda: defaultdict(float))
    for e in host:
        if e.kernels:
            o = owner(e)
            for k in e.kernels:
                device[o] += k.duration * 1e-6
                by_kernel[o][k.name[:80]] += k.duration * 1e-6
    dev, _ = split_events(events)
    kernel_s = sum(e - s for _, s, e in dev) * 1e-6
    merged = _merge([(s, e) for _, s, e in dev])
    idle = idle_by_span(merged, spans)
    calls, incl, child = defaultdict(int), defaultdict(float), defaultdict(float)
    for s, e, name, parent in spans:
        calls[name] += 1
        incl[name] += (e - s) * 1e-6
        if parent is not None:
            child[parent] += (e - s) * 1e-6
    names = sorted(set(calls) | set(device) | set(idle),
                   key=lambda n: -(device.get(n, 0.0) + idle.get(n, 0.0)))
    ms = 1e3 / units
    rows = {n: {"calls": calls.get(n, 0) / units,
                "host_ms": incl.get(n, 0.0) * ms,
                "host_self_ms": (incl.get(n, 0.0) - child.get(n, 0.0)) * ms,
                "device_ms": device.get(n, 0.0) * ms,
                "idle_ms": idle.get(n, 0.0) * ms,
                "kernels_ms": [[k, v * ms] for k, v in sorted(
                    by_kernel[n].items(), key=lambda kv: -kv[1])[:TOP_KERNELS]]}
            for n in names}
    in_spans = sum(v for n, v in device.items() if n != OUTSIDE)
    idle_s = sum(idle.values())
    return {
        "units": units,
        "spans": rows,
        "counters": {k: {sp: v / units for sp, v in by.items()}
                     for k, by in (counts or {}).items()},
        "device_ms": kernel_s * ms,
        "busy_ms": sum(e - s for s, e in merged) * 1e-3 / units,
        "idle_ms": idle_s * ms,
        "device_in_spans": in_spans / kernel_s if kernel_s > 0 else None,
        "device_unlinked": 1.0 - sum(device.values()) / kernel_s if kernel_s > 0 else None,
        "idle_outside": idle.get(OUTSIDE, 0.0) / idle_s if idle_s > 0 else None,
    }


def readings(table: Optional[Dict], unit: str) -> Dict[str, Optional[float]]:
    """The per-layer numbers of a span table, named for the unit
    (``field_ms.train``, ``sort_key_use.view``, ...); None where the table
    has nothing to read."""
    sfx = SUFFIX[unit]
    names = ["field_ms", "raster_front_ms", "host_syncs", "sort_key_use"]
    if unit == "step":
        names += ["lpips_ms", "optim_ms"]
    out = {f"{n}.{sfx}": None for n in names}
    if table is None:
        return out
    rows, ctr = table["spans"], table["counters"]

    def dev(*spans):
        got = [rows[s]["device_ms"] for s in spans if s in rows]
        return sum(got) if got else None

    def total(name):
        return sum(ctr[name].values()) if name in ctr else None

    out[f"field_ms.{sfx}"] = dev("soar.field")
    out[f"raster_front_ms.{sfx}"] = dev(*FRONT_END)
    out[f"host_syncs.{sfx}"] = total("host_syncs") or 0.0
    keys, in_tiles = total("raster.keys"), total("raster.keys_in_tiles")
    if keys:
        out[f"sort_key_use.{sfx}"] = 100.0 * in_tiles / keys
    if unit == "step":
        out["lpips_ms.train"] = dev("soar.lpips")
        out["optim_ms.train"] = dev("soar.optim")
    return out


def measure(cell, mix: Dict, units: Optional[int] = None) -> Dict:
    """The span table of ``units`` units (the mix's ``trace_host_units``
    by default) of a set-up cell, its readings, the idle gaps by host op
    and one unit's aten ops with tracing off and on."""
    from soar_tpu_torch.core import spans

    from .trace import busy_and_breakdown, host_ops, profile_units, split_events

    n = units or mix["trace_host_units"]
    _, events = profile_units(cell.unit_call, n, ranges=spans.tracing)
    table = span_table(events, n, spans.counters())
    dev, host = split_events(events)
    gaps = busy_and_breakdown(dev, host)["idle_gaps"]
    del events, dev, host
    aten_off = host_ops(cell.unit_call)
    with spans.tracing():
        aten_on = host_ops(cell.unit_call)
    spans.counters()
    return {"unit": cell.unit, "readings": readings(table, cell.unit), "table": table,
            "idle_gaps": gaps, "aten_ops": {"off": aten_off, "on": aten_on}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=None,
                    help="units profiled (default: the mix's trace_host_units)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from . import harness
    from .cell import sync

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    with open(harness.ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    _, cfg, mix, _ = harness.cell_spec(bench, args.workload)
    device = torch.device("cuda")
    cell = harness.runner(mix).Cell(cfg, mix, args.seed, device)
    cell.warmup()
    sync(device)
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(device)}
    out.update(measure(cell, mix, args.units))
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
