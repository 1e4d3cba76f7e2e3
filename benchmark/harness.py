"""One run of one cell: set-up, warm-up, the window (or, with ``trace``,
the traced units), the check against the reference, the result line.

Everything that belongs to a configuration, a traffic mix, a cell's limits
or a per-layer metric sits in its own file, found by the name
``BENCHMARK.json`` gives it:

- ``benchmark/configs/<config>.json`` (the ``file`` of the configuration),
- ``benchmark/traffic/<traffic>.json`` (its ``runner`` names the module
  under ``benchmark/runners`` that runs it; the rest are its parameters),
- ``benchmark/limits/<workload>.json`` (the limit of each number compared),
- ``benchmark/metrics/<metric>.py`` (a per-layer metric's ``read(ctx)``).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from . import cell as C
from .cell import sync

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# Top-level module names that may not be loaded in a run (compared whole:
# ``soar_tpu_torch`` is the program and passes).
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "soar_tpu")


def forbidden_modules():
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def find(kind: str, name: str) -> Dict:
    """A configuration, traffic mix or limits file by name."""
    path = BENCH_DIR / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file benchmark/{kind}/{name}.json")
    return load_json(path)


def reader(name: str):
    """The ``read`` function of per-layer metric ``name``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no metric reader benchmark/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def runner(mix: Dict):
    return importlib.import_module(f"benchmark.runners.{mix['runner']}")


def cell_spec(bench: Dict, workload: str):
    """(workload entry, configuration dict, traffic mix, limits) of a cell."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return wl, load_json(ROOT / entry["file"]), find("traffic", wl["traffic"]), find(
        "limits", wl["name"])


class GcPauses:
    """Python's garbage collections while the block runs: their number and
    seconds (``gc.callbacks``)."""

    def __enter__(self):
        self.n, self.s, self._t = 0, 0.0, 0.0
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.n += 1
            self.s += time.perf_counter() - self._t

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)


def _metrics_of(bench: Dict, key: str, workload: str):
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def run(bench: Dict, workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        device="cuda", cfg_override: Optional[Dict] = None) -> Dict:
    """The result of one run (see ``README.md``); ``cfg_override`` replaces
    the configuration (the tests' small shapes)."""
    device = torch.device(device)
    C.stages_start(t_start)
    wl, cfg, mix, limits = cell_spec(bench, workload)
    cfg = cfg_override or cfg
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    C.stage("imports")
    cell = runner(mix).Cell(cfg, mix, seed, device)
    cell.warmup()
    sync(device)
    setup_s = time.perf_counter() - t_start
    notes = {"setup_stages_s": C.stages()}

    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": int(wl["chips"])}
    out = {}
    if trace:
        from .trace import traced

        ctx = traced(cell, mix)
        metrics = {}
        for m in _metrics_of(bench, "per_layer", workload):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        attempted, failed = ctx["units"], 0
        dev_info.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
        out["breakdown"] = {"device_ops": ctx["device_ops"], "idle_gaps": ctx["idle_gaps"]}
        del ctx
    else:
        with GcPauses() as gcp:
            res = cell.window(seconds)
            sync(device)
        notes["window_gc"] = {"collections": gcp.n, "seconds": gcp.s}
        attempted, failed = res["attempted"], res["failed"]
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        values = dict(res["metrics"], setup_s=setup_s, peak_mem_gib=peak / 2**30)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in _metrics_of(bench, "end_to_end", workload)}
    sync(device)
    dev_info["memory_peak_bytes"] = (int(torch.cuda.max_memory_allocated(device))
                                     if device.type == "cuda" else 0)
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules loaded in the run that the benchmark refuses: {bad}")

    cell.free()
    readings = cell.check()
    checks = {k: {"value": float(v), "limit": float(limits[k])} for k, v in readings.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev_info}
    result.update(out)
    result["notes"] = notes
    result["checks"] = checks
    return result
