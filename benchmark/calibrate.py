"""The readings a cell's limits are set from, on the chip at the cell's own
size, several seeds in one process (see ``PERF.md``, "How the limits were
set")::

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control 4,5,6]
        [--faults 7,8,9]

For each ``--seeds`` seed: the program's set-up (with the checked steps of a
training cell, or one pass of the turntable's views at the cell's load),
then the numbers compared with the reference.  For each ``--control`` seed:
the control (the reference a precision below the configuration's) against
the reference.  For each ``--faults`` seed: the planted faults the cell can
have, against the reference (a training step over half of its gen views; a
view answered with the next azimuth's images).  One JSON line a reading.
Not part of a benchmark run.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    wl, cfg, mix, _ = harness.cell_spec(bench, args.workload)
    run_mod = harness.runner(mix)
    dev = torch.device("cuda")

    def emit(kind, seed, values, t0):
        print(json.dumps({"kind": kind, "seed": seed, "s": round(time.perf_counter() - t0, 2),
                          **values}), flush=True)

    def build(seed):
        cell = run_mod.Cell(cfg, mix, seed, dev)
        if run_mod.UNIT == "step":
            cell.warmup()
        else:
            for _ in range(mix["views"]):
                cell.unit_call()
        torch.cuda.synchronize()
        cell.free()
        return cell

    for kind, arg in (("program", args.seeds), ("control", args.control),
                      ("fault", args.faults)):
        for seed in seeds(arg):
            t0 = time.perf_counter()
            cell = build(seed)
            detail = {"detail": True} if hasattr(cell, "leaf_table") else {}
            if kind == "program":
                emit(kind, seed, cell.check(**detail), t0)
                if hasattr(cell, "leaf_table"):
                    emit("leaves", seed, cell.leaf_table(cell.readings, cell.want), t0)
            elif kind == "control":
                emit(kind, seed, cell.control(**detail), t0)
                if hasattr(cell, "leaf_table"):
                    emit("control_leaves", seed, cell.leaf_table(cell.ctl, cell.want), t0)
            else:
                for name, values in cell.faults().items():
                    emit(f"fault:{name}", seed, values, t0)
            del cell
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
