"""The benchmark of ``soar_tpu_torch`` on one NVIDIA H100 (see
``benchmark/README.md``)::

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Prints the numbers compared with the
reference, each beside its limit, as the last lines of standard error, and
one JSON result as the last line of standard output.  Exits with another
code than 0, and prints no result, when CUDA is absent or has fewer devices
than the cell asks for, when the program is missing, or when a module of
JAX or of the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Compile caches at fixed paths inside the checkout, set before torch
    # is imported; the program's nvcc libraries stay in soar_tpu_torch/_build.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, ROOT)

    import torch

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"the cell needs {wl['chips']} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    from benchmark import harness

    result = harness.run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                         T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"refused: modules loaded in the run: {bad}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    print(f"notes {json.dumps(result.pop('notes'))}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
