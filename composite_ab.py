"""Times the block composite kernels of this checkout against those of
another checkout (the parent commit's, say) on the same inputs, in one
process on one NVIDIA GPU.

    python3 composite_ab.py --against DIR

``DIR`` is the root of the other checkout (it must hold
``soar_tpu_torch/csrc/composite_fwd.cu`` and ``composite_bwd.cu`` with
the same C entry points).  Both checkouts' sources are built by nvcc with
this checkout's ``soar_tpu_torch.kernels.NVCC_FLAGS`` into
``soar_tpu_torch/_build/ab/`` (all builds started together), so a
difference in the flags between the checkouts is not seen.  Each library
is called through this checkout's wrappers
(``render/block_composite._launch_fwd`` / ``_launch_bwd``) with the
library swapped in.

Inputs:
- the synthetic shapes of ``chip_smoke.py``: the forward at NT=1024, K=96,
  C=7 and C=3; the backward at K=64, NT=1024 with C=7 and C=3, NT=256 with
  C=7;
- the launches of the main path, recorded as ``chip_smoke.py`` records
  them: one full-width training step (13 forward, 8 backward) and one
  bench-camera turntable view (2 forward).

Each input set is timed with each library in turns: the other checkout,
this one, this one, the other checkout (device ms,
``chip_smoke.kernel_ms``; for a recorded path, the sum over its launches).
Outputs are held against this checkout's build: the forward's
accum, corr and T to the bit, the backward's gfeat per column relative to
the column's largest magnitude (printed).  One line per input set and
library, the card's name and power limit, and a JSON report in
``chiprun_out/composite_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
SYNTH_ITERS, PATH_ITERS = 100, 20


def build_all(jobs):
    """jobs: tag -> (kernel name, source dir).  One nvcc each, all started
    together; returns tag -> (library path, ptxas log)."""
    from soar_tpu_torch import kernels

    out_dir = kernels.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (name, src_dir) in jobs.items():
        lib = out_dir / f"lib{tag.replace(' ', '-')}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(lib),
               str(src_dir / f"{name}.cu")]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"build {tag}: nvcc exited {proc.returncode}\n{log}")
        built[tag] = (lib, log)
    return built


def load_lib(name, path):
    import ctypes

    from soar_tpu_torch import kernels

    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes = kernels.SOURCES[name][1]
    fn.restype = ctypes.c_int
    return lib


class Swapped:
    """Routes the wrapper's kernel ``name`` to library ``lib`` inside a
    ``with`` block."""

    def __init__(self, name, lib):
        self.name, self.lib = name, lib

    def __enter__(self):
        from soar_tpu_torch import kernels

        self.saved = kernels._loaded.get(self.name)
        kernels._loaded[self.name] = self.lib

    def __exit__(self, *exc):
        from soar_tpu_torch import kernels

        kernels._loaded[self.name] = self.saved


def synthetic_sets():
    """(label, kernel, launch args) of chip_smoke.py's synthetic shapes, as
    packed wrapper arguments."""
    from soar_tpu_torch.render.block_composite import _pack

    sets = []
    for C, seed in ((7, 0), (3, 1)):
        a = cs.composite_scene(C, seed)
        sets.append((f"synthetic NT=1024 K=96 C={C}", "composite_fwd",
                     [(_pack(*a[:6]).contiguous(), a[6], 0.99, 1 / 255, 1e-4)]))
    for NT, C, seed in ((1024, 7, 2), (1024, 3, 3), (256, 7, 4)):
        a = cs.composite_scene(C, seed, NT=NT, K=cs.TRAIN_K)
        g = torch.Generator(device="cuda").manual_seed(seed)
        P = a[6].shape[1]
        cots = (torch.randn((NT, C, P), generator=g, device="cuda"),
                torch.randn((NT, P), generator=g, device="cuda"),
                torch.randn((NT, P), generator=g, device="cuda"))
        sets.append((f"synthetic NT={NT} K={cs.TRAIN_K} C={C}", "composite_bwd",
                     [(_pack(*a[:6]).contiguous(), a[6], *cots, 0.99, 1 / 255, 1e-4)]))
    return sets


def main_path_sets():
    """The recorded launches of one bench-camera view and one training
    step (after one warm-up step)."""
    ds, params, model = cs.slice_scene("cuda")
    views, ov = cs.slice_views(ds, params, model, "cuda")
    with torch.no_grad():
        view_fwd, _ = cs.record_launches(cs.view_fn(params, model, views["bench"], ov))
    ts = cs.train_setup(cs.train_dataset(ds), params, model, "cuda")
    ts.one_step()
    step_fwd, step_bwd = cs.record_launches(ts.one_step)
    cs.check((len(view_fwd), len(step_fwd), len(step_bwd)) == (2, cs.FWD_PER_STEP, cs.BWD_PER_STEP),
             "recorded launches per view and step")
    return [("bench view", "composite_fwd", view_fwd),
            ("train step", "composite_fwd", step_fwd),
            ("train step", "composite_bwd", step_bwd)]


def run_set(name, launches, lib, iters):
    """Device ms summed over the launches, and their outputs."""
    from soar_tpu_torch.render import block_composite as bc

    launch = bc._launch_fwd if name == "composite_fwd" else bc._launch_bwd
    with Swapped(name, lib):
        outs = [launch(*args) for args in launches]
        ms = sum(cs.kernel_ms(lambda: launch(*args), iters) for args in launches)
    return ms, outs


def compare(name, got, want):
    """Forward: whether every output is bit-equal.  Backward: the largest
    |got - want| over the launches, per gfeat column, relative to the
    column's largest magnitude in ``want``."""
    if name == "composite_fwd":
        return {"bit_equal": all(torch.equal(g, w) for go, wo in zip(got, want)
                                 for g, w in zip(go, wo))}
    rel = 0.0
    for g, w in zip(got, want):
        scale = w.abs().amax((0, 1)).clamp_min(1e-30)
        rel = max(rel, float(((g - w).abs().amax((0, 1)) / scale).max()))
    return {"bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
            "max_col_rel_diff": rel}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True, type=Path,
                    help="root of the checkout whose kernels are compared")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("composite_ab: no CUDA device", file=sys.stderr)
        sys.exit(2)
    t_start = time.perf_counter()
    info = cs.card_info()
    here = HERE / "soar_tpu_torch" / "csrc"
    other = args.against.resolve() / "soar_tpu_torch" / "csrc"
    jobs = {}
    for name in ("composite_fwd", "composite_bwd"):
        jobs[f"{name} against"] = (name, other)
        jobs[f"{name} this"] = (name, here)
    built = build_all(jobs)
    libs = {tag: load_lib(jobs[tag][0], path) for tag, (path, _) in built.items()}
    ptxas = {tag: cs.ptxas_summary(log) for tag, (_, log) in built.items()}
    for tag, summary in ptxas.items():
        sel = {k: v for k, v in summary.items() if k in ("C=3", "C=7")}
        spills = [k for k, v in summary.items() if v["spill_stores"] or v["spill_loads"]]
        print(f"[ptxas] {tag}: {sel}; registers {min(v['registers'] for v in summary.values())}"
              f"..{max(v['registers'] for v in summary.values())} over {len(summary)} "
              f"instances; instances that spill: {spills}")

    sets = [(label, name, launches, SYNTH_ITERS) for label, name, launches in synthetic_sets()]
    sets += [(label, name, launches, PATH_ITERS) for label, name, launches in main_path_sets()]
    report = []
    for label, name, launches, iters in sets:
        tags = [f"{name} against", f"{name} this"]
        order = tags + tags[::-1]
        times = {tag: [] for tag in tags}
        outs = {}
        for tag in order:
            ms, out = run_set(name, launches, libs[tag], iters)
            times[tag].append(ms)
            outs.setdefault(tag, out)
        want = outs[f"{name} this"]
        bound_fn = cs.composite_bound_ms if name == "composite_fwd" else cs.composite_bwd_bound_ms
        bound = sum(bound_fn(cs.unpack_feat(a[0], a[1]), a[0].shape[-1] - 9)["bound_ms"]
                    for a in launches)
        for tag in tags:
            row = {"set": label, "kernel": name, "library": tag.split(" ", 1)[1],
                   "launches": len(launches), "ms": times[tag], "bound_ms": bound,
                   **compare(name, outs[tag], want)}
            report.append(row)
            print(f"[ab {label}] {tag}: {len(launches)} launches, ms "
                  f"{', '.join(f'{x:.4f}' for x in times[tag])} (bound {bound:.4f}); vs this "
                  f"checkout: " + ", ".join(f"{k} {v}" for k, v in row.items()
                                             if k in ("bit_equal", "max_col_rel_diff")))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "composite_ab.json"), "w") as f:
        json.dump({"card": info, "ptxas": ptxas, "rows": report,
                   "wall_s": time.perf_counter() - t_start}, f, indent=1)
    print(f"[ab] {time.perf_counter() - t_start:.1f} s")
    print(info["nvidia_smi"])


if __name__ == "__main__":
    main()
