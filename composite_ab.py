"""Times the composite kernels of this checkout against those of another
checkout (the parent commit's, say) on the same inputs, in one process on
one NVIDIA GPU.

    python3 composite_ab.py --against DIR

``DIR`` is the root of the other checkout (it must hold
``soar_tpu_torch/csrc/composite_fwd.cu`` and ``composite_bwd.cu`` with
the same C entry points, and ``composite_tiles.cu`` with the entry point
of the one-block-a-tile kernel, :data:`OTHER_TILES_ARGTYPES`).  Both
checkouts' sources are built by nvcc with this checkout's
``soar_tpu_torch.kernels.NVCC_FLAGS`` into ``soar_tpu_torch/_build/ab/``
(all builds started together), so a difference in the flags between the
checkouts is not seen.  Each block-composite library is called through
this checkout's wrappers (``render/block_composite._launch_fwd`` /
``_launch_bwd``) with the library swapped in.

The tile composite (``composite_tiles``) is called through each library's
own C entry point: this checkout's with the inputs as
``render/tiles_composite.launch_args`` hands them over (strided lists,
int64 counts and origins where they come so), the other's with
contiguous inputs and int32 counts and origins made before the timing.
Beside them it builds this checkout's source with other pixels per block
and other slot groups (:data:`TILE_VARIANTS`, by rewriting its
``kBlockPixels`` or ``kGroup`` constant into a copy under
``_build/ab/``).  Its input sets: the synthetic lists
of ``chip_smoke.tiles_scene``, the real tile lists of the bench and the
framed views, and the synthetic lists with ``perpix_depth=False``.

Inputs:
- the synthetic shapes of ``chip_smoke.py``: the forward at NT=1024, K=96,
  C=7 and C=3; the backward at K=64, NT=1024 with C=7 and C=3, NT=256 with
  C=7;
- the launches of the main path, recorded as ``chip_smoke.py`` records
  them: one full-width training step (13 forward, 8 backward) and one
  bench-camera turntable view (2 forward).

Each input set is timed with each library in turns: the other checkout,
this one, this one, the other checkout (device ms,
``chip_smoke.kernel_ms``; for a recorded path, the sum over its launches;
the tile variants between this one's two turns).
Outputs are held against this checkout's build: the forward's
accum, corr and T to the bit, the backward's gfeat per column relative to
the column's largest magnitude, the tile composite's colour, normal, T and
depth to the bit, or the largest depth difference (printed).  One line
per input set and library, the card's name and power limit, and a JSON
report in ``chiprun_out/composite_ab.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs

HERE = Path(__file__).resolve().parent
SYNTH_ITERS, PATH_ITERS, TILES_ITERS = 100, 20, 100
# Variants of the tile composite built beside this checkout's kernel: a
# constant of composite_tiles.cu and its value.
TILE_VARIANTS = (("kBlockPixels", 256), ("kBlockPixels", 64), ("kGroup", 16), ("kGroup", 4))
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# The C entry point of the one-block-a-tile composite_tiles.cu that the
# split-pixel kernel replaced: 10 contiguous inputs (int32 counts and
# origins), 4 outputs, NT, K, tile, perpix_depth, clamp, a_min, t_min,
# stream.
OTHER_TILES_ARGTYPES = [_P] * 14 + [_I] * 4 + [_F] * 3 + [_P]
TILES_CONSTS = (0.99, 1.0 / 255.0, 1e-4)


def build_all(jobs):
    """jobs: tag -> (kernel name, source file, include directory).  One
    nvcc each, all started together; returns tag -> (library path, ptxas
    log)."""
    from soar_tpu_torch import kernels

    out_dir = kernels.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (name, src, include) in jobs.items():
        lib = out_dir / f"lib{tag.replace(' ', '-')}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", str(include), "-o", str(lib),
               str(src)]
        procs[tag] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    built = {}
    for tag, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        cs.check(proc.returncode == 0, f"build {tag}: nvcc exited {proc.returncode}\n{log}")
        built[tag] = (lib, log)
    return built


def load_lib(name, path, argtypes=None):
    from soar_tpu_torch import kernels

    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, name)
    fn.argtypes = kernels.SOURCES[name][1] if argtypes is None else argtypes
    fn.restype = ctypes.c_int
    return lib


def variant_source(src, name, value, out_dir):
    """A copy of composite_tiles.cu with the constant ``name`` set to
    ``value``, written to ``out_dir`` (None where the source already has
    that value); built with the original's directory on the include
    path."""
    pattern = rf"constexpr int {name} = (\d+);"
    found = re.findall(pattern, src.read_text())
    cs.check(len(found) == 1, f"{src}: no single {name} constant to rewrite")
    if int(found[0]) == value:
        return None
    out = out_dir / f"composite_tiles_{name}{value}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(re.sub(pattern, f"constexpr int {name} = {value};", src.read_text()))
    return out


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


def main_path_sets(ds, params, model, views, ov):
    """The recorded launches of one bench-camera view and one training
    step (after one warm-up step)."""
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


def tile_sets(params, model, views, ov):
    """(label, tile lists, perpix_depth) of the tile composite's inputs."""
    synthetic = cs.tiles_scene(seed=5)
    sets = [("synthetic NT=1024 K=96", synthetic, True)]
    for label in ("bench", "framed"):
        sets.append((f"{label} view lists", cs.view_tile_lists(params, model, views[label], ov)[0],
                     True))
    sets.append(("synthetic NT=1024 K=96 perpix_depth=False", synthetic, False))
    return sets


def tiles_call(lib, lists, perpix, this):
    """A no-argument call of one library's composite_tiles on ``lists``,
    its four outputs, and the inputs it reads (kept alive with the call);
    the inputs are prepared here, outside the timed call."""
    from soar_tpu_torch.render.tiles_composite import launch_args

    xy = lists[0]
    NT, K = xy.shape[:2]
    outs = (torch.empty((NT, 256, 3), device="cuda"), torch.empty((NT, 256, 3), device="cuda"),
            torch.empty((NT, 256), device="cuda"), torch.empty((NT, 256), device="cuda"))
    out_ptrs = [o.data_ptr() for o in outs]
    stream = torch.cuda.current_stream().cuda_stream
    if this:
        a = launch_args(*lists)
        strides = (ctypes.c_int64 * len(a.strides))(*a.strides)
        args = (*a.pointers, *out_ptrs, strides, NT, K, 16, int(perpix), int(a.counts_i64),
                int(a.origins_i64), *TILES_CONSTS, stream)
        inputs = (a, strides)
    else:
        ins = [x.contiguous() for x in lists[:7]]
        ins += [lists[7].contiguous().view(torch.uint8),
                lists[8].clamp(0, K).to(torch.int32).contiguous(),
                lists[9].to(torch.int32).contiguous()]
        args = (*(x.data_ptr() for x in ins), *out_ptrs, NT, K, 16, int(perpix), *TILES_CONSTS,
                stream)
        inputs = ins

    def call():
        return lib.composite_tiles(*args)

    cs.check(call() == 0, "composite_tiles launch failed")
    torch.cuda.synchronize()
    return call, outs, inputs


def tile_outputs_vs(got, want):
    """Colour, normal and T bit-equal, and the depth's largest difference
    (absolute, and relative to the largest |depth| of ``want``)."""
    d = float((got[2] - want[2]).abs().max())
    return {"color_normal_T_bit_equal": all(torch.equal(got[i], want[i]) for i in (0, 1, 3)),
            "depth_bit_equal": torch.equal(got[2], want[2]), "depth_max_abs_diff": d,
            "depth_max_rel_diff": d / max(float(want[2].abs().max()), 1e-30)}


def run_tiles(libs, sets):
    tags = ["composite_tiles against", "composite_tiles this",
            *sorted(t for t in libs if t.startswith("composite_tiles this "))]
    order = tags + tags[::-1]
    report = []
    for label, lists, perpix in sets:
        calls = {tag: tiles_call(libs[tag], lists, perpix, tag != tags[0]) for tag in tags}
        times = {tag: [] for tag in tags}
        for tag in order:
            times[tag].append(cs.kernel_ms(calls[tag][0], TILES_ITERS))
        bound = cs.tiles_bound_ms(lists)
        want = calls[tags[1]][1]
        for tag in tags:
            row = {"set": label, "kernel": "composite_tiles", "library": tag.split(" ", 1)[1],
                   "launches": 1, "ms": times[tag], "bound_ms": bound["bound_ms"],
                   "heaviest_tile_walked": bound["heaviest_tile_walked"],
                   **tile_outputs_vs(calls[tag][1], want)}
            report.append(row)
            print(f"[ab tiles {label}] {tag}: ms {', '.join(f'{x:.4f}' for x in times[tag])} "
                  f"(bound {bound['bound_ms']:.4f}; heaviest tile walks "
                  f"{bound['heaviest_tile_walked']} slots); vs this checkout: colour, normal, T "
                  f"bit-equal {row['color_normal_T_bit_equal']}, depth bit-equal "
                  f"{row['depth_bit_equal']} (largest difference {row['depth_max_abs_diff']:.3g}, "
                  f"{row['depth_max_rel_diff']:.3g} of the largest |depth|)")
    return report


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
    for name in ("composite_fwd", "composite_bwd", "composite_tiles"):
        jobs[f"{name} against"] = (name, other / f"{name}.cu", other)
        jobs[f"{name} this"] = (name, here / f"{name}.cu", here)
    from soar_tpu_torch import kernels

    for name, value in TILE_VARIANTS:
        src = variant_source(here / "composite_tiles.cu", name, value,
                             kernels.BUILD_DIR / "ab" / "src")
        if src is not None:
            jobs[f"composite_tiles this {name}={value}"] = ("composite_tiles", src, here)
    built = build_all(jobs)
    libs = {tag: load_lib(jobs[tag][0], path,
                          OTHER_TILES_ARGTYPES if tag == "composite_tiles against" else None)
            for tag, (path, _) in built.items()}
    ptxas = {tag: cs.ptxas_summary(log) for tag, (_, log) in built.items()}
    for tag, summary in ptxas.items():
        sel = {k: v for k, v in summary.items() if k in ("C=3", "C=7", "true", "false")}
        spills = [k for k, v in summary.items() if v["spill_stores"] or v["spill_loads"]]
        print(f"[ptxas] {tag}: {sel}; registers {min(v['registers'] for v in summary.values())}"
              f"..{max(v['registers'] for v in summary.values())} over {len(summary)} "
              f"instances; instances that spill: {spills}")

    ds, params, model = cs.slice_scene("cuda")
    views, ov = cs.slice_views(ds, params, model, "cuda")
    sets = [(label, name, launches, SYNTH_ITERS) for label, name, launches in synthetic_sets()]
    sets += [(label, name, launches, PATH_ITERS)
             for label, name, launches in main_path_sets(ds, params, model, views, ov)]
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
    report += run_tiles(libs, tile_sets(params, model, views, ov))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "composite_ab.json"), "w") as f:
        json.dump({"card": info, "ptxas": ptxas, "rows": report,
                   "wall_s": time.perf_counter() - t_start}, f, indent=1)
    print(f"[ab] {time.perf_counter() - t_start:.1f} s")
    print(info["nvidia_smi"])


if __name__ == "__main__":
    main()
