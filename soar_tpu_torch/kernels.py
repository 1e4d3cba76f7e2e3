"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  Libraries go to
``soar_tpu_torch/_build/`` (git-ignored), named by a hash of their source,
the shared headers (``csrc/*.cuh``), the nvcc flags and ``nvcc --version``,
so a kernel edited, or built with other flags or another nvcc, is rebuilt
and a stale one is never loaded.  Nothing is built at import: :func:`load`
builds on first use, :func:`build` builds several sources at once (one
``nvcc`` process each, started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG / "_build"

# kernel library name -> (source under the package, C signature)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SOURCES = {
    "composite_fwd": (
        "csrc/composite_fwd.cu",
        # feat, pixf, accum, corr, t_out, NT, K, P, C, clamp, a_min, t_min, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    ),
    "composite_bwd": (
        "csrc/composite_bwd.cu",
        # feat, pixf, gacc, gcorr, gT, gfeat, NT, K, P, C, clamp, a_min, t_min, stream
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _P],
    ),
    "composite_tiles": (
        "csrc/composite_tiles.cu",
        # xy, conic, opac, colors, normals, depths, jinv, slot_valid, counts,
        # origins, color, normal, depth, t_out, strides (int64 [14], host),
        # NT, K, tile, perpix_depth, counts_i64, origins_i64, clamp, a_min,
        # t_min, stream
        [_P] * 14 + [ctypes.POINTER(ctypes.c_int64)] + [_I] * 6 + [_F, _F, _F, _P],
    ),
    "hash_encode": (
        "csrc/hash_encode.cu",
        # table, pos, res, out, grad_out, grad_table, N, L, log2T, corner,
        # dtype, stream
        [_P] * 6 + [_I] * 5 + [_P],
    ),
    "preprocess": (
        "csrc/preprocess.cu",
        # args (struct Args *), flags, backward, stream
        [_P, _I, _I, _P],
    ),
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[str, ctypes.CDLL] = {}
_nvcc_version: Optional[str] = None


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def nvcc_version() -> str:
    """``nvcc --version``, or "" where there is no nvcc (nothing can be
    built there, so no library is found under that name either)."""
    global _nvcc_version
    if _nvcc_version is None:
        try:
            nvcc = nvcc_path()
        except RuntimeError:
            return ""
        _nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                       text=True, timeout=60, check=True).stdout
    return _nvcc_version


def library_path(name: str) -> Path:
    h = hashlib.sha256((_PKG / SOURCES[name][0]).read_bytes())
    for header in sorted((_PKG / "csrc").glob("*.cuh")):
        h.update(header.read_bytes())
    h.update("\0".join([*NVCC_FLAGS, nvcc_version()]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    each, all started together.  Returns seconds per kernel compiled; the
    ``-Xptxas -v`` report is kept beside each library as ``.log``."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_PKG / SOURCES[n][0])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    seconds, failed = {}, []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        library_path(n).with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        fn = getattr(lib, name)
        fn.argtypes = SOURCES[name][1]
        fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` lines (registers, shared memory, spills) of the
    last build of ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
