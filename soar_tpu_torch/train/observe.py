"""Observability: traces, metric logging, image dumps (port of
``soar_tpu.train.observe``).

- :func:`profile_trace`: a ``torch.profiler`` context that writes a Chrome
  trace (``chrome://tracing``, Perfetto) of what runs inside it, with the
  program's spans (:mod:`soar_tpu_torch.core.spans`);
- :class:`MetricLogger`: one JSON line per logged step in
  ``<out>/metrics.jsonl``, and wandb when asked for and installed;
- :func:`dump_debug_images`: the render / mask / normal / pred_normal /
  occ / depth / curv pngs of one step.
"""

from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import time
from typing import Dict, Optional

import numpy as np


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the host and, where CUDA is available, the device while the
    context is open, with the program's spans on (each span a range, its
    unit id among the range's inputs, recorded with the ops' shapes); on
    exit write the Chrome trace to ``<log_dir>/trace_<pid>_<time>.json``
    and the spans' counters, by name and span, to
    ``<log_dir>/counters_<pid>_<time>.json``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core.spans import counters, tracing

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, record_shapes=True) as prof:
        with tracing():
            yield prof
        counts = counters()
    tag = f"{os.getpid()}_{int(time.time())}"
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{tag}.json"))
    with open(os.path.join(log_dir, f"counters_{tag}.json"), "w") as f:
        json.dump(counts, f, indent=1)


class MetricLogger:
    """Appends ``{"step": ..., <metric>: float, ...}`` rows to
    ``<out_dir>/metrics.jsonl``; with ``use_wandb`` also logs them to wandb
    when the package is installed (the port does not depend on it, so it is
    loaded here by name), else says so and keeps to the JSONL."""

    def __init__(self, out_dir: str, use_wandb: bool = False, project: str = "soar_tpu"):
        os.makedirs(out_dir, exist_ok=True)
        self.f = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self.wandb = None
        if use_wandb:
            if importlib.util.find_spec("wandb") is None:
                print("[observe] wandb requested but not installed; JSONL only")
            else:
                self.wandb = importlib.import_module("wandb")
                self.wandb.init(project=project, dir=out_dir)

    def log(self, step: int, metrics: Dict):
        row = {"step": int(step)}
        row.update({k: float(v) for k, v in metrics.items()})
        self.f.write(json.dumps(row) + "\n")
        self.f.flush()
        if self.wandb is not None:
            self.wandb.log(row, step=int(step))

    def close(self):
        self.f.close()
        if self.wandb is not None:
            self.wandb.finish()


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    a = np.asarray(x)
    return a[0] if a.ndim == 4 else a


def dump_debug_images(out_dir: str, step: int, render_out: Dict, gt: Optional[Dict] = None):
    """Per-channel debug pngs under ``<out_dir>/test_<step>/``."""
    from .evaluate import save_png

    d = os.path.join(out_dir, f"test_{step}")
    os.makedirs(d, exist_ok=True)
    for key in ("render", "normal", "pred_normal", "occ"):
        if key in render_out:
            save_png(os.path.join(d, f"test_{step}_{key}.png"), _np(render_out[key]))
    for key in ("mask", "curv"):
        if key in render_out:
            img = _np(render_out[key])
            if img.ndim == 2:
                img = img[..., None].repeat(3, -1)
            save_png(os.path.join(d, f"test_{step}_{key}.png"), img)
    if "depth" in render_out:
        dep = _np(render_out["depth"])
        lo, hi = np.percentile(dep[dep > 0], [5, 95]) if (dep > 0).any() else (0, 1)
        dn = np.clip((dep - lo) / max(hi - lo, 1e-6), 0, 1)
        save_png(os.path.join(d, f"test_{step}_depth.png"), dn[..., None].repeat(3, -1))
    for key, img in (gt or {}).items():
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        save_png(os.path.join(d, f"test_{step}_gt_{key}.png"), img)
