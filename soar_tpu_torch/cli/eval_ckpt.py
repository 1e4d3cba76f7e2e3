"""The reference eval protocol on a saved avatar checkpoint (port of
``scripts/eval_ckpt.py``): test-split PSNR / SSIM, ``psnrs.txt``,
``ssims.txt`` and ``average.txt`` under ``--out``, the result printed as
JSON.

``cli.train --eval`` evaluates only at the end of its last stage; this
tool scores any checkpoint, e.g. a run's stage-0 checkpoint against a
stage-0-only baseline (what ``scripts/compare_runs.py`` compares).

    python -m soar_tpu_torch.cli.eval_ckpt --dataroot /tmp/mockcap20 \\
        --smpl-model test:10,7,28 --num-subdiv 2 \\
        --ckpt outputs/run/stage0 --out outputs/run/test_stage0 [--device cpu]

``--ckpt`` is a directory or ``avatar.pt`` that ``cli.train`` wrote; a
reference Lightning ``.ckpt`` is refused with the name of its importer
(``cli.train --import-ckpt``).  Pass ``cli.train``'s ``--max-per-tile`` /
``--composite-dtype`` to render as its ``--eval`` does: without them the
raster is ``RasterConfig()``'s (K = 96), as in the JAX script.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--smpl-model", required=True)
    ap.add_argument("--num-subdiv", type=int, default=2)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--use-explicit", action="store_true")
    ap.add_argument("--max-per-tile", type=int, default=None)
    ap.add_argument("--composite-dtype", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import dataclasses as dc

    from ..avatar.renderer import RenderSettings
    from ..io.checkpoint import load_avatar
    from ..render.types import RasterConfig
    from ..train.evaluate import evaluate
    from .common import real_setup

    # distill_steps=0: the field comes from the checkpoint.
    ds, params, model = real_setup(args.dataroot, args.smpl_model, num_subdiv=args.num_subdiv,
                                   distill_steps=0, device=args.device)
    params, step = load_avatar(args.ckpt, params)
    print(f"loaded {args.ckpt} @ step {step}", file=sys.stderr)
    raster = RasterConfig()
    if args.max_per_tile is not None:
        raster = dc.replace(raster, max_per_tile=args.max_per_tile)
    if args.composite_dtype is not None:
        raster = dc.replace(raster, composite_dtype=args.composite_dtype)
    res = evaluate(params, model, ds, save_dir=args.out,
                   settings=RenderSettings(use_explicit=args.use_explicit, raster=raster),
                   device=args.device)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
