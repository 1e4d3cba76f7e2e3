"""Two-stage training CLI (port of ``soar_tpu.cli.train``).

    python -m soar_tpu_torch.cli.train --synthetic --steps 3 [--device cpu]
    python -m soar_tpu_torch.cli.train --synthetic --guidance mvdream --mock-guidance

Stage 0 supervises geometry (normals), stage 1 texture (RGB); stage 1
starts from the stage-0 parameters with a fresh optimizer, and each stage
ends with a checkpoint in ``<out>/stage<K>``.  ``--synthetic`` trains the
procedural fixture (no download).  ``--guidance mvdream --mock-guidance``
adds the SDS loss after each stage's ``sds_start``, with random full-shape
networks and text embeddings.  The flags and defaults are the JAX CLI's;
those of parts not ported yet (ImageDream's image prompt, prompt embeddings
and with them checkpoint guidance, split SDS, LPIPS, YAML configs,
reference checkpoints, real captures, multi-device, traces, wandb) stop
with an error instead of being ignored, and the flags that only shape a
real-capture run (``--smpl-model``, ``--num-subdiv``, ``--gen-res``) are not
defined yet.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# flag -> what it waits for; each is refused when given.
NOT_PORTED = {
    "config": "YAML configs",
    "dataroot": "real-capture loading",
    "import_ckpt": "reference .ckpt import",
    "prompt": "prompt processing",
    "prompt_embeddings": "prompt processing",
    "clip_model_dir": "prompt processing",
    "guidance_ckpt": "checkpoint guidance, with the prompt embeddings it needs,",
    "lpips_weights": "LPIPS",
    "multichip": "multi-device training",
    "trace_steps": "profiler traces",
    "wandb": "wandb logging",
}


def resolve_stage_cfg(st: int, steps_arg):
    """``--steps`` if given, else the 1000-step default."""
    from ..train.config import StageConfig, stage1_config

    n = 1000 if steps_arg is None else steps_arg
    return StageConfig(max_steps=n) if st == 0 else stage1_config(n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--dataroot", type=str, default=None)
    ap.add_argument("--out", type=str, default="outputs/run")
    ap.add_argument("--stage", type=str, default="both", choices=["0", "1", "both"])
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per stage (default 1000)")
    ap.add_argument("--n-views", type=int, default=None,
                    help="gen views per step (default 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--use-explicit", action="store_true")
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--import-ckpt", type=str, default=None)
    ap.add_argument("--eval", action="store_true", help="run the test split at the end")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--dump-every", type=int, default=250)
    ap.add_argument("--save-every", type=int, default=0,
                    help="mid-stage checkpoint every N steps to <out>/stage<K> "
                         "(0 = stage end only); restart with --resume <out>/stage<K>")
    ap.add_argument("--val-every", type=int, default=250)
    ap.add_argument("--wandb", action="store_true")
    ap.add_argument("--lpips-weights", type=str, default=None)
    ap.add_argument("--trace-steps", type=int, default=0)
    ap.add_argument("--guidance", type=str, default=None,
                    choices=["none", "imagedream", "mvdream"],
                    help="multi-view SDS guidance (mvdream: text-conditioned; imagedream "
                    "arrives with the next slice)")
    ap.add_argument("--prompt", type=str, default=None)
    ap.add_argument("--prompt-embeddings", type=str, default=None)
    ap.add_argument("--clip-model-dir", type=str, default=None)
    ap.add_argument("--guidance-ckpt", type=str, default=None)
    ap.add_argument("--mock-guidance", action="store_true",
                    help="random full-shape guidance networks and text embeddings")
    ap.add_argument("--guidance-image-size", type=int, default=256)
    ap.add_argument("--guidance-dtype", type=str, default="bf16", choices=["bf16", "f32"],
                    help="guidance networks' compute dtype (the reference runs "
                    "half_precision_weights=true)")
    ap.add_argument("--sds-mode", type=str, default="fused", choices=["split", "fused"],
                    help="fused: the whole SDS inside the step (split arrives with the "
                    "next guidance slice)")
    ap.add_argument("--multichip", action="store_true")
    ap.add_argument("--sds-start", type=int, default=None,
                    help="override the stage's sds_start: steps <= sds_start run "
                         "without SDS (and without the gen views' normal-consistency term)")
    ap.add_argument("--max-per-tile", type=int, default=64)
    ap.add_argument("--composite-dtype", type=str, default="bf16", choices=["f32", "bf16"],
                    help="dtype of the plain composite's [tiles, pixels, K] chain; the "
                         "CUDA kernels composite in f32")
    ap.add_argument("--gt-cache", type=str, default="auto",
                    choices=["auto", "pin", "pin-u8", "lru"])
    ap.add_argument("--gt-cache-mb", type=int, default=4096)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    for flag, what in NOT_PORTED.items():
        if getattr(args, flag):
            ap.error(f"--{flag.replace('_', '-')} is not ported yet ({what} arrives "
                     "with a later slice of the port)")
    if args.guidance == "imagedream":
        ap.error("--guidance imagedream is not ported yet (its image prompt, the CLIP "
                 "tower and Resampler, arrives with the next slice of the port)")
    if args.guidance == "mvdream" and not args.mock_guidance:
        ap.error("--guidance mvdream needs --mock-guidance (real weights need prompt "
                 "embeddings, which arrive with the next slice of the port)")
    if args.sds_mode == "split":
        ap.error("--sds-mode split is not ported yet (it arrives with the next guidance "
                 "slice of the port)")
    if not args.synthetic:
        ap.error("only --synthetic is ported so far (real captures arrive with a "
                 "later slice)")

    import dataclasses as dc
    from collections import OrderedDict

    import numpy as np
    import torch

    from .. import resolve_device
    from ..avatar.renderer import RenderSettings, render_view
    from ..io.checkpoint import load_avatar, save_avatar
    from ..render.types import RasterConfig
    from ..train.config import TrainConfig
    from ..train.evaluate import evaluate
    from ..train.observe import MetricLogger, StepTimer, dump_debug_images
    from ..train.trainer import (
        gt_stack_nbytes,
        init_train_state,
        make_gt_batch,
        make_gt_batch_stack,
        make_train_step,
        sample_step_draws,
    )
    from .common import synthetic_setup

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg = TrainConfig(n_views=args.n_views if args.n_views else 4)
    ds, params, model = synthetic_setup(distill_steps=100, seed=args.seed, device=dev)
    gen_size = normal_size = (128, 128)

    resume_step = 0
    if args.resume:
        params, resume_step = load_avatar(args.resume, params)
        print(f"resumed from {args.resume} @ step {resume_step}")

    has_normals = bool(ds.normal_F.size)
    has_normal_B = bool(ds.normal_B.size)
    raster = RasterConfig(max_per_tile=args.max_per_tile, composite_dtype=args.composite_dtype)
    stages = {"0": [0], "1": [1], "both": [0, 1]}[args.stage]

    def _resolve_stage(st):
        stage_cfg = resolve_stage_cfg(st, args.steps)
        if not has_normals:
            stage_cfg = dc.replace(stage_cfg, loss=dc.replace(
                stage_cfg.loss, normal_F=0.0, normal_B=0.0, normal_mask=0.0))
        if args.sds_start is not None:
            stage_cfg = dc.replace(stage_cfg, sds_start=args.sds_start)
        return stage_cfg

    # The guidance networks are built once; each stage rebinds its scalars
    # (guidance scale, timestep window) with for_stage.
    base_guidance = None
    if args.guidance == "mvdream":
        from ..guidance.build import build_guidance

        base_guidance = build_guidance(
            args.guidance, _resolve_stage(stages[0]),
            generator=torch.Generator(device=dev).manual_seed(args.seed + 100),
            mock=True,
            image_size=args.guidance_image_size, n_view=cfg.n_views,
            dtype=torch.bfloat16 if args.guidance_dtype == "bf16" else torch.float32,
            device=dev,
        )
        print(f"guidance: {args.guidance} (mock, {args.guidance_dtype})")

    dump_settings = RenderSettings(use_explicit=args.use_explicit, raster=raster)
    global_step_base = 0
    for st in stages:
        stage_cfg = _resolve_stage(st)
        guidance_fn = base_guidance.for_stage(stage_cfg) if base_guidance is not None else None
        latent_size = guidance_fn.latent_size if guidance_fn is not None else None
        state, opt = init_train_state(params, cfg, seed=args.seed, stage=stage_cfg)
        step_fn = make_train_step(
            model, cfg, stage_cfg, opt,
            gen_size=gen_size, gt_size=ds.image_size, normal_size=normal_size,
            raster=raster, use_explicit=args.use_explicit,
            has_normals=has_normals, has_normal_B=has_normal_B, guidance_fn=guidance_fn,
        )
        logger = MetricLogger(args.out)
        timer = StepTimer()
        generator = torch.Generator(device=dev).manual_seed(args.seed + st)
        rng = np.random.RandomState(args.seed + st)

        # Per-frame GT batches: pinned on the device as one stack when it
        # fits --gt-cache-mb (uint8 image storage next), else an LRU.
        budget = args.gt_cache_mb * (1 << 20)
        nf = len(ds.train_idx)
        mode = args.gt_cache
        if mode == "auto":
            if gt_stack_nbytes(ds, model, nf) <= budget:
                mode = "pin"
            elif gt_stack_nbytes(ds, model, nf, store_u8=True) <= budget:
                mode = "pin-u8"
            else:
                mode = "lru"
        gt_stack = gt_select = gt_pos = None
        if mode in ("pin", "pin-u8"):
            gt_stack, gt_select, gt_pos = make_gt_batch_stack(
                ds, model, ds.train_idx, store_u8=(mode == "pin-u8"), device=dev)
            print(f"gt-cache: pinned {nf} frames on {dev} ({mode})")
        batch_cache = OrderedDict()

        n_steps = stage_cfg.max_steps
        # --resume carries the step counter only into the stage the
        # checkpoint came from (path basename "stage<K>"); a checkpoint of
        # another stage is a hand-off: params only, step 0.
        same_stage = args.resume is not None and os.path.basename(
            os.path.normpath(args.resume)) == f"stage{st}"
        start_it = min(resume_step, n_steps) if same_stage else 0
        resume_step = 0
        if start_it > 0:
            state.step = start_it
            print(f"stage {st}: continuing from step {start_it}/{n_steps}")
        t0 = time.time()
        for it in range(start_it, n_steps):
            frame = ds.train_idx[rng.randint(len(ds.train_idx))]
            with timer.phase("batch"):
                if gt_select is not None:
                    batch = gt_select(gt_stack, gt_pos[frame])
                else:
                    batch = batch_cache.get(frame)
                    if batch is None:
                        batch = batch_cache[frame] = make_gt_batch(ds, model, frame, dev)
                        if len(batch_cache) > 32:
                            batch_cache.popitem(last=False)
                    else:
                        batch_cache.move_to_end(frame)
            with timer.phase("step"):
                draws = sample_step_draws(generator, cfg, latent_size=latent_size)
                state, metrics = step_fn(state, batch, draws)
            if it % args.log_every == 0 or it == n_steps - 1:
                m = {k: round(float(v), 5) for k, v in metrics.items()}
                m["stage"] = st
                logger.log(global_step_base + it, m)
                m["sec_per_step"] = round(timer.summary().get("step", 0.0), 3)
                print(f"stage {st} it {it} ({time.time() - t0:.1f}s):", json.dumps(m))
            if args.save_every > 0 and it > 0 and it % args.save_every == 0:
                save_avatar(os.path.join(args.out, f"stage{st}"), state.params, step=it)
                print(f"checkpointed stage {st} @ it {it}", flush=True)
            if args.dump_every > 0 and it > 0 and it % args.dump_every == 0:
                with torch.no_grad():
                    out_dbg = render_view(state.params, model, batch["gt_cam"], ds.image_size,
                                          torch.ones(3, device=dev), batch["frame_idx"],
                                          dump_settings)
                dump_debug_images(args.out, it, out_dbg,
                                  gt={"rgb": ds.images[frame], "mask": ds.masks[frame]})
            if args.val_every > 0 and it > 0 and it % args.val_every == 0 and (
                    ds.val_idx or ds.test_idx):
                vidx = (ds.val_idx or ds.test_idx)[0]
                vb = make_gt_batch(ds, model, vidx, dev)
                with torch.no_grad():
                    vout = render_view(state.params, model, vb["gt_cam"], ds.image_size,
                                       torch.ones(3, device=dev), vidx, dump_settings)
                dump_debug_images(os.path.join(args.out, "val"), it, vout,
                                  gt={"rgb": ds.images[vidx]})
        logger.close()
        params = state.params
        ckpt = os.path.join(args.out, f"stage{st}")
        save_avatar(ckpt, params, step=n_steps)
        print(f"saved {ckpt}")
        global_step_base += n_steps

    if args.eval:
        res = evaluate(params, model, ds, save_dir=os.path.join(args.out, "test"),
                       settings=RenderSettings(use_explicit=args.use_explicit,
                                               raster=raster),
                       device=dev)
        print("eval:", json.dumps(res))


if __name__ == "__main__":
    main()
