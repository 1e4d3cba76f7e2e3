"""Two-stage training CLI (port of ``soar_tpu.cli.train``).

    python -m soar_tpu_torch.cli.train --dataroot data/custom/<seq> \
        --smpl-model SMPLX_NEUTRAL.npz --out outputs/<seq> [--stage both] [--steps 1000]
    python -m soar_tpu_torch.cli.train --synthetic --steps 3 [--device cpu]
    python -m soar_tpu_torch.cli.train --dataroot D --smpl-model test:10,7,28 --num-subdiv 3 \
        --guidance imagedream --mock-guidance [--lpips-weights lpips_vgg16.pkl] [--eval]

Stage 0 supervises geometry (normals), stage 1 texture (RGB); stage 1
starts from the stage-0 parameters with a fresh optimizer, and each stage
ends with a checkpoint in ``<out>/stage<K>``.  ``--dataroot`` trains on a
capture on disk (``data.dataset.load_sequence``'s layout, or insav_wild's)
with the body from ``--smpl-model`` (an SMPL-X ``.npz``, an SMPL ``.pkl``,
or ``test:J,S,R`` for the procedural body), the avatar subdivided
``--num-subdiv`` times and its field distilled 1000 steps; gen views render
at ``--gen-res`` and the normal passes at the stored normal maps' size.
``--synthetic`` trains the procedural fixture at 128² (no download;
``--smpl-model``, ``--num-subdiv`` and ``--gen-res`` are ignored there).
``--guidance imagedream|mvdream`` adds the SDS loss after each stage's
``sds_start``: the networks from ``--guidance-ckpt`` (a torch
``sd-v2.1-base-4view[-ipmv]`` checkpoint) with text embeddings from
``--prompt-embeddings`` (a ``.npz`` of ``cond`` / ``uncond`` [77, D]) or
``--clip-model-dir``, or random at full shape (``--mock-guidance``).
ImageDream's ip tokens are computed once per frame before training (stage 1
from ``images_crop``, stage 0 from ``normal_F``) and the CLIP tower is then
freed.  ``--lpips-weights`` (the JAX CLI's LPIPS-VGG16 pickle) adds the
normal-LPIPS terms, the VGG RGB term with ``--lambda-vgg``, and LPIPS to
``--eval``.  The flags and defaults are the JAX CLI's; those of parts not
ported yet (YAML configs, reference checkpoints, multi-device, traces,
wandb) stop with an error instead of being ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import time

# flag -> what it waits for; each is refused when given.
NOT_PORTED = {
    "config": "YAML configs",
    "import_ckpt": "reference .ckpt import",
    "multichip": "multi-device training",
    "trace_steps": "profiler traces",
    "wandb": "wandb logging",
}


def resolve_stage_cfg(st: int, steps_arg):
    """``--steps`` if given, else the 1000-step default."""
    from ..train.config import StageConfig, stage1_config

    n = 1000 if steps_arg is None else steps_arg
    return StageConfig(max_steps=n) if st == 0 else stage1_config(n)


def resolve_guidance_kind(kind, *, ckpt, embeddings, clip_dir, mock: bool) -> str:
    """Gate guidance on its user-supplied weights: an explicit
    ``--guidance`` without them is an error.  (The JAX CLI's YAML-requested
    guidance, which degrades to none instead, waits for ``--config``.)"""
    if kind in (None, "none"):
        return "none"
    missing = []
    if not (ckpt or mock):
        missing.append("--guidance-ckpt (or --mock-guidance)")
    if not (embeddings or clip_dir or mock):
        missing.append("--prompt-embeddings / --clip-model-dir (or --mock-guidance)")
    if missing:
        raise SystemExit(f"guidance '{kind}' needs user-supplied weights: "
                         f"missing {'; '.join(missing)}")
    return kind


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--dataroot", type=str, default=None)
    ap.add_argument("--smpl-model", type=str, default=None,
                    help="SMPL-X .npz, SMPL .pkl, or test:J,S,R (the procedural body)")
    ap.add_argument("--out", type=str, default="outputs/run")
    ap.add_argument("--stage", type=str, default="both", choices=["0", "1", "both"])
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per stage (default 1000)")
    ap.add_argument("--num-subdiv", type=int, default=2)
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
    ap.add_argument("--lpips-weights", type=str, default=None,
                    help="LPIPS-VGG16 pickle (flax variables with numpy leaves, "
                    "docs/REAL_WEIGHTS.md section 1): the normal-LPIPS terms and the "
                    "LPIPS eval metric (the VGG RGB term also needs --lambda-vgg > 0)")
    ap.add_argument("--lambda-vgg", type=float, default=0.0,
                    help="weight of the VGG/LPIPS RGB loss (the reference's _fs "
                    "configs use 0.1); needs --lpips-weights")
    ap.add_argument("--trace-steps", type=int, default=0)
    ap.add_argument("--guidance", type=str, default=None,
                    choices=["none", "imagedream", "mvdream"],
                    help="multi-view SDS guidance; imagedream also conditions on the "
                    "per-frame GT crop (stage 1) / normal_F (stage 0)")
    ap.add_argument("--prompt", type=str, default=None,
                    help="text prompt (encoded with --clip-model-dir)")
    ap.add_argument("--prompt-embeddings", type=str, default=None,
                    help=".npz with cond/uncond [77, D] text embeddings")
    ap.add_argument("--clip-model-dir", type=str, default=None,
                    help="local SD2.1 text_encoder+tokenizer directory (needs transformers)")
    ap.add_argument("--guidance-ckpt", type=str, default=None,
                    help="torch sd-v2.1-base-4view[-ipmv] checkpoint")
    ap.add_argument("--mock-guidance", action="store_true",
                    help="random full-shape guidance networks and text embeddings")
    ap.add_argument("--guidance-image-size", type=int, default=256)
    ap.add_argument("--gen-res", type=int, default=256,
                    help="resolution of the gen-view renders of a capture (default 256, "
                    "the guidance's resolution; the reference renders 512 and "
                    "downsamples); --synthetic renders 128")
    ap.add_argument("--guidance-dtype", type=str, default="bf16", choices=["bf16", "f32"],
                    help="guidance networks' compute dtype (the reference runs "
                    "half_precision_weights=true)")
    ap.add_argument("--sds-mode", type=str, default="fused", choices=["split", "fused"],
                    help="fused: the whole SDS inside the step; split: the no-grad half "
                    "(lite gen renders, VAE, UNet target) before the step, which keeps "
                    "the VAE encode and the distance to the target")
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
    args.guidance = resolve_guidance_kind(
        args.guidance, ckpt=args.guidance_ckpt, embeddings=args.prompt_embeddings,
        clip_dir=args.clip_model_dir, mock=args.mock_guidance)
    if not args.synthetic and not (args.dataroot and args.smpl_model):
        raise SystemExit("--dataroot and --smpl-model required (or --synthetic)")

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
    from ..train.lpips import load_lpips, make_lpips_fn
    from ..train.observe import MetricLogger, StepTimer, dump_debug_images
    from ..train.trainer import (
        gt_stack_nbytes,
        init_train_state,
        make_gt_batch,
        make_gt_batch_stack,
        make_train_step,
        sample_step_draws,
    )
    from .common import real_setup, synthetic_setup

    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    cfg = TrainConfig(n_views=args.n_views if args.n_views else 4)
    if args.synthetic:
        ds, params, model = synthetic_setup(distill_steps=100, seed=args.seed, device=dev)
        gen_size = normal_size = (128, 128)
    else:
        t_setup = time.time()
        ds, params, model = real_setup(args.dataroot, args.smpl_model,
                                       num_subdiv=args.num_subdiv, seed=args.seed,
                                       distill_steps=1000, device=dev)
        gen_size = (args.gen_res, args.gen_res)
        # The normal passes render at the stored normal maps' resolution.
        nres = ds.normal_F.shape[1] if ds.normal_F.size else cfg.height
        normal_size = (nres, nres)
        print(f"capture {args.dataroot}: {ds.num_frames} frames at {ds.image_size}, "
              f"{params.xyz.shape[0]} surfels, set up in {time.time() - t_setup:.1f}s")

    resume_step = 0
    if args.resume:
        params, resume_step = load_avatar(args.resume, params)
        print(f"resumed from {args.resume} @ step {resume_step}")

    has_normals = bool(ds.normal_F.size)
    has_normal_B = bool(ds.normal_B.size)
    raster = RasterConfig(max_per_tile=args.max_per_tile, composite_dtype=args.composite_dtype)
    stages = {"0": [0], "1": [1], "both": [0, 1]}[args.stage]

    # LPIPS: bf16 convolutions on the loss path; the eval metric is always
    # float32, comparable to the reference's numbers.
    lpips_fn = make_lpips_fn(args.lpips_weights, dtype=torch.bfloat16, device=dev)
    eval_lpips = load_lpips(args.lpips_weights, device=dev) if lpips_fn is not None else None
    if args.lpips_weights and lpips_fn is None:
        print(f"warning: LPIPS weights not found at {args.lpips_weights}; "
              "LPIPS terms disabled")

    def _resolve_stage(st):
        stage_cfg = resolve_stage_cfg(st, args.steps)
        if not has_normals:
            stage_cfg = dc.replace(stage_cfg, loss=dc.replace(
                stage_cfg.loss, normal_F=0.0, normal_B=0.0, normal_mask=0.0))
        if args.lambda_vgg > 0.0:
            stage_cfg = dc.replace(stage_cfg, loss=dc.replace(stage_cfg.loss,
                                                              vgg=args.lambda_vgg))
        if args.sds_start is not None:
            stage_cfg = dc.replace(stage_cfg, sds_start=args.sds_start)
        return stage_cfg

    # The guidance networks are built once; each stage rebinds its scalars
    # (guidance scale, timestep window) with for_stage.
    base_guidance = None
    if args.guidance != "none":
        from ..guidance.build import build_guidance

        text_emb = None
        if args.prompt_embeddings or args.clip_model_dir:
            from ..guidance.prompt import PromptProcessor

            text_emb = PromptProcessor(args.prompt or "", embeddings_path=args.prompt_embeddings,
                                       clip_model_dir=args.clip_model_dir)()
        base_guidance = build_guidance(
            args.guidance, _resolve_stage(stages[0]),
            generator=torch.Generator(device=dev).manual_seed(args.seed + 100),
            ckpt_path=args.guidance_ckpt, text_embeddings=text_emb, mock=args.mock_guidance,
            image_size=args.guidance_image_size, n_view=cfg.n_views,
            dtype=torch.bfloat16 if args.guidance_dtype == "bf16" else torch.float32,
            device=dev,
        )
        weights = args.guidance_ckpt or "mock"
        print(f"guidance: {args.guidance} ({weights}, {args.guidance_dtype})")

    # ImageDream's ip tokens, once per frame for every stage about to run
    # (stage 1 embeds the GT crops, stage 0 the front normals), then the
    # CLIP tower and the Resampler are freed before training.  The reference
    # re-encodes the reference image every step (``imagedream_guidance.py:
    # 195``).
    ip_tables = {}
    if base_guidance is not None and base_guidance.embed_ref is not None:
        for st in stages:
            refs = ds.images_crop if st == 1 else (ds.normal_F if has_normals else None)
            if refs is not None and len(refs):
                t_ip = time.time()
                with torch.no_grad():
                    ip_tables[st] = torch.stack([base_guidance.embed_ref(np.asarray(r, np.float32))
                                                 for r in refs])
                print(f"precomputed ip tokens for {len(refs)} frames "
                      f"(stage {st}, {time.time() - t_ip:.1f}s)")
        base_guidance.release_image_encoder()

    dump_settings = RenderSettings(use_explicit=args.use_explicit, raster=raster)
    global_step_base = 0
    for st in stages:
        stage_cfg = _resolve_stage(st)
        guidance_fn = base_guidance.for_stage(stage_cfg) if base_guidance is not None else None
        latent_size = guidance_fn.latent_size if guidance_fn is not None else None
        ip_table = ip_tables.get(st)
        split_sds = guidance_fn is not None and args.sds_mode == "split"
        state, opt = init_train_state(params, cfg, seed=args.seed, stage=stage_cfg)
        step_fn = make_train_step(
            model, cfg, stage_cfg, opt,
            gen_size=gen_size, gt_size=ds.image_size, normal_size=normal_size,
            raster=raster, use_explicit=args.use_explicit,
            has_normals=has_normals, has_normal_B=has_normal_B, guidance_fn=guidance_fn,
            lpips_fn=lpips_fn, split_sds=split_sds,
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
            if gt_stack_nbytes(ds, model, nf, ip_table=ip_table) <= budget:
                mode = "pin"
            elif gt_stack_nbytes(ds, model, nf, store_u8=True, ip_table=ip_table) <= budget:
                mode = "pin-u8"
            else:
                mode = "lru"
        gt_stack = gt_select = gt_pos = None
        if mode in ("pin", "pin-u8"):
            gt_stack, gt_select, gt_pos = make_gt_batch_stack(
                ds, model, ds.train_idx, store_u8=(mode == "pin-u8"), ip_table=ip_table,
                device=dev)
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
                        if ip_table is not None:
                            batch["ref_ip"] = ip_table[frame]
                        if len(batch_cache) > 32:
                            batch_cache.popitem(last=False)
                    else:
                        batch_cache.move_to_end(frame)
            with timer.phase("step"):
                draws = sample_step_draws(generator, cfg, latent_size=latent_size)
                if split_sds and state.step > stage_cfg.sds_start:
                    # Split SDS: the no-grad half (lite gen renders, VAE, the
                    # UNet's x0 target) first; the step consumes its target.
                    lat, c2w, sds_draws = step_fn.sds_prelude(state, batch, draws)
                    ref = "gt_rgb_crop" if st == 1 else "gt_normal_F"
                    batch = dict(batch, sds_target=guidance_fn.compute_target(
                        lat, c2w, state.step, sds_draws, ref_rgb=batch.get(ref),
                        ref_ip=batch.get("ref_ip")))
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
                       lpips_fn=eval_lpips, device=dev)
        print("eval:", json.dumps(res))


if __name__ == "__main__":
    main()
