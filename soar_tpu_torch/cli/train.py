"""Two-stage training CLI (port of ``soar_tpu.cli.train``).

    python -m soar_tpu_torch.cli.train --dataroot data/custom/<seq> \
        --smpl-model SMPLX_NEUTRAL.npz --out outputs/<seq> [--stage both] [--steps 1000]
    python -m soar_tpu_torch.cli.train --synthetic --steps 3 [--device cpu]
    python -m soar_tpu_torch.cli.train --dataroot D --smpl-model test:10,7,28 --num-subdiv 3 \
        --guidance imagedream --mock-guidance [--lpips-weights lpips_vgg16.pkl] [--eval]
    python -m soar_tpu_torch.cli.train --config configs/surfel_stage0.yaml --dataroot D \
        --smpl-model M [--import-ckpt reference.ckpt] [--trace-steps 2] [--wandb]

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
``--eval``.  ``--config`` reads a YAML config (this repo's
``configs/*.yaml`` or the reference's; :mod:`soar_tpu_torch.train.
yaml_config`): its stage, step count, loss weights, learning rates, camera
ranges, guidance kind, data root and prompt fill whatever the flags leave
unset, and an explicitly passed flag wins.  ``--import-ckpt`` warm-starts
from a reference Lightning ``.ckpt``: its explicit surfel tensors by name
and, in a field-driven run, its attribute field distilled into the hash
field.  ``--trace-steps N`` writes a ``torch.profiler`` Chrome trace of
stage 0's first N steps under ``<out>/trace``; ``--wandb`` also logs to
wandb when it is installed.  ``--multichip`` under ``torchrun
--nproc_per_node=N`` trains on N devices, one process each
(:mod:`soar_tpu_torch.parallel`: the gen views sharded, the GT passes
row-sharded, the gradients averaged), and only rank 0 writes metrics,
checkpoints, images and the eval; in one process it warns and trains on
the one device.  The flags and defaults are the JAX CLI's.

    torchrun --nproc_per_node=4 -m soar_tpu_torch.cli.train --multichip --synthetic
"""

from __future__ import annotations

import argparse
import json
import os
import time

def resolve_stage_cfg(yaml_cfg, st: int, steps_arg):
    """Stage config precedence: an explicitly passed ``--steps`` wins, else
    the YAML's ``trainer.max_steps`` stands (the C() anneals and the SDS
    warm-up key off max_steps), else the 1000-step default."""
    import dataclasses as dc

    from ..train.config import StageConfig, stage1_config

    if yaml_cfg is not None and yaml_cfg["stage"].training_stage == st:
        stage_cfg = yaml_cfg["stage"]
        if steps_arg is not None:
            stage_cfg = dc.replace(stage_cfg, max_steps=steps_arg)
        return stage_cfg
    n = 1000 if steps_arg is None else steps_arg
    return StageConfig(max_steps=n) if st == 0 else stage1_config(n)


def resolve_cli_stage(arg_stage, yaml_cfg) -> str:
    """The stage(s) to run: an explicit ``--stage`` (``both`` included)
    always wins; else a ``--config`` YAML's single stage; else both."""
    if arg_stage is not None:
        return arg_stage
    if yaml_cfg is not None:
        ys = yaml_cfg["stage"]
        print(f"--config defines stage {ys.training_stage}; running only "
              "that stage (pass --stage 0|1|both to override)")
        return str(ys.training_stage)
    return "both"


def resolve_guidance_kind(kind: str, from_yaml: bool, *, ckpt, embeddings, clip_dir,
                          mock: bool) -> str:
    """Gate guidance on its user-supplied weights.  A YAML-requested
    guidance degrades (loudly) to reconstruction-only when the weights are
    absent; an explicitly passed ``--guidance`` is an error instead."""
    if kind in (None, "none"):
        return "none"
    missing = []
    if not (ckpt or mock):
        missing.append("--guidance-ckpt (or --mock-guidance)")
    if not (embeddings or clip_dir or mock):
        missing.append("--prompt-embeddings / --clip-model-dir (or --mock-guidance)")
    if not missing:
        return kind
    msg = f"guidance '{kind}' needs user-supplied weights: missing {'; '.join(missing)}"
    if from_yaml:
        print(f"warning: {msg} — training WITHOUT SDS guidance (pass the weights, "
              "--mock-guidance, or an explicit --guidance to silence)")
        return "none"
    raise SystemExit(msg)


def import_reference_warm_start(path, params, use_explicit: bool, device):
    """``--import-ckpt``: the reference ``.ckpt``'s explicit surfel tensors
    copied into ``params`` by name; in a field-driven run its attribute
    field's predictions at the canonical points are distilled into the hash
    field (``reset_field``, 1000 steps, minibatch 65,536 above 100k points),
    so the warm start covers the rendered colours, scales and quats too.
    Unlike ``--resume`` it restores no step counter.  Returns the imported
    field names."""
    import torch

    from ..field.attribute_field import reset_field
    from ..field.reference_import import reference_field_apply
    from ..io.checkpoint import (
        apply_reference_tensors,
        import_reference_ckpt,
        import_reference_field_from_ckpt,
        load_reference_state_dict,
    )

    ref_sd = load_reference_state_dict(path)
    mapped = import_reference_ckpt(path, like=params, state_dict=ref_sd)
    apply_reference_tensors(params, mapped)
    rf = import_reference_field_from_ckpt(path, state_dict=ref_sd, device=device)
    if rf is not None and not use_explicit:
        t_f = time.time()
        with torch.no_grad():
            ref_attrs = reference_field_apply(rf, params.xyz)
        n = int(params.xyz.shape[0])
        reset_field(params.field, params.xyz, ref_attrs["shs"], ref_attrs["scales"],
                    ref_attrs["quats"], steps=1000,
                    batch_size=65536 if n > 100_000 else None,
                    generator=torch.Generator(device=params.xyz.device).manual_seed(0))
        print(f"distilled reference attribute field into the hash field "
              f"({time.time() - t_f:.1f}s)")
    elif rf is not None:
        print("warning: --use-explicit ignores the checkpoint's attribute-field weights "
              "(colors/scales/quats come from the explicit tensors)")
    print(f"imported reference ckpt {path} ({sorted(mapped)})")
    return sorted(mapped)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None,
                    help="YAML config (configs/*.yaml or a reference threestudio-soar YAML); "
                    "flags passed explicitly still win")
    ap.add_argument("--dataroot", type=str, default=None)
    ap.add_argument("--smpl-model", type=str, default=None,
                    help="SMPL-X .npz, SMPL .pkl, or test:J,S,R (the procedural body)")
    ap.add_argument("--out", type=str, default="outputs/run")
    ap.add_argument("--stage", type=str, default=None, choices=["0", "1", "both"],
                    help="default: the --config YAML's stage if given, else both")
    ap.add_argument("--steps", type=int, default=None,
                    help="steps per stage (default: the YAML's trainer.max_steps with "
                    "--config, else 1000)")
    ap.add_argument("--num-subdiv", type=int, default=2)
    ap.add_argument("--n-views", type=int, default=None,
                    help="gen views per step (default: the YAML's data.n_view with "
                    "--config, else 4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--use-explicit", action="store_true")
    ap.add_argument("--resume", type=str, default=None)
    ap.add_argument("--import-ckpt", type=str, default=None,
                    help="warm-start from a reference Lightning .ckpt: explicit surfel "
                    "tensors by name; in a field-driven run (no --use-explicit) its "
                    "attribute field is distilled into the hash field")
    ap.add_argument("--eval", action="store_true", help="run the test split at the end")
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--dump-every", type=int, default=250)
    ap.add_argument("--save-every", type=int, default=0,
                    help="mid-stage checkpoint every N steps to <out>/stage<K> "
                         "(0 = stage end only); restart with --resume <out>/stage<K>")
    ap.add_argument("--val-every", type=int, default=250)
    ap.add_argument("--wandb", action="store_true",
                    help="also log the metrics to wandb when it is installed")
    ap.add_argument("--lpips-weights", type=str, default=None,
                    help="LPIPS-VGG16 pickle (flax variables with numpy leaves, "
                    "docs/REAL_WEIGHTS.md section 1): the normal-LPIPS terms and the "
                    "LPIPS eval metric (the VGG RGB term also needs --lambda-vgg > 0)")
    ap.add_argument("--lambda-vgg", type=float, default=0.0,
                    help="weight of the VGG/LPIPS RGB loss (the reference's _fs "
                    "configs use 0.1); needs --lpips-weights")
    ap.add_argument("--trace-steps", type=int, default=0,
                    help="write a torch.profiler Chrome trace of stage 0's first N steps "
                    "under <out>/trace")
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

    guidance_from_yaml = False
    yaml_cfg = None
    if args.config:
        from ..train.yaml_config import load_yaml_config

        yaml_cfg = load_yaml_config(args.config)
        # The YAML fills in whatever the flags left unset.
        if args.dataroot is None and yaml_cfg["dataroot"] not in (None, "???"):
            args.dataroot = str(yaml_cfg["dataroot"])
        if args.prompt is None and yaml_cfg["prompt"] not in (None, "???"):
            args.prompt = str(yaml_cfg["prompt"])
        if args.guidance is None and yaml_cfg["guidance_kind"]:
            args.guidance = yaml_cfg["guidance_kind"]
            guidance_from_yaml = True
        if args.guidance_ckpt is None and yaml_cfg["guidance_ckpt"]:
            args.guidance_ckpt = str(yaml_cfg["guidance_ckpt"])
    args.stage = resolve_cli_stage(args.stage, yaml_cfg)
    args.guidance = resolve_guidance_kind(
        args.guidance, guidance_from_yaml, ckpt=args.guidance_ckpt,
        embeddings=args.prompt_embeddings, clip_dir=args.clip_model_dir,
        mock=args.mock_guidance)
    if not args.synthetic and not (args.dataroot and args.smpl_model):
        raise SystemExit("--dataroot and --smpl-model required (or --synthetic)")

    from .. import resolve_device

    dev = resolve_device(args.device)
    mesh, own_group = None, False
    if args.multichip:
        import torch.distributed as dist

        from ..parallel import make_view_mesh

        if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
            # torchrun's environment; one process per device.
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
            own_group = True
        if dist.is_initialized() and dist.get_world_size() > 1:
            mesh = make_view_mesh()
            dev = mesh.device
            print(f"multichip: rank {mesh.rank} of {mesh.world} on {dev} (gen views sharded, "
                  "GT passes row-sharded)")
        else:
            print("warning: --multichip with a single device; ignoring")
    try:
        _train(args, yaml_cfg, guidance_from_yaml, dev, mesh)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, yaml_cfg, guidance_from_yaml, dev, mesh):
    """The stages of :func:`main` on ``dev``; with ``mesh``, sharded over
    its group and only rank 0 writes files."""
    import dataclasses as dc
    from collections import OrderedDict

    import numpy as np
    import torch

    from ..avatar.renderer import RenderSettings, render_view
    from ..io.checkpoint import load_avatar, save_avatar
    from ..parallel import replicate, row_sharder, view_sharder
    from ..render.types import RasterConfig
    from ..train.config import TrainConfig
    from ..train.evaluate import evaluate
    from ..train.lpips import load_lpips, make_lpips_fn
    from ..train.observe import MetricLogger, dump_debug_images, profile_trace
    from ..train.trainer import (
        gt_stack_nbytes,
        init_train_state,
        make_gt_batch,
        make_gt_batch_stack,
        make_train_step,
        sample_step_draws,
    )
    from .common import real_setup, synthetic_setup

    writer = mesh is None or mesh.rank == 0
    if writer:
        os.makedirs(args.out, exist_ok=True)
    if yaml_cfg is not None:
        cfg = yaml_cfg["train"]
        if args.n_views is not None:
            cfg = dc.replace(cfg, n_views=args.n_views)
    else:
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

    if args.import_ckpt:
        import_reference_warm_start(args.import_ckpt, params, args.use_explicit, dev)
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
        stage_cfg = resolve_stage_cfg(yaml_cfg, st, args.steps)
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
        shard = {}
        if mesh is not None:
            # Every rank starts from rank 0's state.  No --composite switch
            # as in the JAX CLI, which falls back to the XLA composite here
            # because GSPMD cannot partition a Pallas call: each rank
            # launches the CUDA kernels on its own views and tile rows.
            replicate(mesh, [state.params, state.bg_params, state.opt])
            shard = dict(shard_views=view_sharder(mesh), shard_gt=row_sharder(mesh))
        step_fn = make_train_step(
            model, cfg, stage_cfg, opt,
            gen_size=gen_size, gt_size=ds.image_size, normal_size=normal_size,
            raster=raster, use_explicit=args.use_explicit,
            has_normals=has_normals, has_normal_B=has_normal_B, guidance_fn=guidance_fn,
            lpips_fn=lpips_fn, split_sds=split_sds, **shard,
        )
        logger = MetricLogger(args.out, use_wandb=args.wandb) if writer else None
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
        trace_ctx = (profile_trace(os.path.join(args.out, "trace"))
                     if writer and args.trace_steps > 0 and st == 0 else None)
        if trace_ctx:
            trace_ctx.__enter__()
        t0 = t_log = time.time()
        it_log = start_it
        for it in range(start_it, n_steps):
            frame = ds.train_idx[rng.randint(len(ds.train_idx))]
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
            if trace_ctx and it + 1 == args.trace_steps:
                trace_ctx.__exit__(None, None, None)
                trace_ctx = None
            if not writer:
                continue
            if it % args.log_every == 0 or it == n_steps - 1:
                # The metrics' reads wait for the device, so the wall time
                # since the last log line covers the steps between them.
                m = {k: round(float(v), 5) for k, v in metrics.items()}
                now = time.time()
                m["stage"] = st
                logger.log(global_step_base + it, m)
                m["sec_per_step"] = round((now - t_log) / (it + 1 - it_log), 3)
                t_log, it_log = now, it + 1
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
        params = state.params
        global_step_base += n_steps
        if not writer:
            continue
        if trace_ctx:
            trace_ctx.__exit__(None, None, None)
        logger.close()
        if hasattr(step_fn, "replays"):  # absent where a caller wraps make_train_step
            print(f"stage {st} step graphs: {step_fn.replays} steps replayed, "
                  f"{step_fn.captures} captured, {step_fn.eager} eager as a key's first "
                  f"(of {n_steps - start_it})")
        ckpt = os.path.join(args.out, f"stage{st}")
        save_avatar(ckpt, params, step=n_steps)
        print(f"saved {ckpt}")

    if args.eval and writer:
        res = evaluate(params, model, ds, save_dir=os.path.join(args.out, "test"),
                       settings=RenderSettings(use_explicit=args.use_explicit,
                                               raster=raster),
                       lpips_fn=eval_lpips, device=dev)
        print("eval:", json.dumps(res))


if __name__ == "__main__":
    main()
