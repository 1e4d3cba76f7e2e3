"""Reference-style YAML configs (port of ``soar_tpu.train.yaml_config``).

Reads the reference's config layout (``configs/gaussiansurfel_imagedream_
s0.yaml``) and this repo's ``configs/*.yaml`` with the port's own reader
(:mod:`soar_tpu_torch.io.yaml_subset`: the card has no PyYAML) and maps
them onto the port's dataclasses, with the JAX package's choices.
Step-scheduled values keep the threestudio ``C()`` 4-list form.  OmegaConf
interpolations (``${basename:...}``) stay strings, as in the JAX package:
the tags they build do not affect training.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from ..guidance.sds import GuidanceConfig
from ..io.yaml_subset import load_file
from .config import LossWeights, OptimConfig, StageConfig, TrainConfig


def _sched(v):
    return tuple(v) if isinstance(v, (list, tuple)) else float(v)


def load_yaml_config(path: str) -> Dict[str, Any]:
    """``{"train", "stage", "guidance", "guidance_kind", "guidance_ckpt",
    "prompt", "negative_prompt", "dataroot", "raw"}`` from the YAML at
    ``path``, as ``soar_tpu.train.yaml_config.load_yaml_config`` returns
    them."""
    cfg = load_file(path)

    data = cfg.get("data", {})
    system = cfg.get("system", {})
    loss = system.get("loss", {})
    geometry = system.get("geometry", {})
    guidance = system.get("guidance", {})
    trainer = cfg.get("trainer", {})

    weights = LossWeights(**{
        f.name: _sched(loss[f"lambda_{f.name}"])
        for f in dataclasses.fields(LossWeights) if f"lambda_{f.name}" in loss
    })
    # The reference spells two lambdas differently.
    alias = {"tv": "lambda_tv_loss", "depth_tv": "lambda_depth_tv_loss"}
    for ours, theirs in alias.items():
        if theirs in loss:
            weights = dataclasses.replace(weights, **{ours: _sched(loss[theirs])})

    # Deliberately not aliased: the YAMLs set ``scale_lr``, but the
    # reference's optimizer reads ``training_args.scaling_lr``
    # (``surfel_base.py:650``), so the surfel scaling LR is always the
    # scaling_lr default there; mapping scale_lr would train differently.
    optim = OptimConfig(**{
        f.name: float(geometry[f.name])
        for f in dataclasses.fields(OptimConfig)
        if f.name in geometry and f.name != "spatial_lr_scale"
    })

    stage = StageConfig(
        training_stage=int(system.get("training_stage", 0)),
        max_steps=int(trainer.get("max_steps", 1000)),
        sds_start=0 if system.get("training_stage", 0) == 1 else 500,
        loss=weights,
        min_step_percent=_sched(guidance.get("min_step_percent", 0.02)),
        max_step_percent=_sched(guidance.get("max_step_percent", (0, 0.75, 0.25, 2000))),
        guidance_scale=float(guidance.get("guidance_scale", 5.0)),
    )

    train = TrainConfig(
        width=int(data.get("width", 512)),
        height=int(data.get("height", 512)),
        n_views=int(data.get("n_view", 4)),
        elevation_range=tuple(data.get("elevation_range", (-15.0, 30.0))),
        azimuth_range=tuple(data.get("azimuth_range", (-180.0, 180.0))),
        fovy_range=tuple(data.get("fovy_range", (15.0, 60.0))),
        camera_distance_range=tuple(data.get("camera_distance_range", (0.8, 1.0))),
        invert_bg_prob=float(system.get("background", {}).get("random_aug_prob", 0.5)),
        optim=optim,
        stage0=stage if stage.training_stage == 0 else StageConfig(),
        stage1=stage if stage.training_stage == 1 else TrainConfig().stage1,
    )

    gcfg = GuidanceConfig(
        guidance_scale=stage.guidance_scale,
        min_step_percent=stage.min_step_percent,
        max_step_percent=stage.max_step_percent,
        recon_loss=bool(guidance.get("recon_loss", True)),
        recon_std_rescale=float(guidance.get("recon_std_rescale", 0.2)),
    )

    guidance_kind = None
    gtype = system.get("guidance_type", "")
    if "imagedream" in gtype:
        guidance_kind = "imagedream"
    elif "mvdream" in gtype:
        guidance_kind = "mvdream"

    prompts = system.get("prompt_processor", {})
    return {
        "train": train,
        "stage": stage,
        "guidance": gcfg,
        "guidance_kind": guidance_kind,
        "guidance_ckpt": guidance.get("ckpt_path"),
        "prompt": prompts.get("prompt"),
        "negative_prompt": prompts.get("negative_prompt"),
        "dataroot": data.get("dataroot"),
        "raw": cfg,
    }
