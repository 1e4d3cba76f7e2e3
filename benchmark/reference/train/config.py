"""Training configuration: dataclasses + step-scheduled hyperparameters
(port of ``soar_tpu.train.config``; every default unchanged).

Scheduled values follow threestudio's ``C()`` convention: a plain float, or
``[start_step, v0, v1, end_step]`` linearly interpolated.  The port's step
counter is a Python int, so :func:`scheduled` returns a Python float.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

Scheduled = Union[float, Tuple[float, float, float, float]]


def scheduled(value: Scheduled, step: int) -> float:
    """Evaluate a possibly step-scheduled value at ``step``."""
    if isinstance(value, (int, float)):
        return float(value)
    start, v0, v1, end = value
    t = min(max((step - start) / max(end - start, 1e-8), 0.0), 1.0)
    return v0 + (v1 - v0) * t


@dataclasses.dataclass(frozen=True)
class LossWeights:
    """Loss lambdas; defaults = stage-0 config
    (``configs/gaussiansurfel_imagedream_s0.yaml:112-131``)."""

    sds: Scheduled = 1e-4
    recon: Scheduled = 1.0
    mask: Scheduled = 1.0
    normal_F: Scheduled = 1.0
    normal_B: Scheduled = 1.0
    normal_mask: Scheduled = 1.0
    normal_consistency: Scheduled = 0.01
    vgg: Scheduled = 0.0
    sparsity: Scheduled = 0.0
    position: Scheduled = 0.0
    opacity: Scheduled = 0.0
    scales: Scheduled = 0.1
    tv: Scheduled = 0.0
    depth_tv: Scheduled = 0.0
    delta: Scheduled = 1.0
    occ: Scheduled = 0.1
    curv: Scheduled = 0.5
    # Dead in the reference (no system reads lambda_offsets); kept for the
    # config surface, unwired as in the JAX package.
    offsets: Scheduled = 0.1


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Per-group learning rates (s0 yaml overrides of
    ``geometry/surfel_base.py:83-99``)."""

    position_lr_init: float = 0.000016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 1000
    spatial_lr_scale: float = 10.0
    feature_lr: float = 0.01
    opacity_lr: float = 0.01
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    occ_lr: float = 0.1
    field_lr: float = 0.01
    latent_pose_lr: float = 0.01
    background_lr: float = 0.001
    eps: float = 1e-15  # Adam eps (``surfel_base.py:680``)


@dataclasses.dataclass(frozen=True)
class StageConfig:
    """Per-stage knobs: the two training stages differ only here."""

    training_stage: int = 0
    max_steps: int = 1000
    sds_start: int = 500
    loss: LossWeights = LossWeights()
    min_step_percent: Scheduled = 0.02
    max_step_percent: Scheduled = (0, 0.75, 0.25, 2000)
    guidance_scale: float = 5.0
    # Per-stage optimizer override; None = use TrainConfig.optim.
    optim: Optional[OptimConfig] = None


def stage1_config(max_steps: int = 1000) -> StageConfig:
    """s1 yaml deltas: lambda_mask 10, SDS anneal ends at 1000, and the xyz
    LR stays flat at 1.6e-5."""
    return StageConfig(
        training_stage=1,
        max_steps=max_steps,
        sds_start=0,
        loss=LossWeights(mask=10.0),
        max_step_percent=(0, 0.75, 0.25, 1000),
        optim=OptimConfig(position_lr_final=0.000016),
    )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    width: int = 512
    height: int = 512
    n_views: int = 4  # gen views per step
    elevation_range: Tuple[float, float] = (-15.0, 30.0)
    azimuth_range: Tuple[float, float] = (-180.0, 180.0)
    fovy_range: Tuple[float, float] = (15.0, 60.0)
    camera_distance_range: Tuple[float, float] = (0.8, 1.0)
    zoom_range: Tuple[float, float] = (1.0, 1.0)
    relative_radius: bool = True
    invert_bg_prob: float = 0.5
    # Close-up "head" camera probability (the reference's head_p; 0.0
    # reproduces the reference's effective gen-view distribution).
    head_prob: float = 0.4
    optim: OptimConfig = OptimConfig()
    stage0: StageConfig = StageConfig()
    stage1: StageConfig = stage1_config()
