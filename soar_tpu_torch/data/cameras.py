"""Random training-camera sampling from a ``torch.Generator`` (port of
``soar_tpu.data.cameras``).

The distributions of the reference dataset's per-step camera draw
(``data/uncond_multiview.py:430-607``): elevation either uniform in
degrees or uniform on the sphere (a coin flip), azimuths stratified over
the batch, fovy / distance / zoom uniform with the relative-radius
convention, OpenGL look-at poses with up = +z.  One draw takes six
uniforms; :func:`multiview_cameras_from_uniforms` maps them, so a test can
hand it the JAX package's own uniforms.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..core.camera import look_at_c2w
from ..core.constants import constant


@dataclasses.dataclass(frozen=True)
class CameraSampleConfig:
    n_view: int = 4
    elevation_range: Tuple[float, float] = (-15.0, 30.0)
    azimuth_range: Tuple[float, float] = (-180.0, 180.0)
    fovy_range: Tuple[float, float] = (15.0, 60.0)
    camera_distance_range: Tuple[float, float] = (0.8, 1.0)
    zoom_range: Tuple[float, float] = (1.0, 1.0)
    relative_radius: bool = True


def _lerp(u, lo, hi):
    return u * (hi - lo) + lo


def multiview_cameras_from_uniforms(
    u: torch.Tensor, cfg: CameraSampleConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``u`` = [6] uniforms in [0, 1): (elevation coin, elevation, azimuth
    offset, fovy, distance, zoom), in the JAX package's key order.  Returns
    (c2w [n_view, 4, 4], fovy [n_view] radians) on ``u``'s device."""
    n = cfg.n_view
    dev = u.device
    el0, el1 = cfg.elevation_range
    elev_uniform = _lerp(u[1], el0, el1)
    p0, p1 = (el0 + 90.0) / 180.0, (el1 + 90.0) / 180.0
    elev_sphere = torch.arcsin(2.0 * _lerp(u[1], p0, p1) - 1.0) / math.pi * 180.0
    elevation_deg = torch.where(u[0] < 0.5, elev_uniform, elev_sphere)
    elevation = torch.deg2rad(elevation_deg).expand(n)

    # Stratified azimuths covering the range (``uncond_multiview.py:459-468``).
    az0, az1 = cfg.azimuth_range
    ar = torch.arange(n, dtype=torch.float32, device=dev)
    azimuth = torch.deg2rad((u[2] + ar) / n * (az1 - az0) + az0)

    fovy = torch.deg2rad(_lerp(u[3], *cfg.fovy_range)).expand(n)
    dist = _lerp(u[4], *cfg.camera_distance_range)
    if cfg.relative_radius:
        dist = dist / torch.tan(0.5 * fovy)
    fovy = fovy * _lerp(u[5], *cfg.zoom_range)

    # Spherical -> cartesian in the sampler frame: x back, y right, z up.
    pos = torch.stack(
        [
            dist * torch.cos(elevation) * torch.cos(azimuth),
            dist * torch.cos(elevation) * torch.sin(azimuth),
            dist * torch.sin(elevation),
        ],
        dim=-1,
    )
    up = constant((0.0, 0.0, 1.0), torch.get_default_dtype(), dev).expand(n, 3)
    return look_at_c2w(pos, torch.zeros_like(pos), up), fovy


def sample_multiview_cameras(
    generator: torch.Generator, cfg: CameraSampleConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (c2w [n_view, 4, 4], fovy [n_view] radians) on the
    generator's device."""
    u = torch.rand(6, generator=generator, device=generator.device)
    return multiview_cameras_from_uniforms(u, cfg)


def head_camera_config(n_view: int = 4) -> CameraSampleConfig:
    """The close-up "head" draw (``gaussian_batch_renderer.py:264-276``):
    the reference's distance 0.28 is relative (0.28 / tan(fovy / 2)) and
    aimed at the origin, as the JAX package keeps it."""
    return CameraSampleConfig(
        n_view=n_view,
        elevation_range=(-10.0, 20.0),
        camera_distance_range=(0.28, 0.28),
        fovy_range=(30.0, 45.0),
    )


def sample_head_cameras(
    generator: torch.Generator, n_view: int = 4
) -> Tuple[torch.Tensor, torch.Tensor]:
    return sample_multiview_cameras(generator, head_camera_config(n_view))
