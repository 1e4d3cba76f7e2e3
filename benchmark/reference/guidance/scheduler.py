"""DDPM noise schedule, Stable Diffusion's scaled-linear betas (port of
``soar_tpu.guidance.scheduler``).

The diffusion-side math the guidance needs: ``q_sample`` and
``predict_start_from_noise``.  The tables are computed in float32 numpy as
the JAX package computes them, then moved to the device once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device


class DDPMSchedule(NamedTuple):
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor

    @staticmethod
    def stable_diffusion(num_timesteps: int = 1000, device="cuda") -> "DDPMSchedule":
        """SD's "scaled_linear": betas = linspace(sqrt(8.5e-4), sqrt(1.2e-2))²."""
        dev = resolve_device(device)
        betas = (np.linspace(0.00085**0.5, 0.012**0.5, num_timesteps) ** 2).astype(np.float32)
        ac = np.cumprod(1.0 - betas)
        return DDPMSchedule(*(torch.as_tensor(a).to(dev) for a in
                              (betas, ac, np.sqrt(ac), np.sqrt(1.0 - ac))))

    def q_sample(self, x0: torch.Tensor, t, noise: torch.Tensor) -> torch.Tensor:
        """Forward diffusion: x_t = sqrt(ac_t) x0 + sqrt(1-ac_t) eps."""
        return at(self.sqrt_alphas_cumprod, t) * x0 + at(self.sqrt_one_minus_alphas_cumprod,
                                                         t) * noise

    def predict_start_from_noise(self, x_t: torch.Tensor, t, noise: torch.Tensor) -> torch.Tensor:
        """x0 = (x_t - sqrt(1-ac_t) eps) / sqrt(ac_t)."""
        return (x_t - at(self.sqrt_one_minus_alphas_cumprod, t) * noise) / at(
            self.sqrt_alphas_cumprod, t)


def at(table: torch.Tensor, t) -> torch.Tensor:
    """``table[t]`` for a Python int or an integer tensor of any shape.  A
    tensor index goes through ``index_select`` on the device: indexing with
    a 0-d tensor would read it on the host, a sync every call."""
    if isinstance(t, torch.Tensor):
        return table.index_select(0, t.reshape(-1)).reshape(t.shape)
    return table[t]
