"""Multi-view SDS diffusion guidance, ImageDream / MVDream (port of
``soar_tpu.guidance.sds``).

Encode the rendered views to latents (with gradient), noise them at a
timestep drawn from the annealed [min, max]-percent window, run the frozen
4-view UNet twice (classifier-free guidance) and return the
x0-reconstruction loss with ``recon_std_rescale``, or plain SDS.

The networks are injected as callables, so the math is testable without
pretrained weights:

    encode_fn(images [B, 3, H, W] in [0, 1], eps [B, 4, h, w] or None)
        -> latents [B, 4, h, w]
    denoise_fn(latents [B2, 4, h, w], t [B2], context dict) -> eps [B2, 4, h, w]

The random draws come in as arguments (``draws``: ``u``, the timestep's
uniform; ``noise`` and ``vae_eps``, each [V, h, w, 4] as the JAX package
draws them), so a test can hand over the JAX package's.  Latents are NCHW
inside; the draws are read through a permuted view.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..train.config import Scheduled
from .scheduler import DDPMSchedule, at


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """The reference guidance config with the SOAR yaml overrides
    (``configs/gaussiansurfel_imagedream_s0.yaml:86-95``)."""

    guidance_scale: float = 5.0
    min_step_percent: Scheduled = 0.02
    max_step_percent: Scheduled = (0, 0.75, 0.25, 2000)
    n_view: int = 4
    image_size: int = 256
    recon_loss: bool = True
    recon_std_rescale: float = 0.2
    num_train_timesteps: int = 1000
    grad_clip: Optional[float] = None


def normalize_camera(c2w: torch.Tensor) -> torch.Tensor:
    """ImageDream camera conditioning: c2w with its translation scaled to
    unit norm, flattened to 16 floats."""
    t = c2w[..., :3, 3]
    scale = torch.clamp_min(torch.linalg.norm(t, dim=-1, keepdim=True), 1e-8)
    rot = c2w[..., :3, :3]
    top = torch.cat([rot, (t / scale)[..., None]], dim=-1)
    out = torch.cat([top, c2w[..., 3:, :]], dim=-2)
    return out.reshape(c2w.shape[:-2] + (16,))


def _scheduled_f32(value: Scheduled, step: int) -> np.float32:
    """:func:`soar_tpu_torch.train.config.scheduled` in float32 arithmetic,
    as the JAX package's jitted step evaluates it (XLA turns the division
    by the constant span into a product with its float32 reciprocal), so
    the timestep window's integer bounds truncate from the same value."""
    if isinstance(value, (int, float)):
        return np.float32(value)
    start, v0, v1, end = value
    t = np.float32(step - start) * (np.float32(1.0) / np.float32(max(end - start, 1e-8)))
    t = np.clip(t, np.float32(0.0), np.float32(1.0))
    return np.float32(v0) + np.float32(v1 - v0) * t


def timestep_window(cfg: GuidanceConfig, step: int) -> Tuple[int, float]:
    """The annealed timestep window at ``step``: ``(min_step, span)`` with
    ``span = max_step + 1 - min_step``, evaluated on the host."""
    n = np.float32(cfg.num_train_timesteps)
    min_step = int(n * _scheduled_f32(cfg.min_step_percent, step))
    max_step = int(n * _scheduled_f32(cfg.max_step_percent, step))
    return min_step, float(max_step + 1 - min_step)


def sample_timestep(cfg: GuidanceConfig, step: int, u: torch.Tensor,
                    window: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """t = min_step + int(u * (max_step + 1 - min_step)) in float32, from the
    annealed window at ``step`` (``imagedream_guidance.py:223-235``); a 0-d
    int64 tensor on ``u``'s device.  ``window``: :func:`timestep_window`'s
    ``(min_step, span)`` as float32 tensors, read in place of ``step`` (a
    CUDA graph reads them at their addresses); the same ``t``."""
    if window is None:
        min_step, span = timestep_window(cfg, step)
    else:
        min_step, span = window[0].to(torch.int64), window[1]
    return (u.to(torch.float32) * span).to(torch.int32).to(torch.int64) + min_step


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class MultiviewGuidance:
    """All trained weights live inside the injected callables."""

    def __init__(
        self,
        cfg: GuidanceConfig,
        encode_fn: Callable,
        denoise_fn: Callable,
        text_embeddings: torch.Tensor,  # [2, 77, D] (cond, uncond)
        image_embed_fn: Optional[Callable] = None,  # ref image -> ip tokens
    ):
        self.cfg = cfg
        self.encode_fn = encode_fn
        self.denoise_fn = denoise_fn
        self.text_embeddings = text_embeddings
        self.image_embed_fn = image_embed_fn
        self.schedule = DDPMSchedule.stable_diffusion(cfg.num_train_timesteps,
                                                      device=text_embeddings.device)

    def __call__(
        self,
        rgb: torch.Tensor,  # [V, H, W, 3] in [0, 1] (the gradient flows)
        c2w: torch.Tensor,  # [V, 4, 4]
        step: int,
        draws: Dict,
        ref_rgb: Optional[torch.Tensor] = None,
        ref_mask: Optional[torch.Tensor] = None,
        comp_bg: Optional[torch.Tensor] = None,
        ref_ip: Optional[torch.Tensor] = None,  # precomputed ip tokens [T, D]
        window: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        latents = self.encode_latents(rgb, draws.get("vae_eps"))
        target, t = self.compute_target(latents, c2w, step, draws, ref_rgb=ref_rgb,
                                        ref_mask=ref_mask, comp_bg=comp_bg, ref_ip=ref_ip,
                                        window=window)
        diff = latents - target
        B = latents.shape[0]
        loss = 0.5 * torch.sum(diff**2) / B
        # The reference's grad_norm: in recon mode the autograd of the
        # /B-scaled loss, ||latents - target|| / B; in plain SDS mode
        # ||w * (noise_pred - noise)||, un-scaled.
        grad_norm = torch.linalg.norm(diff.detach())
        if self.cfg.recon_loss:
            grad_norm = grad_norm / B
        return {"loss_sds": loss, "grad_norm": grad_norm, "t": t}

    def encode_latents(self, rgb: torch.Tensor, vae_eps: Optional[torch.Tensor]) -> torch.Tensor:
        """Resize the renders to the diffusion resolution (bilinear,
        antialiased when it shrinks, as ``jax.image.resize``) and
        VAE-encode them; the gradient flows.  Returns NCHW latents."""
        size = self.cfg.image_size
        x = _nchw(rgb)
        if tuple(x.shape[-2:]) != (size, size):
            x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                              antialias=True)
        return self.encode_fn(x, None if vae_eps is None else _nchw(vae_eps))

    def compute_target(
        self,
        latents: torch.Tensor,
        c2w: torch.Tensor,
        step: int,
        draws: Dict,
        ref_rgb: Optional[torch.Tensor] = None,
        ref_mask: Optional[torch.Tensor] = None,
        comp_bg: Optional[torch.Tensor] = None,
        ref_ip: Optional[torch.Tensor] = None,
        window: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The no-grad half: noise the latents, run the frozen UNet with
        CFG, reconstruct the x0 target (``imagedream_guidance.py:223-331``).
        Returns (detached target latents, t).  ``window``: the timestep
        window as tensors (:func:`sample_timestep`)."""
        cfg = self.cfg
        V = cfg.n_view
        sch = self.schedule
        latents = latents.detach()
        t = sample_timestep(cfg, step, draws["u"], window)
        noise = _nchw(draws["noise"])
        latents_noisy = sch.q_sample(latents, t, noise)

        # CFG batch: [cond views; uncond views].
        latent_in = torch.cat([latents_noisy] * 2, dim=0)
        t_in = t.expand(2 * V)
        camera = normalize_camera(c2w)
        cond, uncond = self.text_embeddings[0], self.text_embeddings[1]
        context = {
            "context": torch.cat([cond[None].expand(V, -1, -1), uncond[None].expand(V, -1, -1)]),
            "camera": torch.cat([camera] * 2, dim=0),
            "num_frames": V,
        }
        # The reference computes a ref/comp_bg composite and then overwrites
        # it with the raw reference image (``imagedream_guidance.py:
        # 191-195``), so ref_mask and comp_bg stay in the signature only.
        # Precomputed ip tokens (``ref_ip``) win; otherwise ``ref_rgb`` goes
        # through ``image_embed_fn``.  The uncond half sees zero tokens.
        del ref_mask, comp_bg
        if ref_ip is None and ref_rgb is not None and self.image_embed_fn is not None:
            ref_ip = self.image_embed_fn(ref_rgb)
        if ref_ip is not None:
            context["ip"] = torch.cat([ref_ip[None].expand(V, -1, -1),
                                       torch.zeros((V,) + tuple(ref_ip.shape),
                                                   dtype=ref_ip.dtype, device=ref_ip.device)])

        with torch.no_grad():
            noise_pred = self.denoise_fn(latent_in, t_in, context)
            noise_pred_text, noise_pred_uncond = noise_pred[:V], noise_pred[V:]
            noise_pred = noise_pred_uncond + cfg.guidance_scale * (
                noise_pred_text - noise_pred_uncond)

            if cfg.recon_loss:
                latents_recon = sch.predict_start_from_noise(latents_noisy, t, noise_pred)
                if cfg.recon_std_rescale > 0:
                    recon_nocfg = sch.predict_start_from_noise(latents_noisy, t, noise_pred_text)
                    # Per-view-group std matching (``:304-324``); the group is
                    # the whole batch.  ddof 0, as jnp.std.
                    factor = (torch.std(recon_nocfg, correction=0) + 1e-8) / (
                        torch.std(latents_recon, correction=0) + 1e-8)
                    latents_recon = (cfg.recon_std_rescale * latents_recon * factor
                                     + (1.0 - cfg.recon_std_rescale) * latents_recon)
                target = latents_recon
            else:
                w = 1.0 - at(sch.alphas_cumprod, t)
                grad = w * (noise_pred - noise)
                if cfg.grad_clip is not None:
                    grad = torch.clamp(grad, -cfg.grad_clip, cfg.grad_clip)
                grad = torch.nan_to_num(grad)
                target = latents - grad
        return target, t


def mock_denoiser(schedule: DDPMSchedule, x0_target: Optional[torch.Tensor] = None):
    """Test denoiser.  With ``x0_target=None`` it returns the exact noise
    implied by reconstructing the input as x0 = 0; with a target (NCHW),
    the noise implied by x0 = x0_target, so SDS pulls toward the target."""

    def fn(latents_noisy, t, context):
        a = at(schedule.sqrt_alphas_cumprod, t[0])
        s = at(schedule.sqrt_one_minus_alphas_cumprod, t[0])
        x0 = (torch.zeros_like(latents_noisy) if x0_target is None
              else torch.cat([x0_target] * 2, dim=0))
        return (latents_noisy - a * x0) / s

    return fn


def mock_encoder(downscale: int = 8):
    """Test VAE-encoder stand-in: average-pool, then a zero 4th channel."""

    def fn(images, eps=None):
        B, C, H, W = images.shape
        h, w = H // downscale, W // downscale
        x = images.reshape(B, C, h, downscale, w, downscale).mean((3, 5))
        return torch.cat([x, torch.zeros((B, 1, h, w), dtype=x.dtype, device=x.device)], dim=1)

    return fn
