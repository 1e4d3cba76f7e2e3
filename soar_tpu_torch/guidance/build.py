"""Assemble a trainer-ready ``guidance_fn``, ImageDream or MVDream (port of
``soar_tpu.guidance.build``).

One function returns a closure with the trainer's contract
(:func:`soar_tpu_torch.train.trainer.make_train_step`):

    guidance_fn(inp [V, H, W, 3], c2w [V, 4, 4], step, draws,
                ref_rgb=None, ref_mask=None, comp_bg=None, ref_ip=None) -> dict

with ``draws`` the step's SDS draws (``u``, ``noise``, ``vae_eps``; see
:func:`soar_tpu_torch.train.trainer.sample_step_draws`).  Weights come from
a torch LDM checkpoint (``ckpt_path``: the UNet under
``model.diffusion_model.``, the VAE under ``first_stage_model.``), or are
random at full shape (``mock=True``) or at the tiny test shapes
(``tiny=True``).  Mock weights are made on the device, in the compute
dtype, from an explicit ``torch.Generator``: a full-shape float32 UNet
would be 3.6 GB.

The networks are frozen: no weight requires a gradient, the UNet runs under
``torch.no_grad()``, and the VAE passes the gradient to its input only.
The JAX package's transport handles (``arg_params``, ``apply_with_params``,
``encode_latents_p``, ``make_fused_prelude``) exist there only to keep
weights out of XLA programs and have no counterpart here: the weights live
in the modules.  The image prompt's CLIP tower and Resampler arrive with a
later slice; until then ImageDream takes precomputed ip tokens
(``ref_ip``) only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device
from ..train.config import StageConfig
from .networks import MultiViewUNet, UNetConfig, VAEConfig, VAEEncoder
from .sds import GuidanceConfig, MultiviewGuidance


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """The ipmv image tower's shape, kept here for the ip tokens' width
    only (the tower itself arrives with a later slice)."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    layers: int = 32
    heads: int = 16
    output_dim: int = 1024

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=28, patch_size=14, width=32, layers=2, heads=2, output_dim=16)


@dataclasses.dataclass(frozen=True)
class ResamplerConfig:
    """The ImageDream Resampler's shape; ``num_queries`` x ``output_dim``
    is the ip tokens' shape."""

    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12
    num_queries: int = 16
    embedding_dim: int = 1280
    output_dim: int = 1024
    ff_mult: int = 4

    @classmethod
    def tiny(cls) -> "ResamplerConfig":
        return cls(dim=16, depth=2, dim_head=4, heads=2, num_queries=4, embedding_dim=32,
                   output_dim=16, ff_mult=2)


@dataclasses.dataclass(frozen=True)
class NetworkShapes:
    """The guidance networks' shapes."""

    unet: UNetConfig
    vae: VAEConfig
    latent_size: int
    clip_cfg: CLIPVisionConfig
    resampler_cfg: ResamplerConfig
    context_dim: int

    @classmethod
    def full(cls) -> "NetworkShapes":
        return cls(unet=UNetConfig(), vae=VAEConfig(), latent_size=32,
                   clip_cfg=CLIPVisionConfig(), resampler_cfg=ResamplerConfig(),
                   context_dim=1024)

    @classmethod
    def tiny(cls, image_size: int = 32) -> "NetworkShapes":
        return cls(
            unet=UNetConfig(model_channels=16, channel_mult=(1, 2), num_res_blocks=1,
                            attention_levels=(0, 1), num_head_channels=8, context_dim=16),
            vae=VAEConfig(base_channels=16, channel_mult=(1, 2)),
            latent_size=image_size // 2,
            clip_cfg=CLIPVisionConfig.tiny(),
            resampler_cfg=ResamplerConfig.tiny(),
            context_dim=16,
        )

    @property
    def ip_shape(self):
        """The ip tokens' shape: (num_queries, output_dim)."""
        return (self.resampler_cfg.num_queries, self.resampler_cfg.output_dim)

    @property
    def vae_downscale(self) -> int:
        return 2 ** (len(self.vae.channel_mult) - 1)


def make_networks(shapes: NetworkShapes, with_ip: bool, dtype=torch.float32,
                  device="cuda"):
    """(UNet, VAE encoder) at ``shapes``, parameters allocated on ``device``
    in ``dtype`` and left uninitialised (``device="meta"``: shapes only)."""
    with torch.device("meta"):
        unet = MultiViewUNet(shapes.unet, ip_dim=shapes.ip_shape[1] if with_ip else 0)
        vae = VAEEncoder(shapes.vae)
    unet, vae = unet.to(dtype), vae.to(dtype)
    if str(device) != "meta":
        unet, vae = unet.to_empty(device=device), vae.to_empty(device=device)
    return unet, vae


@torch.no_grad()
def random_init_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Mock weights in place, on the module's device and in its dtype, with
    the JAX package's shape heuristic (``_random_like_on_device``): norm
    weights 1, biases 0, every other weight N(0, 0.2² / fan_in).  Only the
    architecture's cost is exercised; the values mean nothing."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1:
            p.fill_(1.0)
        else:
            fan_in = math.prod(p.shape[1:])
            p.normal_(0.0, 0.2 / max(fan_in, 1) ** 0.5, generator=generator)
    return module


_UNET_PREFIX = "model.diffusion_model."
_VAE_PREFIX = "first_stage_model."


def load_guidance_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A torch LDM checkpoint -> ``{"unet": state_dict, "vae": state_dict}``
    with the UNet's keys under ``model.diffusion_model.`` and the VAE
    encoder's (``encoder.*``, ``quant_conv.*``) under
    ``first_stage_model.``, prefixes stripped; a top-level ``quant_conv.``
    counts as the VAE's.  The decoder, CLIP and Resampler keys are not
    read."""
    # weights_only=False: MVDream / ImageDream checkpoints carry pickled
    # configs and Lightning metadata.
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    unet = {k[len(_UNET_PREFIX):]: v for k, v in sd.items() if k.startswith(_UNET_PREFIX)}
    vae = {k: v for k, v in sd.items() if k.startswith("quant_conv.")}
    for k, v in sd.items():
        if k.startswith(_VAE_PREFIX) and k[len(_VAE_PREFIX):].startswith(("encoder.",
                                                                         "quant_conv.")):
            vae[k[len(_VAE_PREFIX):]] = v
    return {"unet": unet, "vae": vae}


def _freeze(m: torch.nn.Module) -> torch.nn.Module:
    return m.eval().requires_grad_(False)


def build_guidance(
    kind: str,
    stage: StageConfig,
    *,
    generator: Optional[torch.Generator] = None,
    ckpt_path: Optional[str] = None,
    text_embeddings=None,  # [2, 77, D] (cond, uncond), numpy or tensor
    mock: bool = False,
    tiny: bool = False,
    image_size: int = 256,
    n_view: int = 4,
    dtype=torch.float32,
    device="cuda",
) -> Callable:
    """The guidance closure for :func:`make_train_step`.

    ``kind``: "imagedream" (image-prompted, ``sd-v2.1-base-4view-ipmv``) or
    "mvdream" (text-only, ``sd-v2.1-base-4view``).  ``generator`` (on
    ``device``; seed 0 when None) draws the mock weights, UNet then VAE,
    then the mock text embeddings.  The closure carries ``unet``, ``vae``,
    ``shapes``, ``latent_size``, ``guidance`` (its
    :class:`MultiviewGuidance`) and ``for_stage(stage)``, which rebinds the
    per-stage scalars to the same networks."""
    if kind not in ("imagedream", "mvdream"):
        raise ValueError(f"unknown guidance kind {kind!r}")
    dev = resolve_device(device)
    shapes = NetworkShapes.tiny(image_size) if tiny else NetworkShapes.full()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with_ip = kind == "imagedream"
    unet, vae = make_networks(shapes, with_ip, dtype=dtype, device=dev)
    if ckpt_path is not None:
        sds = load_guidance_checkpoint(ckpt_path)
        unet.load_state_dict(sds["unet"], strict=True)
        vae.load_state_dict(sds["vae"], strict=True)
        del sds
    elif mock or tiny:
        random_init_(unet, generator)
        random_init_(vae, generator)
    else:
        raise ValueError("build_guidance needs ckpt_path, mock=True, or tiny=True")
    unet, vae = _freeze(unet), _freeze(vae)

    if text_embeddings is None:
        if not (mock or tiny):
            raise ValueError("text_embeddings required unless mock/tiny")
        text_embeddings = torch.randn((2, 77, shapes.context_dim), generator=generator,
                                      device=dev)
    text_embeddings = torch.as_tensor(text_embeddings, dtype=torch.float32, device=dev)

    def encode_fn(images01, eps):
        return vae(images01.to(dtype), eps).to(torch.float32)

    @torch.no_grad()
    def denoise_fn(latents, t, context):
        ctx = {k: (v.to(dtype) if isinstance(v, torch.Tensor) else v)
               for k, v in context.items()}
        return unet(latents.to(dtype), t, ctx).to(torch.float32)

    def _assemble(stage: StageConfig) -> Callable:
        gcfg = GuidanceConfig(
            guidance_scale=stage.guidance_scale,
            min_step_percent=stage.min_step_percent,
            max_step_percent=stage.max_step_percent,
            n_view=n_view,
            image_size=image_size,
        )
        mv = MultiviewGuidance(gcfg, encode_fn, denoise_fn, text_embeddings)

        def guidance_fn(inp, c2w, step, draws, ref_rgb=None, ref_mask=None, comp_bg=None,
                        ref_ip=None):
            if kind != "imagedream":
                ref_ip = None
            elif ref_ip is None:
                raise ValueError(
                    "imagedream guidance needs precomputed ip tokens (batch['ref_ip'], "
                    f"{shapes.ip_shape}); the CLIP tower and Resampler that embed the "
                    "reference image arrive with the next slice of the port")
            return mv(inp, c2w, step, draws, ref_rgb=ref_rgb, ref_mask=ref_mask,
                      comp_bg=comp_bg, ref_ip=ref_ip)

        guidance_fn.unet, guidance_fn.vae = unet, vae
        guidance_fn.shapes = shapes
        guidance_fn.latent_size = image_size // shapes.vae_downscale
        guidance_fn.guidance = mv
        guidance_fn.for_stage = _assemble
        return guidance_fn

    return _assemble(stage)
