"""Assemble a trainer-ready ``guidance_fn``, ImageDream or MVDream (port of
``soar_tpu.guidance.build``).

One function returns a closure with the trainer's contract
(:func:`soar_tpu_torch.train.trainer.make_train_step`):

    guidance_fn(inp [V, H, W, 3], c2w [V, 4, 4], step, draws,
                ref_rgb=None, ref_mask=None, comp_bg=None, ref_ip=None,
                window=None) -> dict

with ``draws`` the step's SDS draws (``u``, ``noise``, ``vae_eps``; see
:func:`soar_tpu_torch.train.trainer.sample_step_draws`) and ``window`` the
timestep window at ``step`` as tensors, which the trainer makes from
``guidance_fn.timestep_window(step)`` (a CUDA graph of the step reads it
in place of the host's ``step``).  Weights come from
a torch LDM checkpoint (``ckpt_path``: the UNet under
``model.diffusion_model.``, the VAE under ``first_stage_model.``, and for
ImageDream the Resampler under ``image_proj_model.`` and the CLIP tower
under ``embedder.model.visual.`` or ``image_embedder.model.visual.``), or
are random at full shape (``mock=True``) or at the tiny test shapes
(``tiny=True``).  Mock weights are made on the device, in the compute
dtype, from an explicit ``torch.Generator``: a full-shape float32 UNet
would be 3.6 GB.

The networks are frozen: no weight requires a gradient, the UNet and the
image tower run under ``torch.no_grad()``, and the VAE passes the gradient
to its input only.  ImageDream's image prompt: precomputed ip tokens
(``ref_ip``, from ``guidance_fn.embed_ref`` once per frame) win; otherwise
``ref_rgb`` is embedded in the call; with neither the call raises.
``release_image_encoder()`` drops the CLIP tower and the Resampler once
every frame is embedded.  ``encode_latents`` and ``compute_target`` are the
two halves of split SDS (the trainer's ``split_sds``).  The JAX package's
transport handles (``arg_params``, ``apply_with_params``,
``encode_latents_p``, ``make_fused_prelude``) exist there only to keep
weights out of XLA programs and have no counterpart here: the weights live
in the modules.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional

import torch

from .. import resolve_device
from ..train.config import StageConfig
from .clip_vit import (  # noqa: F401  (CLIPVisionConfig / ResamplerConfig re-exported)
    CLIPViT,
    CLIPVisionConfig,
    Resampler,
    ResamplerConfig,
    clip_state_dict_for,
    make_image_embed_fn,
)
from .networks import MultiViewUNet, UNetConfig, VAEConfig, VAEEncoder
from .sds import GuidanceConfig, MultiviewGuidance, timestep_window


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
    return _materialise(unet, dtype, device), _materialise(vae, dtype, device)


def make_image_encoder(shapes: NetworkShapes, dtype=torch.float32, device="cuda"):
    """(CLIP tower in penultimate mode, Resampler) at ``shapes``, as
    :func:`make_networks` makes the UNet and the VAE."""
    with torch.device("meta"):
        clip, res = CLIPViT(shapes.clip_cfg), Resampler(shapes.resampler_cfg)
    return _materialise(clip, dtype, device), _materialise(res, dtype, device)


def _materialise(module: torch.nn.Module, dtype, device) -> torch.nn.Module:
    module = module.to(dtype)
    return module if str(device) == "meta" else module.to_empty(device=device)


@torch.no_grad()
def random_init_(module: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Mock weights in place, on the module's device and in its dtype, with
    the JAX package's shape heuristic (``_random_like_on_device``): norm
    weights 1, biases 0, every other parameter N(0, 0.2² / fan_in), fan_in
    its size when it is 1-D (CLIP's class embedding).  Only the
    architecture's cost is exercised; the values mean nothing."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.ndim == 1 and name.endswith("weight"):
            p.fill_(1.0)
        else:
            fan_in = math.prod(p.shape[1:]) if p.ndim > 1 else p.numel()
            p.normal_(0.0, 0.2 / max(fan_in, 1) ** 0.5, generator=generator)
    return module


_UNET_PREFIX = "model.diffusion_model."
_VAE_PREFIX = "first_stage_model."
_RESAMPLER_PREFIX = "image_proj_model."
_CLIP_PREFIXES = ("embedder.model.visual.", "image_embedder.model.visual.")


def load_guidance_checkpoint(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """A torch LDM checkpoint -> ``{"unet": state_dict, "vae": state_dict}``
    with the UNet's keys under ``model.diffusion_model.`` and the VAE
    encoder's (``encoder.*``, ``quant_conv.*``) under
    ``first_stage_model.``, prefixes stripped; a top-level ``quant_conv.``
    counts as the VAE's.  When present, also ``"resampler"``
    (``image_proj_model.*``) and ``"clip"``, the visual tower under the
    first of ``embedder.model.visual.`` / ``image_embedder.model.visual.``
    that the checkpoint has.  The decoder and the text tower are not
    read."""
    # weights_only=False: MVDream / ImageDream checkpoints carry pickled
    # configs and Lightning metadata.
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]

    def under(prefix):
        return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}

    unet = under(_UNET_PREFIX)
    vae = {k: v for k, v in sd.items() if k.startswith("quant_conv.")}
    vae.update({k: v for k, v in under(_VAE_PREFIX).items()
                if k.startswith(("encoder.", "quant_conv."))})
    out = {"unet": unet, "vae": vae}
    if any(k.startswith(_RESAMPLER_PREFIX) for k in sd):
        out["resampler"] = under(_RESAMPLER_PREFIX)
    for prefix in _CLIP_PREFIXES:
        if any(k.startswith(prefix) for k in sd):
            out["clip"] = under(prefix)
            break
    return out


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
    ``device``; seed 0 when None) draws the mock weights, UNet, VAE, then
    for ImageDream the CLIP tower and the Resampler, then the mock text
    embeddings.  The closure carries ``unet``, ``vae``, ``shapes``,
    ``latent_size``, ``guidance`` (its :class:`MultiviewGuidance`),
    ``for_stage(stage)``, which rebinds the per-stage scalars to the same
    networks, and:

    - ``embed_ref(img [H, W, 3] in [0, 1]) -> [Q, D]`` float32 ip tokens
      (ImageDream; None for MVDream);
    - ``release_image_encoder()``: drops the CLIP tower and the Resampler
      (``image_encoder``, a dict holding both, empties), after which
      ``embed_ref`` raises;
    - ``encode_latents(rgb [V, H, W, 3], vae_eps)`` and
      ``compute_target(latents, c2w, step, draws, ref_rgb=None,
      ref_ip=None)``, the gradient and no-grad halves of split SDS."""
    if kind not in ("imagedream", "mvdream"):
        raise ValueError(f"unknown guidance kind {kind!r}")
    dev = resolve_device(device)
    shapes = NetworkShapes.tiny(image_size) if tiny else NetworkShapes.full()
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with_ip = kind == "imagedream"
    unet, vae = make_networks(shapes, with_ip, dtype=dtype, device=dev)
    clip = res = None
    if with_ip:
        clip, res = make_image_encoder(shapes, dtype=dtype, device=dev)
    if ckpt_path is not None:
        sds = load_guidance_checkpoint(ckpt_path)
        if with_ip and not ("clip" in sds and "resampler" in sds):
            # A checkpoint without the image towers is the text-only
            # sd-v2.1-base-4view: random towers would feed the real UNet
            # meaningless ip tokens.
            raise ValueError(
                f"checkpoint {ckpt_path} has no CLIP vision tower / image_proj_model — "
                "it is not the ImageDream 'sd-v2.1-base-4view-ipmv' variant; use "
                "kind='mvdream' with it, or supply the -ipmv checkpoint")
        unet.load_state_dict(sds["unet"], strict=True)
        vae.load_state_dict(sds["vae"], strict=True)
        if with_ip:
            clip.load_state_dict(clip_state_dict_for(clip, sds["clip"]), strict=True)
            res.load_state_dict(sds["resampler"], strict=True)
        del sds
    elif mock or tiny:
        for m in (unet, vae, clip, res):
            if m is not None:
                random_init_(m, generator)
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

    # The image towers live only in this holder, so releasing them frees
    # their memory.
    image_encoder = {"clip": None, "resampler": None}
    embed_ref = None
    if with_ip:
        image_encoder.update(clip=_freeze(clip), resampler=_freeze(res))
        del clip, res

        def embed_ref(img):
            """[H, W, 3] in [0, 1] (numpy or tensor) -> [Q, D] float32."""
            if image_encoder["clip"] is None:
                raise RuntimeError("image encoder released (release_image_encoder was "
                                   "called); rebuild the guidance to embed again")
            fn = make_image_embed_fn(image_encoder["clip"], image_encoder["resampler"])
            return fn(torch.as_tensor(img, device=dev)[..., :3])

    def release_image_encoder():
        """Drop the CLIP tower and the Resampler: only ``embed_ref`` needs
        them, once per frame before training."""
        image_encoder.update(clip=None, resampler=None)

    def image_prompt(ref_rgb, ref_ip):
        """The (ref_rgb, ref_ip) pair MultiviewGuidance gets: nothing for
        MVDream; for ImageDream the tokens when given, else the image."""
        if kind != "imagedream":
            return None, None
        if ref_ip is None and ref_rgb is None:
            raise ValueError(
                "imagedream SDS needs precomputed ip tokens (batch['ref_ip']) or the "
                "reference image; embed the per-frame references with "
                "guidance.embed_ref first (cli/train precomputes them), or run "
                "guidance mvdream")
        return (ref_rgb if ref_ip is None else None), ref_ip

    def _assemble(stage: StageConfig) -> Callable:
        gcfg = GuidanceConfig(
            guidance_scale=stage.guidance_scale,
            min_step_percent=stage.min_step_percent,
            max_step_percent=stage.max_step_percent,
            n_view=n_view,
            image_size=image_size,
        )
        mv = MultiviewGuidance(gcfg, encode_fn, denoise_fn, text_embeddings,
                               image_embed_fn=embed_ref)

        def guidance_fn(inp, c2w, step, draws, ref_rgb=None, ref_mask=None, comp_bg=None,
                        ref_ip=None, window=None):
            ref_rgb, ref_ip = image_prompt(ref_rgb, ref_ip)
            return mv(inp, c2w, step, draws, ref_rgb=ref_rgb, ref_mask=ref_mask,
                      comp_bg=comp_bg, ref_ip=ref_ip, window=window)

        def compute_target(latents, c2w, step, draws, ref_rgb=None, ref_ip=None):
            """Split SDS's no-grad half: the detached x0 target latents."""
            ref_rgb, ref_ip = image_prompt(ref_rgb, ref_ip)
            return mv.compute_target(latents, c2w, step, draws, ref_rgb=ref_rgb,
                                     ref_ip=ref_ip)[0]

        guidance_fn.unet, guidance_fn.vae = unet, vae
        guidance_fn.shapes = shapes
        guidance_fn.latent_size = image_size // shapes.vae_downscale
        guidance_fn.guidance = mv
        guidance_fn.embed_ref = embed_ref
        guidance_fn.image_encoder = image_encoder
        guidance_fn.release_image_encoder = release_image_encoder
        guidance_fn.encode_latents = mv.encode_latents
        guidance_fn.compute_target = compute_target
        guidance_fn.timestep_window = functools.partial(timestep_window, gcfg)
        guidance_fn.for_stage = _assemble
        return guidance_fn

    return _assemble(stage)
