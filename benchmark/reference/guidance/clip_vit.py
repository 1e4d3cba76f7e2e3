"""ImageDream's image prompt: the OpenCLIP ViT-H/14 vision tower and the
IP-Adapter Resampler (port of ``soar_tpu.guidance.clip_vit``).

The ``sd-v2.1-base-4view-ipmv`` model encodes the reference crop with a
frozen ViT-H/14 (:class:`CLIPViT`) and resamples its 257 tokens into 16
image-prompt (``ip``) tokens of width 1024 (:class:`Resampler`), which the
UNet's cross-attentions read through their ``to_k_ip`` / ``to_v_ip``
projections.

- :class:`CLIPViT` is open_clip's ``VisionTransformer`` forward: pre-LN
  blocks, one packed qkv projection, exact GELU.  ``features`` picks what
  it returns: ``"penultimate"`` (the default, IP-Adapter's convention) the
  tokens entering the last block, so the module holds no last block, no
  ``ln_post`` and no ``proj``; ``"tokens"`` every block and ``ln_post``;
  ``"pooled"`` the class token through ``ln_post`` and ``proj``.
- :class:`Resampler` is IP-Adapter-plus's: learned latent queries, then
  per layer a Perceiver attention (keys are the image tokens concatenated
  with the latents; bias-free projections; scale 1/sqrt(dim_head)) and a
  LayerNorm -> Linear -> exact GELU -> Linear feed-forward without biases,
  then ``proj_out`` and ``norm_out``.

Parameters carry open_clip's and IP-Adapter's names, so ``state_dict()``
equals :func:`soar_tpu_torch.guidance.manifest.clip_vit_h_key_manifest` /
:func:`resampler_key_manifest` under their prefixes and a checkpoint loads
strictly (:func:`clip_state_dict_for` drops the keys a penultimate tower
does not hold).  Attention is ``scaled_dot_product_attention``: the JAX
package computes it with ``einsum`` and ``softmax``, outside any Pallas
kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """OpenCLIP ViT-H/14 vision tower (the ipmv image embedder)."""

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
    """IP-Adapter Resampler as ImageDream configures it; ``num_queries`` x
    ``output_dim`` is the ip tokens' shape."""

    dim: int = 1024
    depth: int = 4
    dim_head: int = 64
    heads: int = 12  # inner width 768
    num_queries: int = 16
    embedding_dim: int = 1280  # the CLIP tokens' width
    output_dim: int = 1024  # the UNet's context width
    ff_mult: int = 4

    @classmethod
    def tiny(cls) -> "ResamplerConfig":
        return cls(dim=16, depth=2, dim_head=4, heads=2, num_queries=4, embedding_dim=32,
                   output_dim=16, ff_mult=2)


def _heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, heads * d] -> [B, heads, T, d]."""
    B, T, C = x.shape
    return x.reshape(B, T, heads, C // heads).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    B, h, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, h * d)


class _CLIPAttention(nn.Module):
    """``nn.MultiheadAttention``'s parameters (packed ``in_proj``)."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)
        nn.init.normal_(self.in_proj_weight, std=width**-0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        out = F.scaled_dot_product_attention(_heads(q, self.heads), _heads(k, self.heads),
                                             _heads(v, self.heads))
        return self.out_proj(_merge(out))


class _MLP(nn.Module):
    def __init__(self, width: int, mult: int = 4):
        super().__init__()
        self.c_fc = nn.Linear(width, mult * width)
        self.c_proj = nn.Linear(mult * width, width)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class _CLIPBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = _CLIPAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = _MLP(width)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, n_blocks: int):
        super().__init__()
        self.resblocks = nn.ModuleList([_CLIPBlock(width, heads) for _ in range(n_blocks)])


class CLIPViT(nn.Module):
    """open_clip ``VisionTransformer``: [B, 3, S, S] normalised images ->
    ``"penultimate"``: [B, 1 + P, width] tokens entering the last block;
    ``"tokens"``: [B, 1 + P, width] after every block and ``ln_post``;
    ``"pooled"``: [B, output_dim], the class token after ``ln_post`` @
    ``proj``."""

    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 features: str = "penultimate"):
        super().__init__()
        if features not in ("penultimate", "tokens", "pooled"):
            raise ValueError(f"unknown features mode {features!r}")
        self.cfg, self.features = cfg, features
        c = cfg
        n_tok = 1 + (c.image_size // c.patch_size) ** 2
        self.conv1 = nn.Conv2d(3, c.width, c.patch_size, stride=c.patch_size, bias=False)
        self.class_embedding = nn.Parameter(0.02 * torch.randn(c.width))
        self.positional_embedding = nn.Parameter(0.02 * torch.randn(n_tok, c.width))
        self.ln_pre = nn.LayerNorm(c.width, eps=1e-5)
        n_blocks = c.layers - 1 if features == "penultimate" else c.layers
        self.transformer = _Transformer(c.width, c.heads, n_blocks)
        if features != "penultimate":
            self.ln_post = nn.LayerNorm(c.width, eps=1e-5)
        if features == "pooled":
            self.proj = nn.Parameter(0.02 * torch.randn(c.width, c.output_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(x).flatten(2).transpose(1, 2)  # row-major patches
        cls = self.class_embedding.to(h.dtype).expand(h.shape[0], 1, -1)
        h = torch.cat([cls, h], dim=1) + self.positional_embedding.to(h.dtype)
        h = self.ln_pre(h)
        for block in self.transformer.resblocks:
            h = block(h)
        if self.features == "penultimate":
            return h
        h = self.ln_post(h)
        if self.features == "tokens":
            return h
        return h[:, 0] @ self.proj


class _PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int, heads: int):
        super().__init__()
        inner = dim_head * heads
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, 2 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        # x: [B, T_img, D] image tokens; latents: [B, Q, D] queries.
        x = self.norm1(x)
        latents = self.norm2(latents)
        q = self.to_q(latents)
        k, v = self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, dim=-1)
        out = F.scaled_dot_product_attention(_heads(q, self.heads), _heads(k, self.heads),
                                             _heads(v, self.heads))
        return self.to_out(_merge(out))


class Resampler(nn.Module):
    """[B, T, embedding_dim] CLIP tokens -> [B, num_queries, output_dim]."""

    def __init__(self, cfg: ResamplerConfig = ResamplerConfig()):
        super().__init__()
        c = self.cfg = cfg
        self.latents = nn.Parameter(torch.randn(1, c.num_queries, c.dim) / math.sqrt(c.dim))
        self.proj_in = nn.Linear(c.embedding_dim, c.dim)
        self.proj_out = nn.Linear(c.dim, c.output_dim)
        self.norm_out = nn.LayerNorm(c.output_dim, eps=1e-5)
        self.layers = nn.ModuleList([
            nn.ModuleList([
                _PerceiverAttention(c.dim, c.dim_head, c.heads),
                nn.Sequential(nn.LayerNorm(c.dim, eps=1e-5),
                              nn.Linear(c.dim, c.ff_mult * c.dim, bias=False), nn.GELU(),
                              nn.Linear(c.ff_mult * c.dim, c.dim, bias=False)),
            ]) for _ in range(c.depth)
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lat = self.latents.to(x.dtype).expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for attn, ff in self.layers:
            lat = lat + attn(x, lat)
            lat = lat + ff(lat)
        return self.norm_out(self.proj_out(lat))


def resize_and_crop(ref_rgb: torch.Tensor, size: int) -> torch.Tensor:
    """open_clip's preprocess on [H, W, 3] in [0, 1] -> [1, 3, size, size]:
    the shorter side to ``size`` (Python ``round`` of the other), bicubic
    with antialiasing (Keys' a = -0.5, as ``jax.image.resize(method=
    "cubic")``), then the centre crop at ``((n - size) // 2)``."""
    H, W = int(ref_rgb.shape[0]), int(ref_rgb.shape[1])
    scale = size / min(H, W)
    nh, nw = round(H * scale), round(W * scale)
    x = ref_rgb.to(torch.float32).permute(2, 0, 1)[None]
    if (nh, nw) != (H, W):
        x = F.interpolate(x, size=(nh, nw), mode="bicubic", align_corners=False,
                          antialias=True)
    y0, x0 = (nh - size) // 2, (nw - size) // 2
    return x[..., y0:y0 + size, x0:x0 + size]


def make_image_embed_fn(clip: CLIPViT, resampler: Resampler) -> Callable:
    """``fn(ref_rgb [H, W, 3] in [0, 1]) -> [num_queries, output_dim]`` ip
    tokens, float32, without gradient: :func:`resize_and_crop`, the CLIP
    channel normalisation (float32), then the tower and the Resampler in
    their parameters' dtype."""
    size = clip.cfg.image_size

    @torch.no_grad()
    def fn(ref_rgb: torch.Tensor) -> torch.Tensor:
        x = resize_and_crop(ref_rgb, size)
        mean = torch.tensor(CLIP_MEAN, device=x.device)[:, None, None]
        std = torch.tensor(CLIP_STD, device=x.device)[:, None, None]
        x = ((x - mean) / std).to(clip.conv1.weight.dtype)
        return resampler(clip(x))[0].to(torch.float32)

    return fn
