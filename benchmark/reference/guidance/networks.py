"""Diffusion networks: the multi-view SD2.1 UNet and the SD VAE encoder
(port of ``soar_tpu.guidance.networks``), as NCHW ``nn.Module``s.

- :class:`MultiViewUNet`: Stable Diffusion 2.1-base (320 base channels,
  channel_mult (1, 2, 4, 4), 2 res blocks, spatial transformers with
  context width 1024, linear projections, 64-wide heads) extended the
  MVDream / ImageDream way: a camera-matrix embedding added to the time
  embedding, self-attention joined across the ``num_frames`` views, and,
  with ``ip_dim``, ImageDream's decoupled image-prompt projections on every
  cross-attention.
- :class:`VAEEncoder`: the SD AutoencoderKL encoder, sampling the posterior
  and applying the 0.18215 latent scale.

Submodules carry the LDM names, so ``state_dict()`` keys are the keys of
the torch checkpoints (``input_blocks.1.0.in_layers.0.weight``,
``encoder.down.0.block.0.norm1.weight``, ...) and a checkpoint loads with
``load_state_dict(strict=True)``.

Group counts are ``gcd(32, ch)`` (tiny test configs have fewer groups);
GroupNorm eps is 1e-5 in the UNet's res blocks and 1e-6 in the VAE, the
spatial transformers' input norm and both output norms; LayerNorm eps 1e-5.
Attention, convolutions and norms are PyTorch's own calls: the JAX package
computes them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    model_channels: int = 320
    out_channels: int = 4
    num_res_blocks: int = 2
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    attention_levels: Tuple[int, ...] = (0, 1, 2)
    num_head_channels: int = 64
    context_dim: int = 1024
    camera_dim: int = 16


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    base_channels: int = 128
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    latent_channels: int = 4
    scale_factor: float = 0.18215


def timestep_embedding(t: torch.Tensor, dim: int, max_period: int = 10000) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _gn(ch: int, eps: float = 1e-5) -> nn.GroupNorm:
    return nn.GroupNorm(math.gcd(32, ch), ch, eps=eps)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> [B, H*W, C], row-major pixels (the JAX package's NHWC order)."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


def _untokens(h: torch.Tensor, H: int, W: int) -> torch.Tensor:
    B, _, C = h.shape
    return h.reshape(B, H, W, C).permute(0, 3, 1, 2)


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, emb_dim: int):
        super().__init__()
        self.in_layers = nn.Sequential(_gn(cin), nn.SiLU(), nn.Conv2d(cin, cout, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_dim, cout))
        self.out_layers = nn.Sequential(_gn(cout), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(cout, cout, 3, padding=1))
        self.skip_connection = nn.Conv2d(cin, cout, 1) if cin != cout else nn.Identity()

    def forward(self, x, emb):
        h = self.in_layers(x)
        h = h + self.emb_layers(emb)[:, :, None, None]
        return self.skip_connection(x) + self.out_layers(h)


class Attention(nn.Module):
    """Cross / self attention with ImageDream's optional decoupled
    image-prompt branch (IP-Adapter style): ip tokens get their own
    ``to_k_ip`` / ``to_v_ip`` projections and a second softmax whose output
    is added with ``ip_weight``, not one softmax over text and ip tokens."""

    def __init__(self, query_dim: int, context_dim: int, heads: int, dim_head: int,
                 ip: bool = False, ip_weight: float = 1.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.ip_weight = heads, dim_head, ip_weight
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        if ip:
            self.to_k_ip = nn.Linear(context_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(nn.Linear(inner, query_dim), nn.Identity())

    def _attend(self, q, k, v):
        B, T, _ = q.shape

        def split(x):
            return x.reshape(x.shape[0], x.shape[1], self.heads, self.dim_head).transpose(1, 2)

        out = F.scaled_dot_product_attention(split(q), split(k), split(v))
        return out.transpose(1, 2).reshape(B, T, self.heads * self.dim_head)

    def forward(self, x, context=None, ip=None):
        context = x if context is None else context
        q = self.to_q(x)
        out = self._attend(q, self.to_k(context), self.to_v(context))
        if ip is not None:
            out = out + self.ip_weight * self._attend(q, self.to_k_ip(ip), self.to_v_ip(ip))
        return self.to_out(out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim, dim_out * 2)

    def forward(self, x):
        a, b = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(b)  # exact erf gelu, as LDM's GEGLU


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int, ip: bool):
        super().__init__()
        self.attn1 = Attention(dim, dim, heads, dim_head)
        self.attn2 = Attention(dim, context_dim, heads, dim_head, ip=ip)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = nn.Module()
        self.ff.net = nn.Sequential(GEGLU(dim, dim * 4), nn.Identity(), nn.Linear(dim * 4, dim))

    def forward(self, x, context, num_frames: int, ip=None):
        # Multi-view joint self-attention (MVDream's "3D attention"): the
        # view axis folds into the token axis, cond views in the first
        # group and uncond views in the second.
        B, T, C = x.shape
        xs = x.reshape(B // num_frames, num_frames * T, C) if num_frames > 1 else x
        x = x + self.attn1(self.norm1(xs)).reshape(B, T, C)
        x = x + self.attn2(self.norm2(x), context, ip=ip)
        return x + self.ff.net(self.norm3(x))


class SpatialTransformer(nn.Module):
    def __init__(self, ch: int, context_dim: int, heads: int, dim_head: int, ip: bool):
        super().__init__()
        self.norm = _gn(ch, eps=1e-6)
        self.proj_in = nn.Linear(ch, ch)  # use_linear_in_transformer
        self.transformer_blocks = nn.ModuleList(
            [TransformerBlock(ch, context_dim, heads, dim_head, ip)])
        self.proj_out = nn.Linear(ch, ch)

    def forward(self, x, context, num_frames: int, ip=None):
        H, W = x.shape[-2:]
        h = self.proj_in(_tokens(self.norm(x)))
        h = self.transformer_blocks[0](h, context, num_frames, ip=ip)
        return x + _untokens(self.proj_out(h), H, W)


class _Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = nn.Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class _Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class MultiViewUNet(nn.Module):
    """The ImageDream / MVDream 4-view UNet.  ``ip_dim`` > 0 adds the
    decoupled image-prompt projections (the ``-ipmv`` checkpoint) and, when
    it differs from ``context_dim``, an ``ip_proj`` to the context width."""

    def __init__(self, cfg: UNetConfig = UNetConfig(), ip_dim: int = 0):
        super().__init__()
        self.cfg = cfg
        ch0 = cfg.model_channels
        ted = ch0 * 4
        ip = ip_dim > 0
        self.time_embed = nn.Sequential(nn.Linear(ch0, ted), nn.SiLU(), nn.Linear(ted, ted))
        if cfg.camera_dim:
            self.camera_embed = nn.Sequential(nn.Linear(cfg.camera_dim, ted), nn.SiLU(),
                                              nn.Linear(ted, ted))
        if ip and ip_dim != cfg.context_dim:
            self.ip_proj = nn.Linear(ip_dim, cfg.context_dim)

        def heads_for(ch):
            return max(ch // cfg.num_head_channels, 1)

        def res_attn(cin, cout, level):
            mods = [ResBlock(cin, cout, ted)]
            if level in cfg.attention_levels:
                mods.append(SpatialTransformer(cout, cfg.context_dim, heads_for(cout),
                                               cfg.num_head_channels, ip))
            return mods

        self.input_blocks = nn.ModuleList(
            [nn.ModuleList([nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)])])
        chans = [ch0]
        ch = ch0
        n_levels = len(cfg.channel_mult)
        for level, mult in enumerate(cfg.channel_mult):
            for _ in range(cfg.num_res_blocks):
                self.input_blocks.append(nn.ModuleList(res_attn(ch, ch0 * mult, level)))
                ch = ch0 * mult
                chans.append(ch)
            if level != n_levels - 1:
                self.input_blocks.append(nn.ModuleList([_Downsample(ch)]))
                chans.append(ch)
        self.middle_block = nn.ModuleList([
            ResBlock(ch, ch, ted),
            SpatialTransformer(ch, cfg.context_dim, heads_for(ch), cfg.num_head_channels, ip),
            ResBlock(ch, ch, ted),
        ])
        self.output_blocks = nn.ModuleList()
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            for i in range(cfg.num_res_blocks + 1):
                mods = res_attn(ch + chans.pop(), ch0 * mult, level)
                ch = ch0 * mult
                if level != 0 and i == cfg.num_res_blocks:
                    mods.append(_Upsample(ch))
                self.output_blocks.append(nn.ModuleList(mods))
        self.out = nn.Sequential(nn.GroupNorm(min(32, ch), ch, eps=1e-6), nn.SiLU(),
                                 nn.Conv2d(ch, cfg.out_channels, 3, padding=1))

    @staticmethod
    def _run(mods, h, emb, ctx, num_frames, ip):
        for m in mods:
            if isinstance(m, ResBlock):
                h = m(h, emb)
            elif isinstance(m, SpatialTransformer):
                h = m(h, ctx, num_frames, ip=ip)
            else:
                h = m(h)
        return h

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: Dict) -> torch.Tensor:
        """``x`` [B, 4, h, w] noisy latents (B = 2 x views for CFG), ``t``
        [B]; ``context``: ``context`` [B, 77, D], ``camera`` [B, 16],
        ``num_frames`` (an int), optional ``ip`` [B, T_ip, D_ip]."""
        num_frames = context.get("num_frames", 1)
        dt = x.dtype
        emb = self.time_embed(timestep_embedding(t, self.cfg.model_channels).to(dt))
        if "camera" in context:
            emb = emb + self.camera_embed(context["camera"])
        ctx = context["context"]
        # Image-prompt tokens ride to every cross-attention's decoupled
        # branch (ImageDream concatenates them into the context and splits
        # them again inside each attention: the same computation).
        ip = context.get("ip")
        if ip is not None and hasattr(self, "ip_proj"):
            ip = self.ip_proj(ip)

        hs = []
        h = x
        for mods in self.input_blocks:
            h = self._run(mods, h, emb, ctx, num_frames, ip)
            hs.append(h)
        h = self._run(self.middle_block, h, emb, ctx, num_frames, ip)
        for mods in self.output_blocks:
            h = self._run(mods, torch.cat([h, hs.pop()], dim=1), emb, ctx, num_frames, ip)
        return self.out(h)


class _VAEResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.norm1 = _gn(cin, eps=1e-6)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.norm2 = _gn(cout, eps=1e-6)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = nn.Conv2d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class _VAEAttn(nn.Module):
    """LDM's AttnBlock: one head over all pixels, 1x1-conv projections."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _gn(ch, eps=1e-6)
        self.q = nn.Conv2d(ch, ch, 1)
        self.k = nn.Conv2d(ch, ch, 1)
        self.v = nn.Conv2d(ch, ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x):
        H, W = x.shape[-2:]
        h = self.norm(x)
        q, k, v = (_tokens(m(h))[:, None] for m in (self.q, self.k, self.v))
        out = F.scaled_dot_product_attention(q, k, v)[:, 0]
        return x + self.proj_out(_untokens(out, H, W))


class _VAEDownsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        # LDM's Downsample: pad right and bottom by one, then a VALID
        # stride-2 conv.
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class VAEEncoder(nn.Module):
    """The SD AutoencoderKL encoder and ``quant_conv`` -> sampled, scaled
    latents.  Under ``encoder``: ``conv_in``, ``down.L.block.I`` and
    ``down.L.downsample``, ``mid.block_1`` / ``attn_1`` / ``block_2``,
    ``norm_out`` and ``conv_out``, as in LDM."""

    def __init__(self, cfg: VAEConfig = VAEConfig()):
        super().__init__()
        self.cfg = cfg
        base, mults = cfg.base_channels, cfg.channel_mult
        enc = nn.Module()
        enc.conv_in = nn.Conv2d(3, base, 3, padding=1)
        enc.down = nn.ModuleList()
        ch = base
        for level, mult in enumerate(mults):
            lv = nn.Module()
            lv.block = nn.ModuleList()
            for _ in range(2):
                lv.block.append(_VAEResBlock(ch, base * mult))
                ch = base * mult
            if level != len(mults) - 1:
                lv.downsample = _VAEDownsample(ch)
            enc.down.append(lv)
        enc.mid = nn.Module()
        enc.mid.block_1 = _VAEResBlock(ch, ch)
        enc.mid.attn_1 = _VAEAttn(ch)
        enc.mid.block_2 = _VAEResBlock(ch, ch)
        enc.norm_out = nn.GroupNorm(min(32, ch), ch, eps=1e-6)
        enc.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)
        self.encoder = enc
        self.quant_conv = nn.Conv2d(2 * cfg.latent_channels, 2 * cfg.latent_channels, 1)

    def forward(self, images01: torch.Tensor, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``images01`` [B, 3, H, W] in [0, 1]; ``eps`` [B, 4, h, w], the
        posterior's standard-normal sample (None: the posterior mean)."""
        enc = self.encoder
        h = enc.conv_in(images01 * 2.0 - 1.0)
        for lv in enc.down:
            for blk in lv.block:
                h = blk(h)
            if hasattr(lv, "downsample"):
                h = lv.downsample(h)
        h = enc.mid.block_2(enc.mid.attn_1(enc.mid.block_1(h)))
        moments = self.quant_conv(enc.conv_out(F.silu(enc.norm_out(h))))
        mean, logvar = moments.chunk(2, dim=1)
        if eps is not None:
            mean = mean + torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0)) * eps
        return mean * self.cfg.scale_factor
