"""Segment Anything (SAM): ViT image encoder, prompt encoder and two-way
mask decoder (port of ``soar_tpu.preproc.sam``).

The architecture of the published model: decomposed relative-position
attention in the ViT (windowed 14x14, the 64x64 token grid padded to 70,
except the global blocks 7, 15, 23, 31), Fourier point encodings with
per-label embeddings, the ``no_mask`` dense embedding, a depth-2 two-way
transformer with rate-2 downsampled cross attention, 3-layer hypernetwork
MLPs per mask token and an IoU head.  Module names are
``segment_anything``'s, so the ``state_dict()`` keys of :class:`SAM` at
full shape equal :func:`soar_tpu_torch.guidance.manifest.
sam_vit_h_key_manifest` (the box-corner point embeddings and the
mask-prompt path included, unused by the points-only predictor) and the
official ``sam_vit_h_4b8939.pth`` loads with ``load_state_dict(strict=True)``.

The decoder's LayerNorms use eps 1e-6 like the JAX package (flax's
default).  Attention runs through ``F.scaled_dot_product_attention``, the
image encoder's with the relative-position bias as its float mask.

:func:`load_sam_predictor` reproduces ``SamPredictor.predict`` with keypoint
prompts in float32: longest side resized to 1024, mean/std normalisation,
multimask output, the union of the three masks thresholded at 0.  Each of
its three resizes is bilinear and antialiased when it shrinks, as
``jax.image.resize`` is.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 1280  # ViT-H
    depth: int = 32
    num_heads: int = 16
    global_attn_layers: Tuple[int, ...] = (7, 15, 23, 31)
    window_size: int = 14
    out_chans: int = 256
    decoder_dim: int = 256
    decoder_depth: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask: int = 3


# ---------------------------------------------------------------------------
# image encoder (ImageEncoderViT)


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Relative position embeddings per pairwise offset [q, k, d]; resized
    linearly when the table was trained at another size."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos.T[None], size=max_rel_dist, mode="linear")[0].T
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class LayerNorm2d(nn.Module):
    """Channel LayerNorm of an NCHW tensor (segment_anything ``common.py``)."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


class _ViTAttention(nn.Module):
    """Multi-head attention with decomposed relative positions over a
    [B, H, W, C] token grid of side ``size``."""

    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        head_dim = dim // heads
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, head_dim))

    def forward(self, x):
        B, H, W, C = x.shape
        hd = C // self.heads
        qkv = self.qkv(x).reshape(B, H * W, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.heads, H * W, hd).unbind(0)
        Rh = _get_rel_pos(H, H, self.rel_pos_h)  # [H, H, d]
        Rw = _get_rel_pos(W, W, self.rel_pos_w)
        r_q = q.reshape(B * self.heads, H, W, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
        bias = (rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).reshape(
            B * self.heads, H * W, H * W)
        x = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        x = x.reshape(B, self.heads, H, W, hd).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj(x)


class _MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=nn.GELU):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act()

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class _ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, grid: int):
        super().__init__()
        self.window = window  # 0 = global attention
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _ViTAttention(dim, heads, window if window > 0 else grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _MLPBlock(dim, 4 * dim)

    def forward(self, x):  # [B, H, W, C]
        B, H, W, C = x.shape
        shortcut = x
        x = self.norm1(x)
        w = self.window
        if w > 0:
            pad_h, pad_w = (-H) % w, (-W) % w
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
            nh, nw = (H + pad_h) // w, (W + pad_w) // w
            x = x.reshape(B, nh, w, nw, w, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, w, w, C)
        x = self.attn(x)
        if w > 0:
            x = x.reshape(B, nh, nw, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(
                B, nh * w, nw * w, C)[:, :H, :W]
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):  # [B, 3, S, S] -> [B, S/p, S/p, C]
        return self.proj(x).permute(0, 2, 3, 1)


class SAMImageEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        c = cfg
        grid = c.img_size // c.patch_size
        self.patch_embed = _PatchEmbed(c.patch_size, c.embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, c.embed_dim))
        self.blocks = nn.ModuleList([
            _ViTBlock(c.embed_dim, c.num_heads,
                      0 if i in c.global_attn_layers else c.window_size, grid)
            for i in range(c.depth)])
        self.neck = nn.Sequential(
            nn.Conv2d(c.embed_dim, c.out_chans, 1, bias=False), LayerNorm2d(c.out_chans),
            nn.Conv2d(c.out_chans, c.out_chans, 3, padding=1, bias=False),
            LayerNorm2d(c.out_chans))

    def forward(self, x):  # [B, 3, 1024, 1024] normalized -> [B, 256, 64, 64]
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder (points only: the predictor prompts with keypoints)


class _PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, num_pos_feats))

    def forward_with_coords(self, coords01: torch.Tensor) -> torch.Tensor:
        coords = 2.0 * coords01 - 1.0
        proj = (2.0 * math.pi) * (coords @ self.positional_encoding_gaussian_matrix)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def grid(self, side: int) -> torch.Tensor:
        """The encoding of the grid cell centres [side, side, C]."""
        dev = self.positional_encoding_gaussian_matrix.device
        c = (torch.arange(side, dtype=torch.float32, device=dev) + 0.5) / side
        grid = torch.stack([c[None, :].expand(side, side), c[:, None].expand(side, side)], -1)
        return self.forward_with_coords(grid)


class SAMPromptEncoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        C = cfg.decoder_dim
        self.grid_side = cfg.img_size // cfg.patch_size
        self.pe_layer = _PositionEmbeddingRandom(C // 2)
        # 0 = negative point, 1 = positive point, 2/3 = box corners (unused).
        self.point_embeddings = nn.ModuleList([nn.Embedding(1, C) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, C)
        mask_in = 16  # the mask-prompt path (unused by the predictor)
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, mask_in // 4, 2, stride=2), LayerNorm2d(mask_in // 4), nn.GELU(),
            nn.Conv2d(mask_in // 4, mask_in, 2, stride=2), LayerNorm2d(mask_in), nn.GELU(),
            nn.Conv2d(mask_in, C, 1))
        self.no_mask_embed = nn.Embedding(1, C)

    def forward(self, points01, labels, grid_side: Optional[int] = None):
        """points01 [B, P, 2] (x, y) in [0, 1]; labels [B, P] (1 fg, 0 bg,
        -1 pad).  Returns (sparse [B, P, C], dense_no_mask [C],
        image_pe [side, side, C])."""
        emb = self.pe_layer.forward_with_coords(points01)
        lab = labels[..., None]
        emb = torch.where(lab == -1, torch.zeros_like(emb), emb)
        fg = self.point_embeddings[1].weight[0]
        bg = self.point_embeddings[0].weight[0]
        pad = self.not_a_point_embed.weight[0]
        type_emb = torch.where(lab == 1, fg, torch.where(lab == 0, bg, pad))
        side = grid_side or self.grid_side
        return emb + type_emb, self.no_mask_embed.weight[0], self.pe_layer.grid(side)


# ---------------------------------------------------------------------------
# mask decoder (TwoWayTransformer + upscaling + hypernetworks)


class _DecoderAttention(nn.Module):
    """Attention with an optional internal downsampling of the width."""

    def __init__(self, dim: int, heads: int, downsample: int = 1):
        super().__init__()
        inner = dim // downsample
        self.heads = heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, q, k, v):
        B = q.shape[0]

        def split(x):
            return x.reshape(B, x.shape[1], self.heads, -1).transpose(1, 2)

        out = F.scaled_dot_product_attention(split(self.q_proj(q)), split(self.k_proj(k)),
                                             split(self.v_proj(v)))
        return self.out_proj(out.transpose(1, 2).reshape(B, q.shape[1], -1))


class _TwoWayBlock(nn.Module):
    def __init__(self, cfg: SAMConfig, skip_first_layer_pe: bool):
        super().__init__()
        C, h = cfg.decoder_dim, cfg.decoder_heads
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = _DecoderAttention(C, h)
        self.norm1 = nn.LayerNorm(C, eps=1e-6)
        self.cross_attn_token_to_image = _DecoderAttention(C, h, 2)
        self.norm2 = nn.LayerNorm(C, eps=1e-6)
        self.mlp = _MLPBlock(C, cfg.decoder_mlp_dim, act=nn.ReLU)
        self.norm3 = nn.LayerNorm(C, eps=1e-6)
        self.cross_attn_image_to_token = _DecoderAttention(C, h, 2)
        self.norm4 = nn.LayerNorm(C, eps=1e-6)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class _TwoWayTransformer(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        C = cfg.decoder_dim
        self.layers = nn.ModuleList([_TwoWayBlock(cfg, i == 0) for i in range(cfg.decoder_depth)])
        self.final_attn_token_to_image = _DecoderAttention(C, cfg.decoder_heads, 2)
        self.norm_final_attn = nn.LayerNorm(C, eps=1e-6)

    def forward(self, src, pos_src, tokens):
        queries, keys = tokens, src
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, pos_src)
        q, k = queries + tokens, keys + pos_src
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class _MLP(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        dims = [dim] + [hidden] * (layers - 1)
        self.layers = nn.ModuleList([nn.Linear(a, b) for a, b in zip(dims, dims[1:] + [out])])

    def forward(self, x):
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class SAMMaskDecoder(nn.Module):
    def __init__(self, cfg: SAMConfig):
        super().__init__()
        C, M = cfg.decoder_dim, cfg.num_multimask + 1
        self.num_mask_tokens = M
        self.transformer = _TwoWayTransformer(cfg)
        self.iou_token = nn.Embedding(1, C)
        self.mask_tokens = nn.Embedding(M, C)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(C, C // 4, 2, stride=2), LayerNorm2d(C // 4), nn.GELU(),
            nn.ConvTranspose2d(C // 4, C // 8, 2, stride=2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList([_MLP(C, C, C // 8) for _ in range(M)])
        self.iou_prediction_head = _MLP(C, C, M)

    def forward(self, image_emb, image_pe, sparse_emb, dense_emb):
        """image_emb [B, C, h, w], image_pe [h, w, C], sparse_emb [B, P, C],
        dense_emb [C] -> (masks [B, M, 4h, 4w], iou [B, M])."""
        B, C, h, w = image_emb.shape
        M = self.num_mask_tokens
        tokens = torch.cat([self.iou_token.weight[None].expand(B, -1, -1),
                            self.mask_tokens.weight[None].expand(B, -1, -1), sparse_emb], dim=1)
        src = (image_emb + dense_emb[:, None, None]).flatten(2).transpose(1, 2)
        pos_src = image_pe.reshape(1, h * w, C).expand(B, -1, -1)
        queries, keys = self.transformer(src, pos_src, tokens)
        up = self.output_upscaling(keys.transpose(1, 2).reshape(B, C, h, w))
        hyper = torch.stack([mlp(queries[:, 1 + i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], dim=1)  # [B, M, C/8]
        masks = torch.einsum("bmc,bchw->bmhw", hyper, up)
        return masks, self.iou_prediction_head(queries[:, 0])


class SAM(nn.Module):
    def __init__(self, cfg: SAMConfig = SAMConfig()):
        super().__init__()
        self.cfg = cfg
        self.image_encoder = SAMImageEncoder(cfg)
        self.prompt_encoder = SAMPromptEncoder(cfg)
        self.mask_decoder = SAMMaskDecoder(cfg)

    def forward(self, image, points, labels):
        """image [B, 3, S, S] normalized; points [B, P, 2] in [0, 1]; labels
        [B, P].  Returns (masks [B, M, S/4, S/4], iou [B, M])."""
        emb = self.image_encoder(image)
        sparse, no_mask, image_pe = self.prompt_encoder(points, labels, grid_side=emb.shape[-1])
        return self.mask_decoder(emb, image_pe, sparse, no_mask)


# ---------------------------------------------------------------------------
# predictor (SamPredictor.predict with keypoint prompts)

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of [N, C, H, W], antialiased when it shrinks (as
    ``jax.image.resize``)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


class SamPredictor:
    """``predict(img_rgb_u8 [H, W, 3], points_px [P, 2]) -> bool mask
    [H, W]``: the union of the three multimask outputs, prompted by the
    points as foreground.  ``sam`` is the float32 model on the device."""

    def __init__(self, sam: SAM):
        self.sam = sam
        self.device = next(sam.parameters()).device
        f32 = dict(dtype=torch.float32, device=self.device)
        self.mean = torch.tensor(PIXEL_MEAN, **f32)[:, None, None]
        self.std = torch.tensor(PIXEL_STD, **f32)[:, None, None]

    @torch.no_grad()
    def __call__(self, img_u8: np.ndarray, points_px: np.ndarray) -> np.ndarray:
        S = self.sam.cfg.img_size
        H, W = img_u8.shape[:2]
        scale = S / max(H, W)
        nh, nw = int(round(H * scale)), int(round(W * scale))
        img = torch.from_numpy(np.ascontiguousarray(img_u8)).to(self.device)
        img = _resize(img.permute(2, 0, 1)[None].float(), (nh, nw))[0]
        img = F.pad((img - self.mean) / self.std, (0, S - nw, 0, S - nh))

        # The resize transform first, then SAM's +0.5 pixel-centre shift.
        pts = np.asarray(points_px, np.float32).reshape(-1, 2) * scale + 0.5
        pts01 = np.concatenate([pts / S, np.zeros((1, 2), np.float32)], axis=0)
        labels = np.concatenate([np.ones(len(pts), np.float32), -np.ones(1, np.float32)])
        masks, _ = self.sam(img[None], torch.from_numpy(pts01).to(self.device)[None],
                            torch.from_numpy(labels).to(self.device)[None])
        low = masks[:, 1:]  # [1, 3, S/4, S/4]: the multimask tokens
        full = _resize(low, (S, S))[..., :nh, :nw]
        full = _resize(full, (H, W))[0]
        return (full > 0.0).any(dim=0).cpu().numpy()


def load_sam_predictor(checkpoint_path: Optional[str], cfg: SAMConfig = SAMConfig(),
                       device="cuda") -> SamPredictor:
    """The predictor from the official ``sam_vit_h_4b8939.pth`` (or any
    state_dict in its layout, e.g. a Lightning file's ``state_dict``), cast
    to float32 and loaded strictly."""
    if not checkpoint_path:
        raise SystemExit("SAM backend needs --sam-checkpoint-path (sam_vit_h_4b8939.pth, "
                         "user-downloaded)")
    dev = resolve_device(device)
    sd = torch.load(checkpoint_path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    with torch.device("meta"):
        sam = SAM(cfg)
    sam.load_state_dict({k: v.float() for k, v in sd.items()}, strict=True, assign=True)
    return SamPredictor(sam.to(dev).eval())
