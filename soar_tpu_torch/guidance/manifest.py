"""Key manifests of the torch checkpoints the guidance reads (port of
``soar_tpu.guidance.manifest``: the four manifests of the guidance
networks, and SAM's for preprocessing).

Each function transcribes the expected ``{key: shape}`` inventory of one
upstream state_dict from its public construction code, independent of the
modules here:

- :func:`unet_key_manifest`: MVDream / ImageDream ``MultiViewUNetModel``
  (``model.diffusion_model.`` stripped; ImageDream adds ``to_k_ip`` /
  ``to_v_ip`` on every cross-attention and the ``camera_embed`` MLP);
- :func:`vae_encoder_key_manifest`: the LDM ``AutoencoderKL`` encoder and
  ``quant_conv`` (``first_stage_model.`` stripped);
- :func:`clip_vit_h_key_manifest`: open_clip's ViT-H/14 ``VisionTransformer``
  (the ImageDream checkpoint's ``embedder.model.visual.*`` subtree);
- :func:`resampler_key_manifest`: IP-Adapter-plus ``Resampler``
  (``image_proj_model.*``);
- :func:`sam_vit_h_key_manifest`: segment_anything's ``sam_vit_h``
  (:mod:`soar_tpu_torch.preproc.sam`).

The port's modules carry these names, so their ``state_dict()`` equals the
manifests and a checkpoint loads with ``load_state_dict(strict=True)``:
strict loading does the key accounting that the JAX package's converters do
with a tracked dict (the tests assert the equality).
"""

from __future__ import annotations

from typing import Dict, Tuple


# ---------------------------------------------------------------------------
# MVDream / ImageDream MultiViewUNetModel (LDM openaimodel.py)


def unet_key_manifest(
    ipmv: bool = True,
    in_channels: int = 4,
    model_channels: int = 320,
    out_channels: int = 4,
    num_res_blocks: int = 2,
    attention_ds: Tuple[int, ...] = (1, 2, 4),
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4),
    context_dim: int = 1024,
    num_head_channels: int = 64,
    camera_dim: int = 16,
    transformer_depth: int = 1,
) -> Dict[str, Tuple[int, ...]]:
    """``{key: shape}`` of the ``sd-v2.1-base-4view`` UNet state_dict
    (``model.diffusion_model.`` prefix stripped), transcribed from the
    upstream ``MultiViewUNetModel.__init__`` construction order.

    Defaults are the published SD2.1-base-4view config (MVDream
    ``sd-v2-base.yaml``): ``use_linear_in_transformer=True`` (linear
    proj_in/proj_out), one transformer block per attention.  ``ipmv=True``
    adds ImageDream's decoupled image-prompt projections."""
    sd: Dict[str, Tuple[int, ...]] = {}
    ted = 4 * model_channels  # time_embed_dim

    def linear(p, din, dout, bias=True):
        sd[p + ".weight"] = (dout, din)
        if bias:
            sd[p + ".bias"] = (dout,)

    def conv(p, cin, cout, k):
        sd[p + ".weight"] = (cout, cin, k, k)
        sd[p + ".bias"] = (cout,)

    def norm(p, ch):
        sd[p + ".weight"] = (ch,)
        sd[p + ".bias"] = (ch,)

    def resblock(p, cin, cout):
        norm(p + ".in_layers.0", cin)
        conv(p + ".in_layers.2", cin, cout, 3)
        linear(p + ".emb_layers.1", ted, cout)
        norm(p + ".out_layers.0", cout)
        conv(p + ".out_layers.3", cout, cout, 3)
        if cin != cout:
            conv(p + ".skip_connection", cin, cout, 1)

    def transformer(p, ch):
        # SpatialTransformer3D with use_linear_in_transformer=True.
        norm(p + ".norm", ch)
        linear(p + ".proj_in", ch, ch)
        for d in range(transformer_depth):
            tb = f"{p}.transformer_blocks.{d}"
            # attn1: self-attention (context = the tokens themselves).
            linear(tb + ".attn1.to_q", ch, ch, bias=False)
            linear(tb + ".attn1.to_k", ch, ch, bias=False)
            linear(tb + ".attn1.to_v", ch, ch, bias=False)
            linear(tb + ".attn1.to_out.0", ch, ch)
            # attn2: cross-attention on the text context.
            linear(tb + ".attn2.to_q", ch, ch, bias=False)
            linear(tb + ".attn2.to_k", context_dim, ch, bias=False)
            linear(tb + ".attn2.to_v", context_dim, ch, bias=False)
            if ipmv:
                # ImageDream decoupled ip projections (IP-Adapter style).
                linear(tb + ".attn2.to_k_ip", context_dim, ch, bias=False)
                linear(tb + ".attn2.to_v_ip", context_dim, ch, bias=False)
            linear(tb + ".attn2.to_out.0", ch, ch)
            norm(tb + ".norm1", ch)
            norm(tb + ".norm2", ch)
            norm(tb + ".norm3", ch)
            # GEGLU feed-forward: net.0 = GEGLU proj (2x inner), net.2 = out.
            linear(tb + ".ff.net.0.proj", ch, 8 * ch)
            linear(tb + ".ff.net.2", 4 * ch, ch)
        linear(p + ".proj_out", ch, ch)

    linear("time_embed.0", model_channels, ted)
    linear("time_embed.2", ted, ted)
    if camera_dim:
        linear("camera_embed.0", camera_dim, ted)
        linear("camera_embed.2", ted, ted)

    conv("input_blocks.0.0", in_channels, model_channels, 3)
    ch = model_channels
    input_block_chans = [model_channels]
    ds, n = 1, 1
    for level, mult in enumerate(channel_mult):
        for _ in range(num_res_blocks):
            out_ch = mult * model_channels
            resblock(f"input_blocks.{n}.0", ch, out_ch)
            ch = out_ch
            if ds in attention_ds:
                transformer(f"input_blocks.{n}.1", ch)
            input_block_chans.append(ch)
            n += 1
        if level != len(channel_mult) - 1:
            conv(f"input_blocks.{n}.0.op", ch, ch, 3)
            input_block_chans.append(ch)
            ds *= 2
            n += 1

    resblock("middle_block.0", ch, ch)
    transformer("middle_block.1", ch)
    resblock("middle_block.2", ch, ch)

    n = 0
    for level, mult in reversed(list(enumerate(channel_mult))):
        for i in range(num_res_blocks + 1):
            ich = input_block_chans.pop()
            out_ch = model_channels * mult
            resblock(f"output_blocks.{n}.0", ch + ich, out_ch)
            ch = out_ch
            idx = 1
            if ds in attention_ds:
                transformer(f"output_blocks.{n}.1", ch)
                idx = 2
            if level and i == num_res_blocks:
                conv(f"output_blocks.{n}.{idx}.conv", ch, ch, 3)
                ds //= 2
            n += 1

    norm("out.0", ch)
    conv("out.2", ch, out_channels, 3)
    return sd


# ---------------------------------------------------------------------------
# LDM AutoencoderKL encoder (+ quant_conv)


def vae_encoder_key_manifest(
    ch: int = 128,
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4),
    num_res_blocks: int = 2,
    z_channels: int = 4,
    in_channels: int = 3,
) -> Dict[str, Tuple[int, ...]]:
    """``{key: shape}`` of the SD first-stage encoder state_dict
    (``first_stage_model.`` prefix stripped; ``double_z=True`` so conv_out
    emits 2*z channels), transcribed from LDM ``Encoder.__init__``."""
    sd: Dict[str, Tuple[int, ...]] = {}

    def conv(p, cin, cout, k):
        sd[p + ".weight"] = (cout, cin, k, k)
        sd[p + ".bias"] = (cout,)

    def norm(p, c):
        sd[p + ".weight"] = (c,)
        sd[p + ".bias"] = (c,)

    def resblock(p, cin, cout):
        norm(p + ".norm1", cin)
        conv(p + ".conv1", cin, cout, 3)
        norm(p + ".norm2", cout)
        conv(p + ".conv2", cout, cout, 3)
        if cin != cout:
            conv(p + ".nin_shortcut", cin, cout, 1)

    conv("encoder.conv_in", in_channels, ch, 3)
    cur = ch
    for level, mult in enumerate(ch_mult):
        out_ch = ch * mult
        for i in range(num_res_blocks):
            resblock(f"encoder.down.{level}.block.{i}", cur, out_ch)
            cur = out_ch
        if level != len(ch_mult) - 1:
            conv(f"encoder.down.{level}.downsample.conv", cur, cur, 3)
    resblock("encoder.mid.block_1", cur, cur)
    # AttnBlock: 1x1-conv q/k/v/proj_out.
    norm("encoder.mid.attn_1.norm", cur)
    for name in ("q", "k", "v", "proj_out"):
        conv(f"encoder.mid.attn_1.{name}", cur, cur, 1)
    resblock("encoder.mid.block_2", cur, cur)
    norm("encoder.norm_out", cur)
    conv("encoder.conv_out", cur, 2 * z_channels, 3)
    conv("quant_conv", 2 * z_channels, 2 * z_channels, 1)
    return sd


# ---------------------------------------------------------------------------
# open_clip VisionTransformer (ViT-H/14 visual tower)


def clip_vit_h_key_manifest(
    prefix: str = "embedder.model.visual.",
    width: int = 1280,
    layers: int = 32,
    patch_size: int = 14,
    image_size: int = 224,
    mlp_ratio: int = 4,
    output_dim: int = 1024,
) -> Dict[str, Tuple[int, ...]]:
    """``{key: shape}`` of the open_clip ``VisionTransformer`` visual tower
    as embedded in the ImageDream checkpoint (``embedder.model.visual.*``),
    transcribed from ``open_clip/transformer.py``.  ViT-H/14 defaults."""
    sd: Dict[str, Tuple[int, ...]] = {}
    p = prefix
    n_tok = 1 + (image_size // patch_size) ** 2
    sd[p + "class_embedding"] = (width,)
    sd[p + "positional_embedding"] = (n_tok, width)
    sd[p + "conv1.weight"] = (width, 3, patch_size, patch_size)  # bias=False
    sd[p + "ln_pre.weight"] = (width,)
    sd[p + "ln_pre.bias"] = (width,)
    for i in range(layers):
        rb = f"{p}transformer.resblocks.{i}."
        sd[rb + "ln_1.weight"] = (width,)
        sd[rb + "ln_1.bias"] = (width,)
        # torch nn.MultiheadAttention packed projections.
        sd[rb + "attn.in_proj_weight"] = (3 * width, width)
        sd[rb + "attn.in_proj_bias"] = (3 * width,)
        sd[rb + "attn.out_proj.weight"] = (width, width)
        sd[rb + "attn.out_proj.bias"] = (width,)
        sd[rb + "ln_2.weight"] = (width,)
        sd[rb + "ln_2.bias"] = (width,)
        sd[rb + "mlp.c_fc.weight"] = (mlp_ratio * width, width)
        sd[rb + "mlp.c_fc.bias"] = (mlp_ratio * width,)
        sd[rb + "mlp.c_proj.weight"] = (width, mlp_ratio * width)
        sd[rb + "mlp.c_proj.bias"] = (width,)
    sd[p + "ln_post.weight"] = (width,)
    sd[p + "ln_post.bias"] = (width,)
    sd[p + "proj"] = (width, output_dim)  # plain Parameter, no ".weight"
    return sd


# ---------------------------------------------------------------------------
# IP-Adapter-plus Resampler (ImageDream image_proj_model)


def resampler_key_manifest(
    prefix: str = "image_proj_model.",
    dim: int = 1024,
    depth: int = 4,
    dim_head: int = 64,
    heads: int = 12,
    num_queries: int = 16,
    embedding_dim: int = 1280,
    output_dim: int = 1024,
    ff_mult: int = 4,
) -> Dict[str, Tuple[int, ...]]:
    """``{key: shape}`` of the IP-Adapter ``Resampler`` as instantiated by
    ImageDream (``ip_mode="local_resample"``), transcribed from the
    IP-Adapter ``resampler.py``: per layer a PerceiverAttention (norm1/norm2,
    to_q, fused to_kv, to_out — all projections bias-free, inner dim =
    ``heads * dim_head`` = 768) and a LayerNorm+Linear+GELU+Linear
    feed-forward Sequential."""
    sd: Dict[str, Tuple[int, ...]] = {}
    p = prefix
    inner = heads * dim_head
    sd[p + "latents"] = (1, num_queries, dim)
    sd[p + "proj_in.weight"] = (dim, embedding_dim)
    sd[p + "proj_in.bias"] = (dim,)
    sd[p + "proj_out.weight"] = (output_dim, dim)
    sd[p + "proj_out.bias"] = (output_dim,)
    sd[p + "norm_out.weight"] = (output_dim,)
    sd[p + "norm_out.bias"] = (output_dim,)
    for i in range(depth):
        at = f"{p}layers.{i}.0."
        sd[at + "norm1.weight"] = (dim,)
        sd[at + "norm1.bias"] = (dim,)
        sd[at + "norm2.weight"] = (dim,)
        sd[at + "norm2.bias"] = (dim,)
        sd[at + "to_q.weight"] = (inner, dim)
        sd[at + "to_kv.weight"] = (2 * inner, dim)
        sd[at + "to_out.weight"] = (dim, inner)
        # FeedForward: LayerNorm + two bias-FREE Linears (+ GELU at .2).
        ff = f"{p}layers.{i}.1."
        sd[ff + "0.weight"] = (dim,)
        sd[ff + "0.bias"] = (dim,)
        sd[ff + "1.weight"] = (ff_mult * dim, dim)
        sd[ff + "3.weight"] = (dim, ff_mult * dim)
    return sd


# ---------------------------------------------------------------------------
# segment_anything sam_vit_h


def sam_vit_h_key_manifest(
    embed_dim: int = 1280,
    depth: int = 32,
    num_heads: int = 16,
    global_attn_layers: Tuple[int, ...] = (7, 15, 23, 31),
    window_size: int = 14,
    img_size: int = 1024,
    patch_size: int = 16,
    out_chans: int = 256,
    decoder_dim: int = 256,
    decoder_depth: int = 2,
    decoder_mlp_dim: int = 2048,
    num_multimask: int = 3,
) -> Dict[str, Tuple[int, ...]]:
    """``{key: shape}`` of the official ``sam_vit_h`` checkpoint, transcribed
    from segment_anything's ``modeling/`` (ImageEncoderViT + PromptEncoder +
    MaskDecoder/TwoWayTransformer).  Includes the keys the points-only
    predictor deliberately ignores (box corner embeddings, the
    mask-downscaling prompt path) so unconsumed-key accounting can
    distinguish EXPECTED leftovers from dropped weights."""
    sd: Dict[str, Tuple[int, ...]] = {}

    def linear(p, din, dout):
        sd[p + ".weight"] = (dout, din)
        sd[p + ".bias"] = (dout,)

    def norm(p, c):
        sd[p + ".weight"] = (c,)
        sd[p + ".bias"] = (c,)

    # --- image encoder -----------------------------------------------------
    sd["image_encoder.patch_embed.proj.weight"] = (
        embed_dim, 3, patch_size, patch_size,
    )
    sd["image_encoder.patch_embed.proj.bias"] = (embed_dim,)
    grid = img_size // patch_size
    sd["image_encoder.pos_embed"] = (1, grid, grid, embed_dim)
    head_dim = embed_dim // num_heads
    for i in range(depth):
        b = f"image_encoder.blocks.{i}"
        norm(b + ".norm1", embed_dim)
        linear(b + ".attn.qkv", embed_dim, 3 * embed_dim)
        linear(b + ".attn.proj", embed_dim, embed_dim)
        # Decomposed relative positions: window-local blocks span the
        # window, global blocks span the full token grid.
        size = grid if i in global_attn_layers else window_size
        sd[b + ".attn.rel_pos_h"] = (2 * size - 1, head_dim)
        sd[b + ".attn.rel_pos_w"] = (2 * size - 1, head_dim)
        norm(b + ".norm2", embed_dim)
        linear(b + ".mlp.lin1", embed_dim, 4 * embed_dim)
        linear(b + ".mlp.lin2", 4 * embed_dim, embed_dim)
    # Neck convs are bias=False in segment_anything; .1/.3 are LayerNorm2d.
    sd["image_encoder.neck.0.weight"] = (out_chans, embed_dim, 1, 1)
    norm("image_encoder.neck.1", out_chans)
    sd["image_encoder.neck.2.weight"] = (out_chans, out_chans, 3, 3)
    norm("image_encoder.neck.3", out_chans)

    # --- prompt encoder ----------------------------------------------------
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = (
        2, decoder_dim // 2,
    )
    for i in range(4):  # 0=neg point, 1=pos point, 2/3 = box corners
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = (1, decoder_dim)
    sd["prompt_encoder.not_a_point_embed.weight"] = (1, decoder_dim)
    sd["prompt_encoder.no_mask_embed.weight"] = (1, decoder_dim)
    # Mask-prompt downscaling path (unused by the points-only predictor).
    mask_in_chans = 16
    sd["prompt_encoder.mask_downscaling.0.weight"] = (
        mask_in_chans // 4, 1, 2, 2,
    )
    sd["prompt_encoder.mask_downscaling.0.bias"] = (mask_in_chans // 4,)
    norm("prompt_encoder.mask_downscaling.1", mask_in_chans // 4)
    sd["prompt_encoder.mask_downscaling.3.weight"] = (
        mask_in_chans, mask_in_chans // 4, 2, 2,
    )
    sd["prompt_encoder.mask_downscaling.3.bias"] = (mask_in_chans,)
    norm("prompt_encoder.mask_downscaling.4", mask_in_chans)
    sd["prompt_encoder.mask_downscaling.6.weight"] = (
        decoder_dim, mask_in_chans, 1, 1,
    )
    sd["prompt_encoder.mask_downscaling.6.bias"] = (decoder_dim,)

    # --- mask decoder ------------------------------------------------------
    half = decoder_dim // 2  # attention_downsample_rate=2 on cross-attns
    n_tok = num_multimask + 1
    sd["mask_decoder.iou_token.weight"] = (1, decoder_dim)
    sd["mask_decoder.mask_tokens.weight"] = (n_tok, decoder_dim)

    def attn(p, internal):
        linear(p + ".q_proj", decoder_dim, internal)
        linear(p + ".k_proj", decoder_dim, internal)
        linear(p + ".v_proj", decoder_dim, internal)
        linear(p + ".out_proj", internal, decoder_dim)

    for i in range(decoder_depth):
        t = f"mask_decoder.transformer.layers.{i}"
        attn(t + ".self_attn", decoder_dim)
        norm(t + ".norm1", decoder_dim)
        attn(t + ".cross_attn_token_to_image", half)
        norm(t + ".norm2", decoder_dim)
        linear(t + ".mlp.lin1", decoder_dim, decoder_mlp_dim)
        linear(t + ".mlp.lin2", decoder_mlp_dim, decoder_dim)
        norm(t + ".norm3", decoder_dim)
        attn(t + ".cross_attn_image_to_token", half)
        norm(t + ".norm4", decoder_dim)
    attn("mask_decoder.transformer.final_attn_token_to_image", half)
    norm("mask_decoder.transformer.norm_final_attn", decoder_dim)
    # output_upscaling: ConvTranspose2d, LayerNorm2d, GELU, ConvTranspose2d.
    sd["mask_decoder.output_upscaling.0.weight"] = (
        decoder_dim, decoder_dim // 4, 2, 2,
    )
    sd["mask_decoder.output_upscaling.0.bias"] = (decoder_dim // 4,)
    norm("mask_decoder.output_upscaling.1", decoder_dim // 4)
    sd["mask_decoder.output_upscaling.3.weight"] = (
        decoder_dim // 4, decoder_dim // 8, 2, 2,
    )
    sd["mask_decoder.output_upscaling.3.bias"] = (decoder_dim // 8,)
    for i in range(n_tok):
        h = f"mask_decoder.output_hypernetworks_mlps.{i}.layers"
        linear(h + ".0", decoder_dim, decoder_dim)
        linear(h + ".1", decoder_dim, decoder_dim)
        linear(h + ".2", decoder_dim, decoder_dim // 8)
    ih = "mask_decoder.iou_prediction_head.layers"
    linear(ih + ".0", decoder_dim, decoder_dim)
    linear(ih + ".1", decoder_dim, decoder_dim)
    linear(ih + ".2", decoder_dim, n_tok)
    return sd
