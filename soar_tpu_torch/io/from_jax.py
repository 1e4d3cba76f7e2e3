"""Carry a ``soar_tpu`` avatar, and its guidance networks, across to this
package.

Inputs are the JAX pytrees flattened by the caller into nested dicts of
numpy arrays (``np.asarray`` on every leaf); nothing here imports JAX.

- ``body``: the ``BodyModel`` fields (``v_template``, ``shapedirs``,
  ``posedirs``, ``J_regressor``, ``lbs_weights``, ``parents``, ``faces``,
  ``num_betas``, optional ``pose_mean`` and the optional SMPL-X landmark
  tables ``extra_joint_idxs``, ``lmk_faces_idx``, ``lmk_bary_coords``,
  ``dyn_lmk_faces_idx``, ``dyn_lmk_bary_coords``).
- ``params``: the ``AvatarParams`` fields; ``params["field"]`` holds
  ``aabb``, both hash tables (``encoding``, ``quat_encoding``) and the five
  ``mlp_*`` heads as lists of ``{"w", "b"}`` layers.  JAX's ``w`` is
  [in, out]; ``nn.Linear.weight`` is [out, in], so it is transposed here.
- ``model``: ``skin`` (``inv_mats``, ``cano_vertices``, ``point_weights``),
  ``smpl_params``, ``aabb``, ``original_pos``, ``num_frames``, ``body``
  and ``field_cfg`` (``dataclasses.asdict`` of the JAX config).
- the training state's background MLP (``bg_params``);
- the densification state (:func:`densify_state_from_numpy`), whose
  padded parameters come across as ``params`` do;
- the guidance networks' flax variables (:func:`unet_from_flax`,
  :func:`vae_from_flax`, :func:`clip_vit_from_flax`,
  :func:`resampler_from_flax`) and text embeddings;
- LPIPS-VGG16's flax variables (:func:`lpips_from_flax`), as the JAX
  CLI's ``--lpips-weights`` pickle holds them;
- the preprocessing networks' flax variables: SAM (:func:`sam_from_flax`)
  and ECON's NormalNet (:func:`normalnet_from_flax`).

Carrying ``model.skin`` and the field keeps every random or tie-sensitive
init step (the field's ``jax.random`` tables, the kNN neighbour sets) out
of the comparison, so both packages compute the same function.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..avatar.state import AvatarModel, AvatarParams
from ..body.model import BodyModel
from ..body.skinning import SkinningData
from ..field.attribute_field import AttributeField, AttributeFieldConfig
from ..field.hashgrid import HashGridConfig

_HEADS = ("mlp_shs", "mlp_scales", "mlp_quats", "mlp_offsets", "mlp_opacities")


def _t(a, dev) -> torch.Tensor:
    t = torch.as_tensor(np.array(a)).to(dev)
    return t.float() if t.is_floating_point() else t.long()


def field_config_from_dict(d: Dict) -> AttributeFieldConfig:
    d = dict(d)
    return AttributeFieldConfig(grid=HashGridConfig(**d.pop("grid")), **d)


_BODY_OPTIONAL = ("pose_mean", "extra_joint_idxs", "lmk_faces_idx", "lmk_bary_coords",
                  "dyn_lmk_faces_idx", "dyn_lmk_bary_coords")


def body_from_numpy(body: Dict, device="cuda") -> BodyModel:
    dev = resolve_device(device)
    optional = {k: None if body.get(k) is None else _t(body[k], dev) for k in _BODY_OPTIONAL}
    return BodyModel(
        v_template=_t(body["v_template"], dev),
        shapedirs=_t(body["shapedirs"], dev),
        posedirs=_t(body["posedirs"], dev),
        J_regressor=_t(body["J_regressor"], dev),
        lbs_weights=_t(body["lbs_weights"], dev),
        parents=tuple(int(p) for p in body["parents"]),
        faces=_t(body["faces"], dev),
        num_betas=int(body["num_betas"]),
        **optional,
    )


def avatar_from_numpy(
    params: Dict, model: Dict, device="cuda"
) -> Tuple[AvatarParams, AvatarModel]:
    dev = resolve_device(device)
    cfg = field_config_from_dict(model["field_cfg"])
    f = params["field"]
    field = AttributeField(_t(f["aabb"], dev), cfg)
    with torch.no_grad():
        field.encoding.copy_(_t(f["encoding"], dev))
        field.quat_encoding.copy_(_t(f["quat_encoding"], dev))
        for head in _HEADS:
            for lin, layer in zip(getattr(field, head), f[head]):
                lin.weight.copy_(_t(layer["w"], dev).T)
                lin.bias.copy_(_t(layer["b"], dev))

    av = AvatarParams(
        xyz=_t(params["xyz"], dev),
        rotation=_t(params["rotation"], dev),
        scaling=_t(params["scaling"], dev),
        opacity=_t(params["opacity"], dev),
        colors=_t(params["colors"], dev),
        occ=_t(params["occ"], dev),
        field=field,
        latent_pose=_t(params["latent_pose"], dev),
    )
    sk = model["skin"]
    am = AvatarModel(
        body=body_from_numpy(model["body"], dev),
        skin=SkinningData(
            inv_mats=_t(sk["inv_mats"], dev),
            cano_vertices=_t(sk["cano_vertices"], dev),
            point_weights=_t(sk["point_weights"], dev),
        ),
        smpl_params={k: _t(v, dev) for k, v in model["smpl_params"].items()},
        aabb=_t(model["aabb"], dev),
        original_pos=_t(model["original_pos"], dev),
        num_frames=int(model["num_frames"]),
        field_cfg=cfg,
    )
    return av, am


def densify_state_from_numpy(state: Dict, device="cuda"):
    """The JAX package's ``DensifyState`` (``alive`` bool, the three
    accumulators and ``denom``, as numpy) as the port's."""
    from ..avatar.densify import DensifyState

    dev = resolve_device(device)
    return DensifyState(
        alive=torch.as_tensor(np.array(state["alive"], bool)).to(dev),
        **{k: _t(state[k], dev) for k in ("xyz_grad_accum", "scale_grad_accum", "opac_accum",
                                          "denom")},
    )


def background_from_numpy(bg: Dict, device="cuda") -> Dict:
    """The JAX package's background MLP (``{"layers": [{"w": [in, out]}]}``,
    as numpy) in the port's layout, which is the same."""
    dev = resolve_device(device)
    return {"layers": [{k: _t(v, dev) for k, v in layer.items()} for layer in bg["layers"]]}


# ---------------------------------------------------------------- guidance
#
# The guidance networks' flax variables (``{"params": {...}}`` as nested
# dicts of numpy arrays) -> the port's ``state_dict`` (LDM keys): the
# inverse of ``soar_tpu.guidance.networks.convert_unet_torch_params`` /
# ``convert_vae_torch_params`` (and of the CLIP, Resampler and LPIPS
# converters).  Dense kernels [in, out] -> [out, in]; conv
# kernels HWIO -> OIHW; the VAE attention's Dense -> a 1x1 conv; a norm's
# ``scale`` -> ``weight``.  Every flax leaf is used exactly once (checked
# here), and ``load_state_dict(strict=True)`` checks that every parameter of
# the module is filled.


class _Leaves:
    """Flat ``{path: array}`` view of a flax tree that records what is read."""

    def __init__(self, tree: Dict):
        self.left = {}

        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    self.left[path + (k,)] = np.array(v, np.float32)

        walk(tree.get("params", tree), ())

    def has(self, *path) -> bool:
        return any(k[:len(path)] == path for k in self.left)

    def take(self, *path) -> np.ndarray:
        return self.left.pop(path)

    def done(self, what: str):
        if self.left:
            raise ValueError(f"{what}: flax leaves not carried across: "
                             f"{['/'.join(k) for k in sorted(self.left)][:8]}")


class _StateDict(dict):
    def __init__(self, leaves: _Leaves):
        super().__init__()
        self.leaves = leaves

    def dense(self, path, key, bias=True):
        self[key + ".weight"] = torch.as_tensor(self.leaves.take(*path, "kernel").T.copy())
        if bias:
            self[key + ".bias"] = torch.as_tensor(self.leaves.take(*path, "bias"))

    def dense_as_conv1x1(self, path, key):
        self[key + ".weight"] = torch.as_tensor(
            self.leaves.take(*path, "kernel").T.copy()[:, :, None, None])
        self[key + ".bias"] = torch.as_tensor(self.leaves.take(*path, "bias"))

    def conv(self, path, key, bias=True):
        k = self.leaves.take(*path, "kernel")  # HWIO
        self[key + ".weight"] = torch.as_tensor(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        if bias:
            self[key + ".bias"] = torch.as_tensor(self.leaves.take(*path, "bias"))

    def raw(self, path, key, fn=lambda a: a):
        self[key] = torch.as_tensor(np.ascontiguousarray(fn(self.leaves.take(*path))))

    def norm(self, path, key):
        self[key + ".weight"] = torch.as_tensor(self.leaves.take(*path, "scale"))
        self[key + ".bias"] = torch.as_tensor(self.leaves.take(*path, "bias"))

    def conv_transpose(self, path, key):
        """flax ``ConvTranspose`` (HWIO, applied as a correlation) ->
        ``nn.ConvTranspose2d`` ([in, out, kH, kW], a true transposed
        convolution): the spatial flip of ``torch_convert.conv_transpose``
        undone."""
        k = self.leaves.take(*path, "kernel")[::-1, ::-1]
        self[key + ".weight"] = torch.as_tensor(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
        self[key + ".bias"] = torch.as_tensor(self.leaves.take(*path, "bias"))


def unet_from_flax(variables: Dict, cfg) -> Dict[str, torch.Tensor]:
    """``soar_tpu``'s ``MultiViewUNet`` variables -> the port's
    ``MultiViewUNet`` state_dict (CPU tensors); ``cfg`` is the port's
    :class:`soar_tpu_torch.guidance.networks.UNetConfig`."""
    lv = _Leaves(variables)
    sd = _StateDict(lv)

    def resblock(p, key):
        sd.norm((p, "GroupNorm_0"), key + ".in_layers.0")
        sd.conv((p, "Conv_0"), key + ".in_layers.2")
        sd.dense((p, "Dense_0"), key + ".emb_layers.1")
        sd.norm((p, "GroupNorm_1"), key + ".out_layers.0")
        sd.conv((p, "Conv_1"), key + ".out_layers.3")
        if lv.has(p, "Conv_2"):
            sd.conv((p, "Conv_2"), key + ".skip_connection")

    def attention(p, key):
        for name in ("to_q", "to_k", "to_v", "to_k_ip", "to_v_ip"):
            if lv.has(*p, name):
                sd.dense(p + (name,), f"{key}.{name}", bias=False)
        sd.dense(p + ("to_out",), key + ".to_out.0")

    def transformer(p, key):
        tb = key + ".transformer_blocks.0"
        sd.norm((p, "GroupNorm_0"), key + ".norm")
        sd.dense((p, "proj_in"), key + ".proj_in")
        for i in (1, 2, 3):
            sd.norm((p, "block0", f"norm{i}"), f"{tb}.norm{i}")
        attention((p, "block0", "attn1"), tb + ".attn1")
        attention((p, "block0", "attn2"), tb + ".attn2")
        sd.dense((p, "block0", "GEGLU_0", "Dense_0"), tb + ".ff.net.0.proj")
        sd.dense((p, "block0", "Dense_0"), tb + ".ff.net.2")
        sd.dense((p, "proj_out"), key + ".proj_out")

    for name in ("time_embed_0", "time_embed_2", "camera_embed_0", "camera_embed_2"):
        if lv.has(name):
            sd.dense((name,), name[:-2] + "." + name[-1])
    if lv.has("ip_proj"):
        sd.dense(("ip_proj",), "ip_proj")
    sd.conv(("input_conv",), "input_blocks.0.0")
    n = 1
    levels = len(cfg.channel_mult)
    for level in range(levels):
        for i in range(cfg.num_res_blocks):
            resblock(f"down_{level}_{i}_res", f"input_blocks.{n}.0")
            if level in cfg.attention_levels:
                transformer(f"down_{level}_{i}_attn", f"input_blocks.{n}.1")
            n += 1
        if level != levels - 1:
            sd.conv((f"down_{level}_ds",), f"input_blocks.{n}.0.op")
            n += 1
    resblock("mid_res0", "middle_block.0")
    transformer("mid_attn", "middle_block.1")
    resblock("mid_res1", "middle_block.2")
    n = 0
    for level in reversed(range(levels)):
        for i in range(cfg.num_res_blocks + 1):
            resblock(f"up_{level}_{i}_res", f"output_blocks.{n}.0")
            idx = 1
            if level in cfg.attention_levels:
                transformer(f"up_{level}_{i}_attn", f"output_blocks.{n}.1")
                idx = 2
            if level != 0 and i == cfg.num_res_blocks:
                sd.conv((f"up_{level}_us",), f"output_blocks.{n}.{idx}.conv")
            n += 1
    sd.norm(("out_norm",), "out.0")
    sd.conv(("out_conv",), "out.2")
    lv.done("unet_from_flax")
    return dict(sd)


def vae_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``soar_tpu``'s ``VAEEncoder`` variables -> the port's ``VAEEncoder``
    state_dict (CPU tensors, LDM keys)."""
    lv = _Leaves(variables)
    sd = _StateDict(lv)

    def resblock(p, key):
        sd.norm((p, "GroupNorm_0"), key + ".norm1")
        sd.conv((p, "Conv_0"), key + ".conv1")
        sd.norm((p, "GroupNorm_1"), key + ".norm2")
        sd.conv((p, "Conv_1"), key + ".conv2")
        if lv.has(p, "Conv_2"):
            sd.conv((p, "Conv_2"), key + ".nin_shortcut")

    sd.conv(("conv_in",), "encoder.conv_in")
    level = 0
    while lv.has(f"down_{level}_0"):
        for i in range(2):
            resblock(f"down_{level}_{i}", f"encoder.down.{level}.block.{i}")
        if lv.has(f"down_{level}_ds"):
            sd.conv((f"down_{level}_ds",), f"encoder.down.{level}.downsample.conv")
        level += 1
    resblock("mid_res0", "encoder.mid.block_1")
    resblock("mid_res1", "encoder.mid.block_2")
    sd.norm(("mid_attn", "GroupNorm_0"), "encoder.mid.attn_1.norm")
    for i, name in enumerate(("q", "k", "v", "proj_out")):
        sd.dense_as_conv1x1(("mid_attn", f"Dense_{i}"), f"encoder.mid.attn_1.{name}")
    sd.norm(("out_norm",), "encoder.norm_out")
    sd.conv(("conv_out",), "encoder.conv_out")
    sd.conv(("quant_conv",), "quant_conv")
    lv.done("vae_from_flax")
    return dict(sd)


def text_embeddings_from_numpy(emb, device="cuda") -> torch.Tensor:
    """The guidance's text embeddings [2, 77, D] (cond, uncond), float32."""
    return torch.as_tensor(np.asarray(emb, np.float32)).to(resolve_device(device))


def clip_vit_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``soar_tpu``'s ``CLIPViT`` variables -> the port's ``CLIPViT``
    state_dict (open_clip keys without the ``visual.`` prefix).  The tree
    holds the blocks, ``ln_post`` and ``proj`` of the mode it was made in,
    and so does the state_dict."""
    lv = _Leaves(variables)
    sd = _StateDict(lv)
    sd.conv(("conv1",), "conv1", bias=False)
    sd.raw(("class_embedding",), "class_embedding")
    sd.raw(("positional_embedding",), "positional_embedding")
    sd.norm(("ln_pre",), "ln_pre")
    i = 0
    while lv.has(f"resblock_{i}"):
        p, key = f"resblock_{i}", f"transformer.resblocks.{i}"
        sd.norm((p, "ln_1"), key + ".ln_1")
        sd.raw((p, "attn", "in_proj", "kernel"), key + ".attn.in_proj_weight", np.transpose)
        sd.raw((p, "attn", "in_proj", "bias"), key + ".attn.in_proj_bias")
        sd.dense((p, "attn", "out_proj"), key + ".attn.out_proj")
        sd.norm((p, "ln_2"), key + ".ln_2")
        sd.dense((p, "c_fc"), key + ".mlp.c_fc")
        sd.dense((p, "c_proj"), key + ".mlp.c_proj")
        i += 1
    if lv.has("ln_post"):
        sd.norm(("ln_post",), "ln_post")
    if lv.has("proj"):
        sd.raw(("proj",), "proj")  # [width, output_dim] in both
    lv.done("clip_vit_from_flax")
    return dict(sd)


def resampler_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``soar_tpu``'s ``Resampler`` variables -> the port's ``Resampler``
    state_dict (IP-Adapter keys without ``image_proj_model.``)."""
    lv = _Leaves(variables)
    sd = _StateDict(lv)
    sd.raw(("latents",), "latents", lambda a: a[None])  # [Q, D] -> [1, Q, D]
    sd.dense(("proj_in",), "proj_in")
    sd.dense(("proj_out",), "proj_out")
    sd.norm(("norm_out",), "norm_out")
    i = 0
    while lv.has(f"attn_{i}"):
        a, f = f"attn_{i}", f"ff_{i}"
        sd.norm((a, "norm1"), f"layers.{i}.0.norm1")
        sd.norm((a, "norm2"), f"layers.{i}.0.norm2")
        for name in ("to_q", "to_kv", "to_out"):
            sd.dense((a, name), f"layers.{i}.0.{name}", bias=False)
        sd.norm((f, "norm"), f"layers.{i}.1.0")
        sd.dense((f, "fc1"), f"layers.{i}.1.1", bias=False)
        sd.dense((f, "fc2"), f"layers.{i}.1.3", bias=False)
        i += 1
    lv.done("resampler_from_flax")
    return dict(sd)


def lpips_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``soar_tpu``'s ``LPIPS`` variables (``vgg/conv_{i}`` and ``lin_{i}``,
    the pickle that ``soar_tpu.train.lpips.convert_lpips_params`` writes)
    -> the port's :class:`soar_tpu_torch.train.lpips.LPIPS` state_dict."""
    from ..train.lpips import VGG16_CONV_LAYERS

    lv = _Leaves(variables)
    sd = _StateDict(lv)
    for i, layer in enumerate(VGG16_CONV_LAYERS):
        sd.conv(("vgg", f"conv_{i}"), f"vgg.features.{layer}")
    for i in range(5):
        sd.raw((f"lin_{i}",), f"lin{i}")
    lv.done("lpips_from_flax")
    return dict(sd)


def sam_from_flax(variables: Dict, cfg) -> Dict[str, torch.Tensor]:
    """``soar_tpu``'s ``SAM`` variables -> the port's :class:`soar_tpu_torch.
    preproc.sam.SAM` state_dict (segment_anything keys); ``cfg`` is the
    port's ``SAMConfig``.  The flax model has no box-corner point embeddings
    and no mask-prompt path, which the points-only predictor never uses:
    those entries are zeros."""
    from ..guidance.manifest import sam_vit_h_key_manifest

    lv = _Leaves(variables)
    sd = _StateDict(lv)
    e, b = ("image_encoder",), "image_encoder"
    sd.conv(e + ("patch_embed",), b + ".patch_embed.proj")
    sd.raw(e + ("pos_embed",), b + ".pos_embed")
    for i in range(cfg.depth):
        p, k = e + (f"block_{i}",), f"{b}.blocks.{i}"
        sd.norm(p + ("norm1",), k + ".norm1")
        sd.dense(p + ("attn", "qkv"), k + ".attn.qkv")
        sd.dense(p + ("attn", "proj"), k + ".attn.proj")
        sd.raw(p + ("attn", "rel_pos_h"), k + ".attn.rel_pos_h")
        sd.raw(p + ("attn", "rel_pos_w"), k + ".attn.rel_pos_w")
        sd.norm(p + ("norm2",), k + ".norm2")
        sd.dense(p + ("lin1",), k + ".mlp.lin1")
        sd.dense(p + ("lin2",), k + ".mlp.lin2")
    sd.conv(e + ("neck_conv1",), b + ".neck.0", bias=False)
    sd.norm(e + ("neck_ln1",), b + ".neck.1")
    sd.conv(e + ("neck_conv2",), b + ".neck.2", bias=False)
    sd.norm(e + ("neck_ln2",), b + ".neck.3")

    p, b = ("prompt_encoder",), "prompt_encoder"
    sd.raw(p + ("pe_gaussian",), b + ".pe_layer.positional_encoding_gaussian_matrix")
    sd.raw(p + ("bg_embed",), b + ".point_embeddings.0.weight", lambda a: a[None])
    sd.raw(p + ("fg_embed",), b + ".point_embeddings.1.weight", lambda a: a[None])
    sd.raw(p + ("not_a_point_embed",), b + ".not_a_point_embed.weight", lambda a: a[None])
    sd.raw(p + ("no_mask_embed",), b + ".no_mask_embed.weight", lambda a: a[None])

    d, b = ("mask_decoder",), "mask_decoder"

    def attn(path, key):
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.dense(path + (name,), f"{key}.{name}")

    sd.raw(d + ("iou_token",), b + ".iou_token.weight")
    sd.raw(d + ("mask_tokens",), b + ".mask_tokens.weight")
    for i in range(cfg.decoder_depth):
        p, k = d + (f"twoway_{i}",), f"{b}.transformer.layers.{i}"
        attn(p + ("self_attn",), k + ".self_attn")
        attn(p + ("cross_attn_t2i",), k + ".cross_attn_token_to_image")
        attn(p + ("cross_attn_i2t",), k + ".cross_attn_image_to_token")
        for j in range(1, 5):
            sd.norm(p + (f"norm{j}",), f"{k}.norm{j}")
        sd.dense(p + ("mlp_lin1",), k + ".mlp.lin1")
        sd.dense(p + ("mlp_lin2",), k + ".mlp.lin2")
    attn(d + ("final_t2i",), b + ".transformer.final_attn_token_to_image")
    sd.norm(d + ("norm_final",), b + ".transformer.norm_final_attn")
    sd.conv_transpose(d + ("up1",), b + ".output_upscaling.0")
    sd.norm(d + ("up_ln",), b + ".output_upscaling.1")
    sd.conv_transpose(d + ("up2",), b + ".output_upscaling.3")
    for i in range(cfg.num_multimask + 1):
        for j in range(3):
            sd.dense(d + (f"hyper_{i}", f"lin{j}"), f"{b}.output_hypernetworks_mlps.{i}.layers.{j}")
    for j in range(3):
        sd.dense(d + ("iou_head", f"lin{j}"), f"{b}.iou_prediction_head.layers.{j}")
    lv.done("sam_from_flax")

    fields = ("embed_dim", "depth", "num_heads", "global_attn_layers", "window_size", "img_size",
              "patch_size", "out_chans", "decoder_dim", "decoder_depth", "decoder_mlp_dim",
              "num_multimask")
    for k, shape in sam_vit_h_key_manifest(**{f: getattr(cfg, f) for f in fields}).items():
        if k not in sd:  # the unused prompt paths
            sd[k] = torch.zeros(shape)
    return dict(sd)


def normalnet_from_flax(variables: Dict) -> Dict[str, torch.Tensor]:
    """``soar_tpu``'s ``NormalNet`` variables -> the port's
    :class:`soar_tpu_torch.preproc.normal_net.NormalNet` state_dict (ECON's
    ``netF.model.*`` / ``netB.model.*`` keys, the inverse of
    ``soar_tpu.preproc.normal_net.convert_normalnet_params``)."""
    lv = _Leaves(variables)
    sd = _StateDict(lv)
    for net in ("netF", "netB"):
        seq = f"{net}.model"
        n_down = sum(1 for k in lv.left if k[0] == net and k[1].startswith("ConvTranspose_")) // 2
        n_blocks = len({k[1] for k in lv.left if k[0] == net and k[1].startswith("ResnetBlock_")})
        sd.conv((net, "Conv_0"), f"{seq}.1")
        idx = 4
        for i in range(n_down):
            sd.conv((net, f"Conv_{i + 1}"), f"{seq}.{idx}")
            idx += 3
        for blk in range(n_blocks):
            sd.conv((net, f"ResnetBlock_{blk}", "Conv_0"), f"{seq}.{idx}.conv_block.1")
            sd.conv((net, f"ResnetBlock_{blk}", "Conv_1"), f"{seq}.{idx}.conv_block.5")
            idx += 1
        for i in range(n_down):
            sd.conv_transpose((net, f"ConvTranspose_{i}"), f"{seq}.{idx}")
            idx += 3
        sd.conv((net, f"Conv_{n_down + 1}"), f"{seq}.{idx + 1}")
    lv.done("normalnet_from_flax")
    return dict(sd)
