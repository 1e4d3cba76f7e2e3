"""A cell's inputs, made from its seed: the capture (per-frame SMPL
parameters, GT images, cameras) and every weight (the attribute field, the
guidance networks, LPIPS).  The same seed gives the same inputs, to the
program and to the reference alike.

Weights are drawn on the device with ``torch.Generator``s seeded from the
run's seed and a tag, in groups of leaves (one draw a group of up to
``CHUNK`` values), in the type they are served in, and written into the
leaves in a fixed order (a module's ``named_parameters`` order): two
modules with the same layout get the same values.
"""

from __future__ import annotations

import math
import os
import pickle
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

TAGS = {"pose": 1, "capture": 2, "field": 3, "unet": 4, "vae": 5, "clip": 6,
        "resampler": 7, "text": 8, "lpips": 9, "feed": 10, "frames": 11, "sample": 12}
CHUNK = 1 << 26


def sub_seed(seed: int, tag: str) -> int:
    """A generator seed for one kind of input; seeds beyond 32 bits are fine."""
    return (int(seed) * 1_000_003 + TAGS[tag]) % (2**63 - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# ------------------------------------------------------------------ capture


def smpl_params(cap: Dict, seed: int, num_joints: int, num_betas: int, device) -> Dict:
    """Per-frame body parameters: the pose drawn N(0, pose_std^2) per joint
    angle, no global rotation, the capture's translation, zero betas."""
    F = cap["frames"]
    g = generator(seed, "pose", device)
    pose = torch.randn((F, (num_joints - 1) * 3), generator=g, device=device) * cap["pose_std"]
    return {
        "betas": np.zeros((1, num_betas), np.float32),
        "body_pose": pose.cpu().numpy().astype(np.float32),
        "global_orient": np.zeros((F, 3), np.float32),
        "transl": np.tile(np.asarray(cap["transl"], np.float32)[None], (F, 1)),
    }


def capture_arrays(cap: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """The dataset's arrays: with ``gt_images`` every frame's RGB, mask,
    normal maps and crops, uniform noise drawn on the device (masks and
    normal masks binary); without, one blank frame that only sets the image
    size.  Pinhole intrinsics of focal ``focal`` at the image centre and an
    identity extrinsic for every frame."""
    F, H = cap["frames"], cap["size"]
    f32 = np.float32
    out = {}
    if cap["gt_images"]:
        g = generator(seed, "capture", device)

        def rand(*shape):
            return torch.rand(shape, generator=g, device=device)

        out["images"] = rand(F, H, H, 3)
        out["masks"] = (rand(F, H, H) > 0.5).float()
        out["normal_F"] = rand(F, H, H, 3)
        out["normal_B"] = rand(F, H, H, 3)
        out["normal_mask"] = (rand(F, H, H) > 0.5).float()
        out["images_crop"] = rand(F, H, H, 3)
        out["masks_crop"] = (rand(F, H, H) > 0.5).float()
        out = {k: v.cpu().numpy() for k, v in out.items()}
    else:
        out["images"] = np.zeros((1, H, H, 3), f32)
        out["masks"] = np.zeros((1, H, H), f32)
        for k in ("normal_F", "normal_B", "normal_mask", "images_crop", "masks_crop"):
            out[k] = np.zeros((0,), f32)
    K = np.array([[cap["focal"], 0, H / 2], [0, cap["focal"], H / 2], [0, 0, 1]], f32)
    out["Ks"] = np.tile(K[None], (F, 1, 1))
    out["normal_Ks"] = out["Ks"].copy()
    out["w2c"] = np.eye(4, dtype=f32)
    return out


# ------------------------------------------------------------------ weights


def layout(module: torch.nn.Module) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in the order the draws follow."""
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


def _network_rule(name: str, p: torch.Tensor):
    """The random-init heuristic of the guidance networks: biases 0, 1-D
    weights (norm scales) 1, every other leaf N(0, 0.2^2 / fan_in), fan_in
    its size when it is 1-D.  Returns ("const", v) or ("normal", std)."""
    if name.endswith("bias"):
        return "const", 0.0
    if p.ndim == 1 and name.endswith("weight"):
        return "const", 1.0
    fan_in = math.prod(p.shape[1:]) if p.ndim > 1 else p.numel()
    return "normal", 0.2 / max(fan_in, 1) ** 0.5


def _lpips_rule(name: str, p: torch.Tensor):
    """LPIPS-VGG16: He-normal convolution kernels, zero biases, ``lin``
    weights U(0, 1)."""
    if name.startswith("lin"):
        return "unit_uniform", None
    if name.endswith("bias"):
        return "const", 0.0
    return "normal", (2.0 / (9 * p.shape[1])) ** 0.5


@torch.no_grad()
def fill_(named, rule, seed: int, tag: str, draw_dtype: torch.dtype):
    """Writes seeded values into every leaf of ``named`` ((name, tensor)
    pairs, in order): the leaves that need draws are taken in order in
    groups of up to ``CHUNK`` values, one draw a group in ``draw_dtype``,
    scaled in that type and copied into the leaf (whatever its dtype)."""
    named = list(named)
    dev = named[0][1].device
    g = generator(seed, tag, dev)
    todo = []
    for name, p in named:
        kind, arg = rule(name, p)
        if kind == "const":
            p.fill_(arg)
        else:
            todo.append((p, kind, arg))
    i = 0
    while i < len(todo):
        j, total = i, 0
        while j < len(todo) and (j == i or total + todo[j][0].numel() <= CHUNK):
            total += todo[j][0].numel()
            j += 1
        normal = torch.empty(total, dtype=draw_dtype, device=dev).normal_(generator=g)
        uniform = torch.empty(total, dtype=draw_dtype, device=dev).uniform_(generator=g)
        off = 0
        for p, kind, arg in todo[i:j]:
            n = p.numel()
            if kind == "normal":
                x = normal[off:off + n] * arg
            elif kind == "uniform":
                x = (2.0 * uniform[off:off + n] - 1.0) * arg
            else:
                x = uniform[off:off + n]
            p.copy_(x.view(p.shape))
            off += n
        i = j


def fill_network_(module, seed: int, tag: str, draw_dtype=torch.bfloat16):
    fill_(module.named_parameters(), _network_rule, seed, tag, draw_dtype)


def fill_field_(field, seed: int):
    """The attribute field's tables and heads (float32 draws)."""
    s = field.cfg.grid.init_scale

    def rule(name, p):
        if name in ("encoding", "quat_encoding"):
            return "uniform", s
        head, idx, leaf = name.split(".")
        if head == "mlp_offsets" and int(idx) == len(getattr(field, head)) - 1:
            return "const", 0.0
        fan_in = getattr(field, head)[int(idx)].weight.shape[1]
        return "uniform", 1.0 / fan_in ** 0.5

    fill_(field.named_parameters(), rule, seed, "field", torch.float32)


# LPIPS-VGG16's leaves in its module's ``named_parameters`` order: the five
# ``lin`` weights, then the 13 convolutions (torchvision's ``features``
# index, in, out channels).
VGG16_CONVS = ((0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128), (10, 128, 256),
               (12, 256, 256), (14, 256, 256), (17, 256, 512), (19, 512, 512), (21, 512, 512),
               (24, 512, 512), (26, 512, 512), (28, 512, 512))
LPIPS_LIN = (64, 128, 256, 512, 512)


def lpips_layout() -> List[Tuple[str, Tuple[int, ...]]]:
    out = [(f"lin{i}", (c,)) for i, c in enumerate(LPIPS_LIN)]
    for i, cin, cout in VGG16_CONVS:
        out += [(f"vgg.features.{i}.weight", (cout, cin, 3, 3)),
                (f"vgg.features.{i}.bias", (cout,))]
    return out


def lpips_state(seed: int, device, draw_dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """LPIPS's weights as a float32 state dict on ``device`` (bf16 draws):
    the program reads them through the CLI's pickle
    (:func:`write_lpips_pickle`), the reference loads them into its
    module."""
    named = [(n, torch.empty(shape, device=device)) for n, shape in lpips_layout()]
    fill_(named, _lpips_rule, seed, "lpips", draw_dtype)
    return dict(named)


def text_embeddings(seed: int, context_dim: int, device) -> torch.Tensor:
    """The mock (cond, uncond) text embeddings [2, 77, D]."""
    return torch.randn((2, 77, context_dim), generator=generator(seed, "text", device),
                       device=device)


def write_lpips_pickle(state: Dict[str, torch.Tensor]) -> str:
    """The LPIPS weights ``state`` (:func:`lpips_state`) as the training
    CLI's ``--lpips-weights`` pickle (flax variables: HWIO kernels, numpy
    leaves), in a new file under the temporary directory, whose path is
    returned; the caller removes it."""
    sd = {k: v.detach().float().cpu() for k, v in state.items()}
    vgg = {}
    for i, (layer, _, _) in enumerate(VGG16_CONVS):
        w = sd[f"vgg.features.{layer}.weight"]
        vgg[f"conv_{i}"] = {"kernel": w.permute(2, 3, 1, 0).numpy(),
                            "bias": sd[f"vgg.features.{layer}.bias"].numpy()}
    params = {"vgg": vgg}
    for i in range(len(LPIPS_LIN)):
        params[f"lin_{i}"] = sd[f"lin{i}"].numpy()
    fd, path = tempfile.mkstemp(suffix=".pkl", dir=tempfile.gettempdir())
    with os.fdopen(fd, "wb") as f:
        pickle.dump({"params": params}, f)
    return path
