"""The avatar of a configuration, built twice from the same inputs: by the
program (``soar_tpu_torch``, the system under test) and by the frozen
reference (``benchmark/reference``).  Each side derives its own state
(template, surfel frames, kNN skin weights, AABB) from the body, the
per-frame SMPL parameters and the seed; the field's weights come from
:mod:`benchmark.scene` on both.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from . import scene


_STAGES: Dict[str, float] = {}
_MARK = [0.0]


def stages_start(t0: float):
    """Starts the record of set-up's stages at ``t0`` (``perf_counter``)."""
    _STAGES.clear()
    _MARK[0] = t0


def stage(name: str, device=None):
    """Ends set-up stage ``name`` (after the device's work when given):
    its seconds since the previous stage ended."""
    if device is not None:
        sync(device)
    now = time.perf_counter()
    _STAGES[name] = _STAGES.get(name, 0.0) + now - _MARK[0]
    _MARK[0] = now


def stages() -> Dict[str, float]:
    return dict(_STAGES)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def empty_cache(device):
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def init_seed(seed: int) -> int:
    """The seed handed to the avatar's and the optimizer's own initialisers
    (numpy's ``RandomState`` takes 32 bits)."""
    return int(seed) % (2**31 - 1)


@dataclasses.dataclass
class Capture:
    """The capture's arrays with the dataset methods the GT batch reads
    (the reference's side; the program gets its own ``AvatarDataset``)."""

    images: np.ndarray
    masks: np.ndarray
    normal_F: np.ndarray
    normal_B: np.ndarray
    normal_mask: np.ndarray
    images_crop: np.ndarray
    masks_crop: np.ndarray
    smpl_params: Dict[str, np.ndarray]
    w2c: np.ndarray
    Ks: np.ndarray
    normal_Ks: np.ndarray

    @property
    def image_size(self):
        return self.images.shape[1], self.images.shape[2]

    def gt_c2w(self, frame_idx: int = 0) -> np.ndarray:
        return np.linalg.inv(self.w2c)

    def frame_fovs(self, idx: int) -> Dict[str, float]:
        H, W = self.image_size
        K, nK = self.Ks[idx], self.normal_Ks[idx]
        nres = self.normal_F.shape[1] if self.normal_F.size else 512
        return {
            "fovx": 2 * np.arctan(W / (2 * K[0, 0])),
            "fovy": 2 * np.arctan(H / (2 * K[1, 1])),
            "cx": K[0, 2],
            "cy": K[1, 2],
            "normal_fovx": 2 * np.arctan(nres / (2 * nK[0, 0])),
            "normal_fovy": 2 * np.arctan(nres / (2 * nK[1, 1])),
            "normal_cx": nK[0, 2],
            "normal_cy": nK[1, 2],
        }


def inputs(cfg: Dict, seed: int, device):
    """(SMPL parameters, capture arrays) of the configuration."""
    b, cap = cfg["body"], cfg["capture"]
    # make_test_body's default betas count; both sides build the same body.
    sp = scene.smpl_params(cap, seed, b["num_joints"], b["num_betas"], device)
    return sp, scene.capture_arrays(cap, seed, device)


def _field_cfg(mod_field, mod_hash, f: Dict):
    grid = mod_hash.HashGridConfig(num_levels=f["num_levels"], min_res=f["min_res"],
                                   max_res=f["max_res"],
                                   log2_hashmap_size=f["log2_hashmap_size"])
    return mod_field.AttributeFieldConfig(grid=grid, hidden_dim=f["hidden_dim"],
                                          num_layers=f["num_layers"])


def program_avatar(cfg: Dict, seed: int, sp, arrays, device):
    """The program's dataset, avatar params and model."""
    from soar_tpu_torch.avatar.state import init_avatar
    from soar_tpu_torch.body.model import make_test_body
    from soar_tpu_torch.data.dataset import AvatarDataset
    from soar_tpu_torch.field import attribute_field, hashgrid

    b = cfg["body"]
    body = make_test_body(num_joints=b["num_joints"], segments_per_bone=b["segments_per_bone"],
                          ring=b["ring"], num_betas=b["num_betas"], device=device)
    F = cfg["capture"]["frames"]
    ds = AvatarDataset(smpl_params=sp, train_idx=list(range(F)), val_idx=[], test_idx=[],
                       **arrays)
    params, model = init_avatar(body, sp, num_subdiv=b["num_subdiv"],
                                field_cfg=_field_cfg(attribute_field, hashgrid, cfg["field"]),
                                seed=init_seed(seed), distill_steps=0, device=device)
    scene.fill_field_(params.field, seed)
    return ds, params, model


def reference_avatar(cfg: Dict, seed: int, sp, arrays, device):
    """The reference's capture, avatar params and model, from the same
    inputs."""
    from .reference.avatar.state import init_avatar
    from .reference.body.model import make_test_body
    from .reference.field import attribute_field, hashgrid

    b = cfg["body"]
    body = make_test_body(num_joints=b["num_joints"], segments_per_bone=b["segments_per_bone"],
                          ring=b["ring"], num_betas=b["num_betas"], device=device)
    ds = Capture(smpl_params=sp, **arrays)
    params, model = init_avatar(body, sp, num_subdiv=b["num_subdiv"],
                                field_cfg=_field_cfg(attribute_field, hashgrid, cfg["field"]),
                                seed=init_seed(seed), distill_steps=0, device=device)
    scene.fill_field_(params.field, seed)
    return ds, params, model
