"""Monocular-video avatar dataset (port of the parts of
``soar_tpu.data.dataset`` the turntable uses): :class:`AvatarDataset` with
``gt_c2w`` / ``frame_fovs``, the every-5th split, the mask-bbox crop, and
the self-contained synthetic sequence.  Loading real captures from disk is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch


def split_indices(n: int) -> Tuple[List[int], List[int], List[int]]:
    """Every-5th-frame (offset length//2) held out; first half of the
    held-out list is test, second half val; the rest train."""
    num_val = max(n // 5, 1)
    length = int(1 / num_val * n) if num_val else n
    length = max(length, 1)
    offset = length // 2
    held = list(range(n))[offset::length]
    train = sorted(set(range(n)) - set(held))
    test = held[: len(held) // 2]
    val = held[len(held) // 2 :]
    return train, val, test


def _bilinear(img: np.ndarray, mx: np.ndarray, my: np.ndarray) -> np.ndarray:
    """Sample img [H, W, C] at float pixel positions (pixel centres on the
    integers), zero outside the image."""
    H, W = img.shape[:2]
    x0 = np.floor(mx).astype(np.int64)
    y0 = np.floor(my).astype(np.int64)
    fx = (mx - x0)[..., None]
    fy = (my - y0)[..., None]
    out = np.zeros(mx.shape + img.shape[2:], np.float32)
    for dy, wy in ((0, 1.0 - fy), (1, fy)):
        for dx, wx in ((0, 1.0 - fx), (1, fx)):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            v = img[np.clip(yi, 0, H - 1), np.clip(xi, 0, W - 1)]
            out += np.where(ok[..., None], v, 0.0) * wx * wy
    return out


def bbox_crop_512(
    img: np.ndarray, mask: np.ndarray, size: int = 512
) -> Tuple[np.ndarray, np.ndarray]:
    """Mask-bbox square crop with 1.1 margin, bilinearly resampled to
    ``size``² on the reference's grid (an endpoint-inclusive linspace over
    the bbox, shifted by -0.5 to integer pixel centres).  Plain numpy: the
    JAX package uses ``cv2.remap``, whose fixed-point weights differ in the
    low bits."""
    ys, xs = np.nonzero(mask)
    if len(xs) == 0:
        return (
            np.zeros((size, size, 3), np.float32),
            np.zeros((size, size), np.float32),
        )
    x0, x1 = xs.min(), xs.max()
    y0, y1 = ys.min(), ys.max()
    cx, cy = (x0 + x1) / 2.0, (y0 + y1) / 2.0
    s = max(x1 - x0, y1 - y0) * 1.1
    gx = np.linspace(cx - s / 2.0, cx + s / 2.0, size, dtype=np.float32) - 0.5
    gy = np.linspace(cy - s / 2.0, cy + s / 2.0, size, dtype=np.float32) - 0.5
    mx, my = np.meshgrid(gx, gy)
    crop = _bilinear(img.astype(np.float32), mx, my)
    mcrop = _bilinear(mask.astype(np.float32)[..., None], mx, my)[..., 0]
    return crop, mcrop


@dataclasses.dataclass
class AvatarDataset:
    """All-in-RAM sequence data (numpy)."""

    images: np.ndarray  # [F, H, W, 3] float32 in [0,1], premultiplied by mask
    masks: np.ndarray  # [F, H, W]
    normal_F: np.ndarray  # [F, 512, 512, 3] or empty
    normal_B: np.ndarray  # [F, 512, 512, 3] or empty
    normal_mask: np.ndarray  # [F, 512, 512] or empty
    images_crop: np.ndarray  # [F, 512, 512, 3]
    masks_crop: np.ndarray  # [F, 512, 512]
    smpl_params: Dict[str, np.ndarray]  # per-frame pose params (+betas)
    w2c: np.ndarray  # [4, 4] (already y/z-row flipped) or [F, 4, 4]
    Ks: np.ndarray  # [F, 3, 3]
    normal_Ks: np.ndarray  # [F, 3, 3]
    train_idx: List[int]
    val_idx: List[int]
    test_idx: List[int]

    @property
    def num_frames(self) -> int:
        return len(self.images)

    @property
    def image_size(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]

    def gt_c2w(self, frame_idx: int = 0) -> np.ndarray:
        """c2w for a frame: one shared extrinsic ([4,4] w2c) or per-view
        ([F,4,4])."""
        w2c = self.w2c if self.w2c.ndim == 2 else self.w2c[frame_idx]
        return np.linalg.inv(w2c)

    def frame_fovs(self, idx: int) -> Dict[str, float]:
        H, W = self.image_size
        K = self.Ks[idx]
        nK = self.normal_Ks[idx]
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


def make_synthetic_sequence(
    num_frames: int = 6,
    image_size: Tuple[int, int] = (96, 96),
    seed: int = 0,
    device="cuda",
):
    """Self-contained synthetic sequence rendered from the procedural test
    body with a known surfel coloring.  Returns ``(ds, (params, model))``
    with the avatar on ``device``."""
    from ..avatar.renderer import RenderSettings, render_view
    from ..avatar.state import init_avatar
    from ..body.model import make_test_body
    from ..core.camera import camera_from_c2w
    from ..field.attribute_field import AttributeFieldConfig
    from ..field.hashgrid import HashGridConfig
    from ..render.types import RasterConfig

    rng = np.random.RandomState(seed)
    body = make_test_body(num_joints=4, segments_per_bone=3, ring=8, device=device)
    dev = body.v_template.device
    F = num_frames
    smpl_params = {
        "betas": np.zeros((1, body.num_betas), np.float32),
        "body_pose": (rng.randn(F, (body.num_joints - 1) * 3) * 0.08).astype(
            np.float32
        ),
        "global_orient": (rng.randn(F, 3) * 0.05).astype(np.float32),
        # Negative z: the identity-extrinsic camera looks down -z.
        "transl": np.tile([[0.0, 0.2, -1.8]], (F, 1)).astype(np.float32),
    }
    field_cfg = AttributeFieldConfig(
        grid=HashGridConfig(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=12),
        hidden_dim=16,
    )
    params, model = init_avatar(
        body, smpl_params, num_subdiv=1, field_cfg=field_cfg, distill_steps=0,
        device=dev,
    )
    # Ground-truth coloring: position-dependent colors.
    xyz = params.xyz.detach().cpu().numpy()
    gt_colors = (np.tanh(xyz * 3.0) + 1.0) / 2.0
    with torch.no_grad():
        params.colors.copy_(torch.from_numpy(
            np.log(gt_colors / (1 - gt_colors + 1e-6) + 1e-6)
        ))

    w2c = np.eye(4, dtype=np.float32)
    H, W = image_size
    focal = 1.2 * max(H, W)
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    Ks = np.tile(K[None], (F, 1, 1))

    settings = RenderSettings(
        use_explicit=True, raster=RasterConfig(max_per_tile=64, dup_side=3)
    )
    fovx = 2 * np.arctan(W / (2 * focal))
    fovy = 2 * np.arctan(H / (2 * focal))
    c2w = torch.from_numpy(np.linalg.inv(w2c)).to(dev)
    cam = camera_from_c2w(
        c2w, fovx, fovy, prcppoint=torch.tensor([0.5, 0.5], device=dev)
    )

    imgs, msks = [], []
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        for f in range(F):
            out = render_view(params, model, cam, (H, W), bg, f, settings)
            imgs.append(out["render"].cpu().numpy())
            msks.append((out["mask"].cpu().numpy() > 0.5).astype(np.float32))
    images = np.stack(imgs)
    masks = np.stack(msks)
    images = images * masks[..., None]

    crops_i, crops_m = [], []
    for img, mask in zip(images, masks):
        ci, cm = bbox_crop_512(img, mask, size=64)
        crops_i.append(ci)
        crops_m.append(cm)

    train, val, test = split_indices(F)
    ds = AvatarDataset(
        images=images,
        masks=masks,
        normal_F=np.zeros((0,)),
        normal_B=np.zeros((0,)),
        normal_mask=np.zeros((0,)),
        images_crop=np.stack(crops_i),
        masks_crop=np.stack(crops_m),
        smpl_params=smpl_params,
        w2c=w2c,
        Ks=Ks,
        normal_Ks=Ks.copy(),
        train_idx=train,
        val_idx=val,
        test_idx=test,
    )
    return ds, (params, model)
