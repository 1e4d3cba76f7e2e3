"""Monocular-video avatar dataset (port of ``soar_tpu.data.dataset``):
:class:`AvatarDataset` with ``gt_c2w`` / ``frame_fovs``, the every-5th
split, the mask-bbox crop, the capture loaders (:func:`load_sequence`, the
few-shot :func:`load_fs_sequence` with its :func:`circle_poses` rig, the
``params.pth`` readers) and the self-contained synthetic sequence.

On-disk layout of a capture (``<seq>/``):
  images/*.png  masks/*.png  normal_F/*.png (RGBA)  normal_B/*.png
  smplx/params.pth  (betas, body_pose, global_orient, transl, hand/face
  poses, expression, Ks, w2c, img_wh, normal_Ks)

PNGs are read with :func:`soar_tpu_torch.io.png.read_png`, which returns
RGB(A) where the JAX package's OpenCV reads return BGR(A): the loaders take
the same bytes (a 3-channel mask's first OpenCV channel is its blue one).
"""

from __future__ import annotations

import dataclasses
import os
from glob import glob
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..io.png import read_png


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


def _load_params_pth(path: str) -> Dict[str, np.ndarray]:
    """A preprocessing-written ``params.pth`` as numpy arrays.  The file may
    hold numpy arrays and lists (``img_wh``), so it is read with
    ``weights_only=False``: load only captures you trust."""
    data = torch.load(path, map_location="cpu", weights_only=False)
    out = {}
    for k, v in data.items():
        if hasattr(v, "numpy"):
            out[k] = v.detach().cpu().numpy()
        else:
            out[k] = np.asarray(v)
    return out


def load_insav_smpl_params(seq_dir: str) -> Dict[str, np.ndarray]:
    """The ``insav_wild`` (GaussianAvatar-style) body parameters:
    ``<seq>/train/smpl_parms.pth`` (or ``<seq>/smpl_parms.pth``) with
    ``beta`` [1, 10], ``body_pose`` [F, 72] (axis-angle, global orient in
    the first 3) and ``trans`` [F, 3], remapped to the canonical param dict
    (``global_orient`` split out, ``body_pose`` the remaining 69)."""
    path = os.path.join(seq_dir, "train", "smpl_parms.pth")
    if not os.path.exists(path):
        path = os.path.join(seq_dir, "smpl_parms.pth")
    data = _load_params_pth(path)
    full_pose = np.asarray(data["body_pose"], np.float32)
    if full_pose.shape[-1] != 72:
        raise ValueError(
            f"insav_wild body_pose must be [F, 72] (SMPL-24), got {full_pose.shape}"
        )
    betas = np.asarray(data["beta"], np.float32).reshape(1, -1)[:, :10]
    return {
        "betas": betas,
        "global_orient": full_pose[:, :3],
        "body_pose": full_pose[:, 3:],
        "transl": np.asarray(data["trans"], np.float32),
    }


def _mask_channel(m: np.ndarray) -> np.ndarray:
    """A mask PNG's mask: the image itself, or for a colour mask the
    channel OpenCV returns first (blue, the last of RGB)."""
    return m[..., 2] if m.ndim == 3 else m


def load_sequence(dataroot: str) -> AvatarDataset:
    """Load a capture (layout in the module docstring): images masked and
    scaled to [0, 1], masks from the images' alpha or ``masks/``, the
    normal maps with their alpha as ``normal_mask``, the parameters with
    the rows 1:3 of ``w2c`` flipped, and the 512² mask-bbox crops."""
    img_list = sorted(glob(os.path.join(dataroot, "images", "*.png")))
    mask_list = sorted(glob(os.path.join(dataroot, "masks", "*.png")))
    nf_list = sorted(glob(os.path.join(dataroot, "normal_F", "*.png")))
    nb_list = sorted(glob(os.path.join(dataroot, "normal_B", "*.png")))
    if not img_list:
        raise FileNotFoundError(f"no images under {dataroot}/images")

    imgs, masks = [], []
    nfs, nbs, nms = [], [], []
    for i, p in enumerate(img_list):
        img = read_png(p)
        if img.ndim != 3:
            raise ValueError(f"{p}: a capture image must be RGB or RGBA")
        if img.shape[-1] == 4:
            mask = img[..., 3]
            img = img[..., :3]
        else:
            mask = _mask_channel(read_png(mask_list[i]))
        mask = (mask > 0).astype(np.float32)
        img = img.astype(np.float32) / 255.0
        imgs.append(img * mask[..., None])
        masks.append(mask)
        if nf_list:
            nf = read_png(nf_list[i])
            nms.append(nf[..., 3].astype(np.float32) / 255.0)
            nfs.append(nf[..., :3].astype(np.float32) / 255.0)
            nbs.append(read_png(nb_list[i])[..., :3].astype(np.float32) / 255.0)

    images = np.stack(imgs)
    masks_arr = np.stack(masks)

    params = _load_params_pth(os.path.join(dataroot, "smplx", "params.pth"))
    w2c = np.asarray(params.pop("w2c"), np.float32)
    Ks = np.asarray(params.pop("Ks"), np.float32)
    normal_Ks = np.asarray(params.pop("normal_Ks"), np.float32)
    params.pop("img_wh", None)
    # Axis-angle poses stored per joint [F, J, 3] are flattened to [F, J*3].
    for k in ("body_pose", "left_hand_pose", "right_hand_pose"):
        if k in params and params[k].ndim == 3:
            params[k] = params[k].reshape(params[k].shape[0], -1)
    # The reference's dataset flips rows 1:3 of the w2c before inverting it
    # to a c2w; the flip is baked in here once.
    w2c = w2c.copy()
    w2c[1:3] *= -1

    crops_i, crops_m = [], []
    for img, mask in zip(images, masks_arr):
        ci, cm = bbox_crop_512(img, mask)
        crops_i.append(ci)
        crops_m.append(cm)

    train, val, test = split_indices(len(images))
    return AvatarDataset(
        images=images,
        masks=masks_arr,
        normal_F=np.stack(nfs) if nfs else np.zeros((0,)),
        normal_B=np.stack(nbs) if nbs else np.zeros((0,)),
        normal_mask=np.stack(nms) if nms else np.zeros((0,)),
        images_crop=np.stack(crops_i),
        masks_crop=np.stack(crops_m),
        smpl_params={k: np.asarray(v, np.float32) for k, v in params.items()},
        w2c=w2c,
        Ks=Ks,
        normal_Ks=normal_Ks,
        train_idx=train,
        val_idx=val,
        test_idx=test,
    )


def circle_poses(
    radius: np.ndarray, theta_deg: np.ndarray, phi_deg: np.ndarray
) -> np.ndarray:
    """Camera-to-world poses on a sphere: the few-shot dataset's rig,
    reproduced exactly, including its improper frame: ``right = cross(
    forward, up)`` with forward pointing from the origin to the camera is
    the negative of the OpenGL right vector, so every frame has det = -1 (a
    world x-mirror).  The few-shot GT images follow this convention."""
    th = np.deg2rad(theta_deg)
    ph = np.deg2rad(phi_deg)
    pos = np.stack(
        [
            radius * np.sin(th) * np.sin(ph),
            radius * np.cos(th),
            radius * np.sin(th) * np.cos(ph),
        ],
        -1,
    )
    c2ws = []
    for p in pos:
        forward = p / np.linalg.norm(p)  # c2w z column (the camera looks down -z)
        up = np.array([0.0, 1.0, 0.0])
        right = np.cross(forward, up)  # the reference's order: improper
        right = right / max(np.linalg.norm(right), 1e-8)
        up2 = np.cross(right, forward)
        up2 = up2 / max(np.linalg.norm(up2), 1e-8)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.stack([right, up2, forward], -1)
        c2w[:3, 3] = p
        c2ws.append(c2w)
    return np.stack(c2ws)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[H, W] or [H, W, C] float32 -> ``size`` (H', W'), bilinear on the
    half-pixel grid with edge clamping and no antialiasing: PyTorch's
    ``F.interpolate(mode="bilinear", align_corners=False)``, which samples
    where OpenCV's ``INTER_LINEAR`` does."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
    y = torch.nn.functional.interpolate(x, size=tuple(size), mode="bilinear",
                                        align_corners=False, antialias=False)[0]
    return (y[0] if img.ndim == 2 else y.permute(1, 2, 0)).numpy()


def load_fs_sequence(
    dataroot: str,
    radius: float = 3.2,
    theta_deg: float = 90.0,
    fov_deg: float = 20.0,
    train_views: Tuple[int, ...] = (0, 4),
) -> AvatarDataset:
    """Few-shot synthetic layout: ``basecolor/ mask/ normal/`` directories,
    a fixed :func:`circle_poses` rig (fov 20°, per-view extrinsics at
    negative azimuth steps), world-space normal maps rotated into each
    camera frame and resized to 512², and the fixed 2-view train split."""
    img_list = sorted(glob(os.path.join(dataroot, "basecolor", "*.png")))
    mask_list = sorted(glob(os.path.join(dataroot, "mask", "*.png")))
    normal_list = sorted(glob(os.path.join(dataroot, "normal", "*.png")))
    if not img_list:
        raise FileNotFoundError(f"no images under {dataroot}/basecolor")
    F = len(img_list)

    imgs, masks, normals, nmasks = [], [], [], []
    for i in range(F):
        img = read_png(img_list[i])
        if img.shape[-1] == 4:
            mask = (img[..., 3] > 0).astype(np.float32)
            img = img[..., :3]
        else:
            mask = (_mask_channel(read_png(mask_list[i])) > 0).astype(np.float32)
        imgs.append(img.astype(np.float32) / 255.0 * mask[..., None])
        masks.append(mask)
        nrm = read_png(normal_list[i])
        nmask = nrm[..., 3].astype(np.float32) / 255.0 if nrm.shape[-1] == 4 else mask
        normals.append(nrm[..., :3].astype(np.float32) / 255.0)
        nmasks.append(nmask)

    images = np.stack(imgs)
    H, W = images.shape[1:3]
    # Negative azimuth steps, as the reference's rig (range(0, -360, -45)
    # at F = 8).
    phis = -np.arange(F) / F * 360.0
    c2w = circle_poses(np.full(F, radius), np.full(F, theta_deg), phis)
    w2c = np.linalg.inv(c2w).astype(np.float32)

    focal = H / (2 * np.tan(np.deg2rad(fov_deg) / 2))
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    Ks = np.tile(K[None], (F, 1, 1))
    # Normal supervision renders at 512²; the maps are resized onto that
    # grid and the matching camera is Ks scaled by 512 / H.
    normal_Ks = Ks * (512.0 / H)
    normal_Ks[:, 2, 2] = 1.0

    # World-space normals into each camera frame.
    nfs = []
    for i in range(F):
        nrm = normals[i] * 2.0 - 1.0
        nl = nrm.reshape(-1, 3) @ w2c[i][:3, :3].T
        nl = nl / np.maximum(np.linalg.norm(nl, axis=-1, keepdims=True), 1e-8)
        nl = (nl.reshape(nrm.shape) + 1.0) / 2.0
        nfs.append(nl * nmasks[i][..., None])

    if nfs[0].shape[0] != 512:
        nfs = [resize_bilinear(x, (512, 512)) for x in nfs]
        nmasks = [resize_bilinear(m, (512, 512)) for m in nmasks]

    smpl_path = os.path.join(dataroot, "smplx", "params.pth")
    smpl_params = _load_params_pth(smpl_path) if os.path.exists(smpl_path) else {}
    for k in ("Ks", "w2c", "normal_Ks", "img_wh"):
        smpl_params.pop(k, None)

    crops_i, crops_m = [], []
    for img, mask in zip(images, np.stack(masks)):
        ci, cm = bbox_crop_512(img, mask)
        crops_i.append(ci)
        crops_m.append(cm)

    held = [i for i in range(F) if i not in train_views]
    return AvatarDataset(
        images=images,
        masks=np.stack(masks),
        normal_F=np.stack(nfs),
        # No back normals: an empty array marks them absent.
        normal_B=np.zeros((F, 0, 0, 3), np.float32),
        normal_mask=np.stack(nmasks),
        images_crop=np.stack(crops_i),
        masks_crop=np.stack(crops_m),
        smpl_params={k: np.asarray(v, np.float32) for k, v in smpl_params.items()},
        w2c=w2c,
        Ks=Ks,
        normal_Ks=normal_Ks,
        train_idx=list(train_views),
        val_idx=held[len(held) // 2 :],
        test_idx=held[: len(held) // 2],
    )


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
