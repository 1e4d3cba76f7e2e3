"""Held-out-frame evaluation and media dumps (port of
``soar_tpu.train.evaluate``).

:func:`evaluate` is the reference's test protocol
(``system/gaussian_surfel_mvdream.py:527-589``): render each held-out
frame with its GT camera, whiten the GT outside the mask, compute PSNR,
skimage's SSIM and, given an ``lpips_fn``, LPIPS; write per-frame pngs and
``psnrs.txt`` / ``ssims.txt`` / ``lpips.txt`` / ``average.txt`` (whose
LPIPS column is nan without LPIPS weights, as in the JAX package).  ``save_png`` writes an 8-bit PNG with ``zlib`` and ``struct``
alone, so the port needs no image library; ``try_save_mp4`` uses OpenCV
when it is installed and reports failure otherwise.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def save_png(path: str, img: np.ndarray) -> None:
    """[H, W], [H, W, 1], [H, W, 3] or [H, W, 4] floats in [0, 1] -> PNG."""
    u8 = _to_u8(np.asarray(img))
    if u8.ndim == 3 and u8.shape[-1] == 1:
        u8 = u8[..., 0]
    if u8.ndim == 2:
        color_type, ch = 0, 1
    elif u8.shape[-1] == 3:
        color_type, ch = 2, 3
    elif u8.shape[-1] == 4:
        color_type, ch = 6, 4
    else:
        raise ValueError(f"save_png: unsupported image shape {u8.shape}")
    H, W = u8.shape[:2]
    rows = u8.reshape(H, W * ch)
    # Filter type 0 (None) on every scanline.
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def try_save_mp4(path: str, frames: List[np.ndarray], fps: int = 30) -> bool:
    """mp4 via cv2 when it is installed; returns success."""
    try:
        import cv2
    except ImportError:
        return False
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        return False
    for f in frames:
        vw.write(_to_u8(f)[..., ::-1])
    vw.release()
    return True


def skimage_ssim(pred: np.ndarray, gt: np.ndarray, win: int = 7) -> float:
    """``skimage.metrics.structural_similarity`` with its defaults, which the
    reference eval calls: 7x7 uniform window, unbiased covariance
    (N / (N - 1)), per-channel maps cropped by the filter radius and
    averaged.  scipy's ``uniform_filter`` does the windowing."""
    from scipy.ndimage import uniform_filter

    K1, K2, L = 0.01, 0.03, 1.0
    C1, C2 = (K1 * L) ** 2, (K2 * L) ** 2
    NP = win * win
    cov_norm = NP / (NP - 1.0)
    pad = (win - 1) // 2
    vals = []
    for c in range(pred.shape[-1]):
        x = pred[..., c].astype(np.float64)
        y = gt[..., c].astype(np.float64)
        ux, uy = uniform_filter(x, size=win), uniform_filter(y, size=win)
        uxx, uyy = uniform_filter(x * x, size=win), uniform_filter(y * y, size=win)
        uxy = uniform_filter(x * y, size=win)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux * ux + uy * uy + C1) * (vx + vy + C2))
        vals.append(S[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))


def evaluate(
    params,
    model,
    ds,
    save_dir: Optional[str] = None,
    settings=None,
    lpips_fn=None,
    split: str = "test",
    device="cuda",
) -> Dict[str, float]:
    """PSNR / SSIM (and LPIPS with ``lpips_fn(pred01, gt01) -> float``,
    :func:`soar_tpu_torch.train.lpips.load_lpips`) over the held-out
    frames; ``params`` and ``model`` live on ``device``."""
    import torch

    from .. import resolve_device
    from ..avatar.renderer import RenderSettings, render_view
    from . import losses as L
    from .trainer import make_gt_batch

    dev = resolve_device(device)
    settings = RenderSettings() if settings is None else settings
    indices = ds.test_idx if split == "test" else ds.val_idx
    if not indices:  # tiny sequences: whatever is held out
        indices = ds.test_idx + ds.val_idx
    H, W = ds.image_size
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
    psnrs, ssims, lpipss, frames = [], [], [], []
    with torch.no_grad():
        for i in indices:
            batch = make_gt_batch(ds, model, i, device=dev)
            pred = render_view(params, model, batch["gt_cam"], (H, W),
                               torch.ones(3, device=dev), i, settings)["render"]
            pred = pred.cpu().numpy()
            gt = np.asarray(ds.images[i], np.float32).copy()
            gt[~(np.asarray(ds.masks[i]) > 0.5)] = 1.0  # whiten outside the mask
            psnrs.append(float(L.psnr(torch.from_numpy(pred), torch.from_numpy(gt))))
            ssims.append(skimage_ssim(pred, gt))
            if lpips_fn is not None:
                lpipss.append(float(lpips_fn(pred, gt)))
            frames.append(pred)
            if save_dir:
                save_png(os.path.join(save_dir, f"{i}.png"), pred)
    out = {
        "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
        "ssim": float(np.mean(ssims)) if ssims else float("nan"),
    }
    if lpipss:
        out["lpips"] = float(np.mean(lpipss))
    if save_dir and psnrs:
        np.savetxt(os.path.join(save_dir, "psnrs.txt"), np.asarray(psnrs))
        np.savetxt(os.path.join(save_dir, "ssims.txt"), np.asarray(ssims))
        if lpipss:
            np.savetxt(os.path.join(save_dir, "lpips.txt"), np.asarray(lpipss))
        with open(os.path.join(save_dir, "average.txt"), "w") as f:
            f.write(f"{out['psnr']} {out['ssim']} {out.get('lpips', float('nan'))}")
        try_save_mp4(os.path.join(save_dir, "test.mp4"), frames)
    return out
