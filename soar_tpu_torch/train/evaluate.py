"""Image output helpers of ``soar_tpu.train.evaluate`` the turntable needs.

``save_png`` writes an 8-bit PNG with ``zlib`` and ``struct`` alone, so
the port needs no image library; ``try_save_mp4`` uses OpenCV when it is
installed and reports failure otherwise.  The eval protocol arrives with
the training slice.
"""

from __future__ import annotations

import struct
import zlib
from typing import List

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
