"""8-bit PNG reading with ``zlib`` and numpy alone: the inverse of
:func:`soar_tpu_torch.train.evaluate.save_png`, and the part of OpenCV's
``imread(path, IMREAD_UNCHANGED)`` that the capture loaders use, so the
port reads captures without an image library.

Supported: bit depth 8, no interlacing, colour types 0 (gray -> [H, W]),
2 (RGB -> [H, W, 3]), 4 (gray + alpha) and 6 (RGBA -> [H, W, 4]).  Channels
come back in RGB(A) order (OpenCV returns BGR(A)).  Gray + alpha comes back
as [H, W, 4] (gray, gray, gray, alpha), as OpenCV expands it.  Every
chunk's CRC is checked, the IDAT chunks are joined before one
decompression, and all five scanline filters are undone: None and Up as one
operation over the row, Sub as a per-channel running sum mod 256, Average
and Paeth, which depend on the reconstructed byte to their left, with a
loop over the row's bytes.
Other files (16-bit, palette, Adam7-interlaced) raise ``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    """Yield (tag, payload) of each chunk, the CRC checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC or truncated {tag!r} chunk")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter_average(raw: bytes, up: bytes, bpp: int) -> bytearray:
    """Filter 3: x + floor((left + up) / 2), left the reconstructed byte
    ``bpp`` back.  A plain loop over the row's bytes: numpy calls on the 1-4
    channel values of one pixel cost about ten times as much."""
    out = bytearray(len(raw))
    for i in range(len(raw)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (raw[i] + ((a + up[i]) >> 1)) & 0xFF
    return out


def _unfilter_paeth(raw: bytes, up: bytes, bpp: int) -> bytearray:
    """Filter 4: x + the Paeth predictor of (left, up, up-left)."""
    out = bytearray(len(raw))
    for i in range(len(raw)):
        b = up[i]
        if i >= bpp:
            a, c = out[i - bpp], up[i - bpp]
        else:
            a = c = 0
        pa = abs(b - c)  # |p - a| with p = a + b - c
        pb = abs(a - c)
        pc = abs(a + b - c - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        out[i] = (raw[i] + pred) & 0xFF
    return out


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced gray, RGB, gray+alpha or RGBA PNG to
    a uint8 array: [H, W] for gray, else [H, W, 3 or 4] in RGB(A) order."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for tag, body in _chunks(data, path):
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color_type, _, _, interlace = header
    if depth != 8:
        raise ValueError(f"{path}: bit depth {depth} is not supported (8 only)")
    if color_type not in _CHANNELS:
        raise ValueError(f"{path}: colour type {color_type} is not supported "
                         "(0 gray, 2 RGB, 4 gray+alpha, 6 RGBA; not 3 palette)")
    if interlace != 0:
        raise ValueError(f"{path}: interlace method {interlace} is not supported "
                         "(non-interlaced only)")
    ch = _CHANNELS[color_type]
    stride = W * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (stride + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, expected "
                         f"{H * (stride + 1)}")
    raw = raw.reshape(H, stride + 1)
    filters, rows = raw[:, 0], raw[:, 1:]
    out = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        f, row = int(filters[y]), rows[y]
        if f == 0:
            cur = row
        elif f == 1:
            cur = (np.cumsum(row.reshape(W, ch), axis=0, dtype=np.int64) & 0xFF).astype(
                np.uint8).reshape(stride)
        elif f == 2:
            cur = row + prev  # uint8 arithmetic wraps mod 256
        elif f in (3, 4):
            undo = _unfilter_average if f == 3 else _unfilter_paeth
            cur = np.frombuffer(undo(row.tobytes(), prev.tobytes(), ch), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has unknown filter type {f}")
        out[y] = cur
        prev = out[y]
    if ch == 1:
        return out.reshape(H, W)
    img = out.reshape(H, W, ch)
    if ch == 2:  # gray + alpha -> (gray, gray, gray, alpha), as OpenCV returns it
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
    return img
