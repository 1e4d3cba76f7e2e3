"""The benchmark's plain reference of the SOAR avatar: a frozen copy of the
pure-PyTorch modules of ``soar_tpu_torch`` (commit 12fecb7), with the CUDA
composites replaced by the plain composite, and only the single-device path
the cells' checks call (no sharding, chunking, recompute or split SDS).  It
imports nothing of the program, so a later change to the program cannot
move it.  See ``README.md`` beside it.

Importing it changes no global setting: the checks run it inside
:func:`full_float32`, which turns TF32 off for its float32 contractions and
restores the caller's settings after.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_float32():
    """TF32 off (every float32 contraction in full float32) inside the
    block; the caller's settings are restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
    return dev
