"""Small constant tensors made once per device.

A Python literal turned into a tensor on every call (``torch.tensor([...],
device=...)``) is a blocking copy from host memory on CUDA: a host sync on
every call, and an operation a CUDA graph cannot capture.  :func:`constant`
makes the tensor once per (values, dtype, device) and hands the same tensor
to every later call.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_CACHE: Dict[Tuple, torch.Tensor] = {}


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made on the first
    call and shared by every later one: read it, never write to it.
    ``values`` is a number or nested tuples of numbers.  The tensor is a
    normal one even when first asked for under ``torch.inference_mode``, so
    autograd may save it."""
    device = torch.device(device)
    key = (values, dtype, device)
    t = _CACHE.get(key)
    if t is None:
        with torch.inference_mode(False):
            t = _CACHE[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
