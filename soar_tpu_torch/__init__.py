"""soar_tpu_torch — the PyTorch/CUDA port of :mod:`soar_tpu`.

The package mirrors ``soar_tpu``'s module paths and function names so each
counterpart is easy to find (``soar_tpu.render.tiled.rasterize`` ->
``soar_tpu_torch.render.tiled.rasterize``).  It imports ``torch`` and never
``jax`` or ``soar_tpu``; the JAX package stays the reference the tests hold
this one against.

Every Pallas kernel on a ported path is a hand-written CUDA kernel under
``csrc/``, built with ``nvcc`` at first use (:mod:`soar_tpu_torch.kernels`).
Its plain PyTorch version sits beside it and is what a CPU tensor gets.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; they
run on the CPU only when the caller passes ``device="cpu"`` and raise when
CUDA is asked for but absent.

TF32 is switched off for matmuls and cuDNN convolutions here, at import:
the reference computes geometry and compositing contractions in full f32,
and TF32 keeps only about three decimal digits.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is requested but
    unavailable (there is no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
