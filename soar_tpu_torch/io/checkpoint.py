"""Avatar checkpoints (port of the native half of
``soar_tpu.io.checkpoint``).

A checkpoint is a directory, named ``stage<K>`` by the training CLI as in
the JAX package, holding one file: the ``AvatarParams`` ``state_dict`` and
the step, written with ``torch.save``.  Stage 1 loads the stage-0
checkpoint into a freshly built avatar, optimizer state fresh.  Importing
the reference's Lightning ``.ckpt`` is not ported yet.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch

from ..avatar.state import AvatarParams

CKPT_FILE = "avatar.pt"


def save_avatar(path: str, params: AvatarParams, step: int = 0) -> None:
    """Write ``params`` and ``step`` to ``<path>/avatar.pt`` (``path`` is
    created), atomically."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, CKPT_FILE)
    tmp = f"{target}.{os.getpid()}.tmp"
    torch.save({"params": params.state_dict(), "step": int(step)}, tmp)
    os.replace(tmp, target)


def load_avatar(path: str, like: AvatarParams) -> Tuple[AvatarParams, int]:
    """Load a checkpoint written by :func:`save_avatar` into ``like`` (which
    gives the structure and shapes, and stays on its device); returns
    ``(like, step)``."""
    if path.endswith(".ckpt"):
        raise NotImplementedError(
            "importing the reference's Lightning .ckpt is not ported yet; "
            "pass a checkpoint directory written by soar_tpu_torch"
        )
    file = path if os.path.isfile(path) else os.path.join(path, CKPT_FILE)
    payload = torch.load(file, map_location=like.xyz.device, weights_only=True)
    like.load_state_dict(payload["params"])
    return like, int(payload["step"])
