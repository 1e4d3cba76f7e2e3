"""Avatar checkpoints, and the reference's Lightning checkpoints (port of
``soar_tpu.io.checkpoint``).

A checkpoint of the port is a directory, named ``stage<K>`` by the
training CLI as in the JAX package, holding one file: the ``AvatarParams``
``state_dict`` and the step, written with ``torch.save``.  Stage 1 loads
the stage-0 checkpoint into a freshly built avatar, optimizer state fresh.

A reference ``.ckpt`` is not such a checkpoint: :func:`load_avatar` refuses
it, and the callers that take one route it to the importers here —
:func:`import_reference_ckpt` for the explicit surfel tensors and
:func:`import_reference_field_from_ckpt` for the attribute field — which
share one :func:`load_reference_state_dict`.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
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
        raise ValueError(
            f"{path} is a reference Lightning checkpoint, not one of soar_tpu_torch's: "
            "import it with import_reference_ckpt / import_reference_field_from_ckpt "
            "(cli.train --import-ckpt, cli.render_rot --ckpt <file>.ckpt)")
    file = path if os.path.isfile(path) else os.path.join(path, CKPT_FILE)
    payload = torch.load(file, map_location=like.xyz.device, weights_only=True)
    like.load_state_dict(payload["params"])
    return like, int(payload["step"])


# Reference (Lightning) state_dict key -> AvatarParams field, for the
# explicit surfel tensors (``surfel_base.py:546-567``).
_REF_KEYMAP = {
    "geometry._xyz": "xyz",
    "geometry._rotation": "rotation",
    "geometry._scaling": "scaling",
    "geometry._opacity": "opacity",
    "geometry._colors": "colors",
    "geometry._occ": "occ",
    "geometry.latent_pose": "latent_pose",
}


def load_reference_state_dict(path: str) -> Dict:
    """``torch.load`` a reference Lightning ``.ckpt`` once, on the CPU; the
    explicit-tensor and field importers share it, so a caller reads the
    (multi-hundred-MB) file a single time.

    Loaded with ``weights_only=False``: a Lightning checkpoint holds
    non-tensor entries (hyperparameters, loop and callback state) that the
    restricted unpickler refuses.  That unpickler is what keeps a loaded file
    from running code, so pass only checkpoints you trust.  The port's own
    ``avatar.pt`` stays ``weights_only=True`` (:func:`load_avatar`)."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return sd


def import_reference_ckpt(
    path: str,
    like: Optional[AvatarParams] = None,
    state_dict: Optional[Dict] = None,
) -> Dict[str, np.ndarray]:
    """The explicit surfel tensors of a reference ``.ckpt``, as float32
    numpy arrays keyed by ``AvatarParams`` field name (missing keys warn).
    With ``like``, their shapes must equal the built avatar's, or a
    ``ValueError`` names the fields.  The attribute field is a separate
    import (:func:`import_reference_field_from_ckpt`)."""
    sd = load_reference_state_dict(path) if state_dict is None else state_dict
    out = {field: sd[key].detach().cpu().numpy().astype(np.float32)
           for key, field in _REF_KEYMAP.items() if key in sd}
    missing = set(_REF_KEYMAP) - set(sd.keys())
    if missing:
        warnings.warn(f"reference ckpt missing keys: {sorted(missing)}")
    if like is not None:
        # A mismatched surfel count (wrong --num-subdiv, another capture)
        # fails here with field names, not later as a broadcast error.
        bad = {k: (v.shape, tuple(getattr(like, k).shape))
               for k, v in out.items() if v.shape != tuple(getattr(like, k).shape)}
        if bad:
            raise ValueError(
                "reference ckpt shapes do not match the built avatar (field: (ckpt, avatar)): "
                f"{bad} — check --num-subdiv / the capture the avatar was initialized from")
    return out


def apply_reference_tensors(params: AvatarParams, mapped: Dict[str, np.ndarray]) -> AvatarParams:
    """Copy :func:`import_reference_ckpt`'s arrays into ``params`` in place
    (on its device); returns ``params``."""
    with torch.no_grad():
        for k, v in mapped.items():
            p = getattr(params, k)
            p.copy_(torch.from_numpy(v).to(p.device))
    return params


def import_reference_field_from_ckpt(path: str, state_dict: Optional[Dict] = None,
                                     device="cuda"):
    """The ``geometry.attribute_field.*`` weights of a reference ``.ckpt``
    (read the same way at ``test/render_rot.py:129-135``) as a
    :class:`soar_tpu_torch.field.reference_import.ReferenceField` on
    ``device``, or None when the checkpoint holds no field.  Both nerfstudio
    layouts (tcnn packed buffers, torch hash tables)."""
    from ..field.reference_import import import_reference_field

    sd = load_reference_state_dict(path) if state_dict is None else state_dict
    prefix = "geometry.attribute_field."
    field_sd = {k: v.detach().cpu().numpy() for k, v in sd.items()
                if k.startswith(prefix) and hasattr(v, "detach")}
    if not field_sd:
        return None
    return import_reference_field(field_sd, prefix=prefix, device=device)
