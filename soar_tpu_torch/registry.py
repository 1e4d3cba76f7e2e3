"""Named-component registry (port of ``soar_tpu.registry``).

The reference wires everything through threestudio's string registry
(``@threestudio.register(...)`` / ``threestudio.find``, ``__init__.py:
17-23``; ``utils/smpl.py:145-152``'s safe_register).  The port's
components are plain functions and classes wired explicitly, but the same
13 names resolve here, so the names a reference config holds
(``system_type: gaussiansurfel-mvdream-system``, ...) map onto the port's
constructors.
"""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    """Decorator; registering a name again is a no-op, like the reference's
    ``safe_register``."""

    def deco(fn):
        _REGISTRY.setdefault(name, fn)
        return fn

    return deco


def find(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown component {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def _populate():
    from .avatar.renderer import render_view
    from .avatar.state import init_avatar
    from .data.cameras import sample_multiview_cameras
    from .data.dataset import load_fs_sequence, load_sequence
    from .field.attribute_field import AttributeField
    from .guidance.sds import MultiviewGuidance
    from .train.background import init_background
    from .train.systems import make_gaussiandreamer_step, make_mvdream_step
    from .train.trainer import make_train_step

    mapping = {
        # reference registry name -> the port's constructor
        "gaussiansurfel-base": init_avatar,
        "gaussiansurfel-rasterizer": render_view,
        "gaussiansurfel-mvdream-system": make_train_step,
        "gaussian-mvdream-system": make_mvdream_step,
        "gaussiandreamer-system": make_gaussiandreamer_step,
        "gaussiandreamer-background": init_background,
        "imagedream-multiview-diffusion-guidance": MultiviewGuidance,
        "mvdream-multiview-diffusion-guidance": MultiviewGuidance,
        "smpl-guidance": init_avatar,  # the skinning state is built inside init
        "mvdream-random-multiview-camera-datamodule": load_sequence,
        "fs-mvdream-random-multiview-camera-datamodule": load_fs_sequence,
        "hash-attribute-field": AttributeField,
        "random-multiview-cameras": sample_multiview_cameras,
    }
    for k, v in mapping.items():
        _REGISTRY.setdefault(k, v)


_populate()
