"""Minimal binary-little-endian PLY I/O (port of ``soar_tpu.io.ply``).

Layout-compatible with the reference's surfel export
(``geometry/surfel_base.py:697-746`` ``save_ply`` /
``geometry/gaussian_io.py:51-118``): one vertex element with float properties
x y z nx ny nz f_dc_* [f_rest_*] opacity scale_* rot_* occ, in the JAX
package's order, so a PLY written by either package reads in the other.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..avatar import state as S
from ..avatar.state import AvatarParams


def write_ply(path: str, props: Dict[str, np.ndarray]) -> None:
    """props: name -> [N] float32 column, insertion-ordered."""
    names = list(props.keys())
    n = len(next(iter(props.values())))
    cols = [np.asarray(props[k], np.float32).reshape(n) for k in names]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {k}" for k in names]
    header += ["end_header", ""]
    data = np.stack(cols, axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(data.tobytes())


def read_ply(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        blob = f.read()
    end = blob.index(b"end_header\n") + len(b"end_header\n")
    header = blob[:end].decode("ascii").splitlines()
    names: List[str] = []
    n = 0
    for line in header:
        parts = line.split()
        if parts[:2] == ["element", "vertex"]:
            n = int(parts[2])
        elif parts[0] == "property":
            if parts[1] != "float":
                raise ValueError(f"{path}: only float properties are supported, got {line!r}")
            names.append(parts[2])
    data = np.frombuffer(blob[end:], dtype="<f4", count=n * len(names))
    data = data.reshape(n, len(names))
    return {k: data[:, i].copy() for i, k in enumerate(names)}


def _columns(props: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    return np.stack([props[k] for k in sorted(p for p in props if p.startswith(prefix))], -1)


def ply_to_avatar(path: str, like: AvatarParams) -> AvatarParams:
    """Load surfel params exported by :func:`avatar_to_ply` (or a reference
    PLY with the same property names, ``gaussian_io.py:86-174``) into
    ``like``, which stays on its device: xyz, colors, scaling, rotation,
    opacity and, when present, occ are replaced (the surfel count may
    change); the field and ``latent_pose`` are untouched.  Returns ``like``."""
    props = read_ply(path)
    dev = like.xyz.device

    def param(a) -> torch.nn.Parameter:
        return torch.nn.Parameter(torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev))

    like.xyz = param(np.stack([props["x"], props["y"], props["z"]], -1))
    like.colors = param(_columns(props, "f_dc_")[:, : like.colors.shape[-1]])
    like.scaling = param(_columns(props, "scale_")[:, : like.scaling.shape[-1]])
    like.rotation = param(_columns(props, "rot_"))
    like.opacity = param(props["opacity"][:, None])
    if "occ" in props:
        like.occ = param(props["occ"][:, None])
    return like


def avatar_to_ply(path: str, params: AvatarParams, include_normals: bool = True) -> None:
    """Export surfel params in the reference's attribute order
    (``surfel_base.py:697-746``); colours and opacity as logits, as the
    reference stores them."""

    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    with torch.no_grad():
        normals = host(S.get_normal(params))
    xyz = host(params.xyz)
    colors = host(params.colors)
    scaling = host(params.scaling)
    rotation = host(params.rotation)

    props = {
        "x": xyz[:, 0],
        "y": xyz[:, 1],
        "z": xyz[:, 2],
        "nx": normals[:, 0],
        "ny": normals[:, 1],
        "nz": normals[:, 2],
    }
    for i in range(colors.shape[1]):
        props[f"f_dc_{i}"] = colors[:, i]
    props["opacity"] = host(params.opacity)[:, 0]
    for i in range(scaling.shape[1]):
        props[f"scale_{i}"] = scaling[:, i]
    for i in range(rotation.shape[1]):
        props[f"rot_{i}"] = rotation[:, i]
    props["occ"] = host(params.occ)[:, 0]
    write_ply(path, props)
