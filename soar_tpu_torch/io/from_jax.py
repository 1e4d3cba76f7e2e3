"""Carry a ``soar_tpu`` avatar across to this package.

Inputs are the JAX pytrees flattened by the caller into nested dicts of
numpy arrays (``np.asarray`` on every leaf); nothing here imports JAX.

- ``body``: the ``BodyModel`` fields (``v_template``, ``shapedirs``,
  ``posedirs``, ``J_regressor``, ``lbs_weights``, ``parents``, ``faces``,
  ``num_betas``, optional ``pose_mean``).
- ``params``: the ``AvatarParams`` fields; ``params["field"]`` holds
  ``aabb``, both hash tables (``encoding``, ``quat_encoding``) and the five
  ``mlp_*`` heads as lists of ``{"w", "b"}`` layers.  JAX's ``w`` is
  [in, out]; ``nn.Linear.weight`` is [out, in], so it is transposed here.
- ``model``: ``skin`` (``inv_mats``, ``cano_vertices``, ``point_weights``),
  ``smpl_params``, ``aabb``, ``original_pos``, ``num_frames``, ``body``
  and ``field_cfg`` (``dataclasses.asdict`` of the JAX config).
- the training state's background MLP (``bg_params``).

Carrying ``model.skin`` and the field keeps every random or tie-sensitive
init step (the field's ``jax.random`` tables, the kNN neighbour sets) out
of the comparison, so both packages compute the same function.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..avatar.state import AvatarModel, AvatarParams
from ..body.model import BodyModel
from ..body.skinning import SkinningData
from ..field.attribute_field import AttributeField, AttributeFieldConfig
from ..field.hashgrid import HashGridConfig

_HEADS = ("mlp_shs", "mlp_scales", "mlp_quats", "mlp_offsets", "mlp_opacities")


def _t(a, dev) -> torch.Tensor:
    t = torch.as_tensor(np.array(a)).to(dev)
    return t.float() if t.is_floating_point() else t.long()


def field_config_from_dict(d: Dict) -> AttributeFieldConfig:
    d = dict(d)
    return AttributeFieldConfig(grid=HashGridConfig(**d.pop("grid")), **d)


def body_from_numpy(body: Dict, device="cuda") -> BodyModel:
    dev = resolve_device(device)
    pm = body.get("pose_mean")
    return BodyModel(
        v_template=_t(body["v_template"], dev),
        shapedirs=_t(body["shapedirs"], dev),
        posedirs=_t(body["posedirs"], dev),
        J_regressor=_t(body["J_regressor"], dev),
        lbs_weights=_t(body["lbs_weights"], dev),
        parents=tuple(int(p) for p in body["parents"]),
        faces=_t(body["faces"], dev),
        num_betas=int(body["num_betas"]),
        pose_mean=None if pm is None else _t(pm, dev),
    )


def avatar_from_numpy(
    params: Dict, model: Dict, device="cuda"
) -> Tuple[AvatarParams, AvatarModel]:
    dev = resolve_device(device)
    cfg = field_config_from_dict(model["field_cfg"])
    f = params["field"]
    field = AttributeField(_t(f["aabb"], dev), cfg)
    with torch.no_grad():
        field.encoding.copy_(_t(f["encoding"], dev))
        field.quat_encoding.copy_(_t(f["quat_encoding"], dev))
        for head in _HEADS:
            for lin, layer in zip(getattr(field, head), f[head]):
                lin.weight.copy_(_t(layer["w"], dev).T)
                lin.bias.copy_(_t(layer["b"], dev))

    av = AvatarParams(
        xyz=_t(params["xyz"], dev),
        rotation=_t(params["rotation"], dev),
        scaling=_t(params["scaling"], dev),
        opacity=_t(params["opacity"], dev),
        colors=_t(params["colors"], dev),
        occ=_t(params["occ"], dev),
        field=field,
        latent_pose=_t(params["latent_pose"], dev),
    )
    sk = model["skin"]
    am = AvatarModel(
        body=body_from_numpy(model["body"], dev),
        skin=SkinningData(
            inv_mats=_t(sk["inv_mats"], dev),
            cano_vertices=_t(sk["cano_vertices"], dev),
            point_weights=_t(sk["point_weights"], dev),
        ),
        smpl_params={k: _t(v, dev) for k, v in model["smpl_params"].items()},
        aabb=_t(model["aabb"], dev),
        original_pos=_t(model["original_pos"], dev),
        num_frames=int(model["num_frames"]),
        field_cfg=cfg,
    )
    return av, am


def background_from_numpy(bg: Dict, device="cuda") -> Dict:
    """The JAX package's background MLP (``{"layers": [{"w": [in, out]}]}``,
    as numpy) in the port's layout, which is the same."""
    dev = resolve_device(device)
    return {"layers": [{k: _t(v, dev) for k, v in layer.items()} for layer in bg["layers"]]}
