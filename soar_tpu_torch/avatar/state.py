"""Avatar state (port of ``soar_tpu.avatar.state``).

- :class:`AvatarParams` — an ``nn.Module`` holding everything an optimizer
  touches: per-surfel xyz/rotation/scaling/opacity/colors/occ logits, the
  attribute field, and the per-frame ``latent_pose`` embedding;
- :class:`AvatarModel` — frozen context: body model, canonical-pose
  skinning data, per-frame SMPL parameters, field AABB.

Initialization follows the JAX package: canonical 30°-leg A-pose,
subdivided template, normal-aligned quats, 3-NN scale init, 0.5-gray
colors, occ=1e-2, opacity 0.1, then (``distill_steps`` > 0) the field is
distilled towards those explicit attributes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..body.model import BodyModel, smplx_forward
from ..body.skinning import SkinningData, make_skinning_data, mean_knn_sq_dist
from ..body.template import init_qso_on_mesh, subdivide_n
from ..core.constants import constant
from ..core.transforms import quat_to_rotmat
from ..field.attribute_field import AttributeField, AttributeFieldConfig, reset_field


class AvatarParams(nn.Module):
    def __init__(
        self,
        xyz: torch.Tensor,  # [N, 3] canonical positions
        rotation: torch.Tensor,  # [N, 4] raw quats
        scaling: torch.Tensor,  # [N, 1] log-scale
        opacity: torch.Tensor,  # [N, 1] logit
        colors: torch.Tensor,  # [N, 3] logit
        occ: torch.Tensor,  # [N, 1] logit occlusion channel
        field: AttributeField,
        latent_pose: torch.Tensor,  # [F, 2] per-frame offset latents
    ):
        super().__init__()
        self.xyz = nn.Parameter(xyz)
        self.rotation = nn.Parameter(rotation)
        self.scaling = nn.Parameter(scaling)
        self.opacity = nn.Parameter(opacity)
        self.colors = nn.Parameter(colors)
        self.occ = nn.Parameter(occ)
        self.field = field
        self.latent_pose = nn.Parameter(latent_pose)


@dataclasses.dataclass(frozen=True, eq=False)
class AvatarModel:
    """Static (non-trained) context."""

    body: BodyModel
    skin: SkinningData
    smpl_params: Dict[str, torch.Tensor]  # per-frame arrays, [F, ...]
    aabb: torch.Tensor  # [2, 3]
    original_pos: torch.Tensor  # [N, 3]
    num_frames: int
    field_cfg: AttributeFieldConfig = AttributeFieldConfig()


# --- activations ------------------------------------------------------------


def get_scaling(p: AvatarParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_rotation(p: AvatarParams) -> torch.Tensor:
    return p.rotation / torch.clamp_min(
        torch.linalg.norm(p.rotation, dim=-1, keepdim=True), 1e-12
    )


def get_opacity(p: AvatarParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_colors(p: AvatarParams) -> torch.Tensor:
    return torch.sigmoid(p.colors)


def get_occ(p: AvatarParams) -> torch.Tensor:
    return torch.sigmoid(p.occ)


def get_normal(p: AvatarParams) -> torch.Tensor:
    return quat_to_rotmat(get_rotation(p))[..., :, 2]


def canonical_pose_params(
    body: BodyModel, betas: torch.Tensor, leg_angle_deg: float = 30.0
) -> Dict[str, torch.Tensor]:
    """The 30°-spread-leg canonical A-pose with transl (0, 0.3, 0): full-pose
    flat indices 5 and 8 (z-rotation of the two hip joints)."""
    dev = body.v_template.device
    J = body.num_joints
    full = np.zeros((1, J * 3), np.float32)
    a = leg_angle_deg / 180.0 * np.pi
    if J * 3 > 8:
        full[0, 5] = a
        full[0, 8] = -a
    full = torch.from_numpy(full).to(dev)
    return {
        "betas": torch.atleast_2d(betas)[:1],
        "global_orient": full[:, :3],
        "body_pose": full[:, 3:],
        "transl": torch.tensor([[0.0, 0.3, 0.0]], device=dev),
    }


def frame_params(
    model: AvatarModel,
    frame_idx: int,
    zero_root: bool = False,
    override: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Slice per-frame SMPL params; optionally zero global_orient/transl
    (+ the (0, 0.3, 0) shift) as the gen-view path does.  ``override``
    entries replace sliced values (novel-pose rendering)."""
    idx = int(frame_idx) % model.num_frames
    out = {}
    for k, v in model.smpl_params.items():
        if k == "betas":
            out[k] = v if v.ndim == 2 else v[None]
        elif k in ("w2c", "Ks", "normal_Ks", "img_wh"):
            continue
        else:
            out[k] = v[idx:idx + 1]
    if zero_root:
        out = root_zeroed(out)
    if override:
        for k, v in override.items():
            out[k] = torch.as_tensor(v, device=out[k].device).reshape(out[k].shape)
    return out


def root_zeroed(fp: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A frame's SMPL parameters as the gen views pose them: global_orient
    zero and transl (0, 0.3, 0)."""
    return dict(fp, global_orient=torch.zeros_like(fp["global_orient"]),
                transl=torch.zeros_like(fp["transl"]) + constant(
                    (0.0, 0.3, 0.0), torch.get_default_dtype(), fp["transl"].device))


def live_affines(
    model: AvatarModel,
    frame_idx: int,
    zero_root: bool = False,
    override: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Per-joint live affines A [J, 4, 4] for a frame."""
    out = smplx_forward(
        model.body, frame_params(model, frame_idx, zero_root, override)
    )
    return out.A[0]


def init_avatar(
    body: BodyModel,
    smpl_params: Dict[str, np.ndarray],
    num_subdiv: int = 2,
    field_cfg: AttributeFieldConfig = AttributeFieldConfig(),
    seed: int = 0,
    distill_steps: int = 0,
    device="cuda",
) -> Tuple[AvatarParams, AvatarModel]:
    """Surfels on the ``num_subdiv``-times subdivided canonical template.
    ``body`` must already live on ``device``; the field's random tables come
    from a ``torch.Generator`` seeded with ``seed``.  ``distill_steps`` > 0
    distils the explicit init into the field (:func:`reset_field`) on the
    points and their normal-offset copies, minibatched above 100k points
    with draws from a generator seeded with 0, as the JAX package's
    ``reset_field`` draws from ``PRNGKey(0)``."""
    dev = resolve_device(device)
    sp = {k: _as_f32(v, dev) for k, v in smpl_params.items()}

    betas = torch.atleast_2d(sp["betas"])[:1]
    cano = smplx_forward(body, canonical_pose_params(body, betas))
    cano_vertices = cano.vertices[0]

    verts_np, faces_np = subdivide_n(
        cano_vertices.cpu().numpy(), body.faces.cpu().numpy(), num_subdiv
    )
    quats_np, _, _ = init_qso_on_mesh(verts_np, faces_np, seed=seed)
    points = torch.from_numpy(verts_np).to(dev)
    N = points.shape[0]

    d2 = torch.clamp_min(mean_knn_sq_dist(points, k=3), 1e-7)
    scaling = 0.5 * torch.log(d2)[:, None]

    skin = make_skinning_data(body.lbs_weights, cano.A[0], cano_vertices, points, k=30)

    lo = points.min(dim=0).values
    hi = points.max(dim=0).values
    center = (lo + hi) / 2.0
    aabb = torch.stack([(lo - center) * 1.5 + center, (hi - center) * 1.5 + center])

    gen = torch.Generator(device=dev).manual_seed(seed)
    field = AttributeField(aabb, field_cfg, generator=gen)

    num_frames = int(sp["body_pose"].shape[0])
    params = AvatarParams(
        xyz=points,
        rotation=torch.from_numpy(quats_np).to(dev),
        scaling=scaling,
        opacity=torch.full((N, 1), _logit(0.1), device=dev),
        colors=torch.zeros((N, 3), device=dev),
        occ=torch.full((N, 1), _logit(1e-2), device=dev),
        field=field,
        latent_pose=torch.zeros((num_frames, 2), device=dev),
    )
    model = AvatarModel(
        body=body,
        skin=skin,
        smpl_params=sp,
        aabb=aabb,
        original_pos=points.clone(),
        num_frames=num_frames,
        field_cfg=field_cfg,
    )
    if distill_steps > 0:
        # Points plus normal-offset copies (``surfel_base.py:264-276``).
        with torch.no_grad():
            pts2 = torch.cat([points, points + 0.001 * get_normal(params)])
            gray2 = torch.full((2 * N, 3), 0.5, device=dev)
            scales2 = torch.cat([torch.exp(scaling)] * 2)
            quats2 = torch.cat([get_rotation(params)] * 2)
        reset_field(
            field, pts2, gray2, scales2, quats2, steps=distill_steps,
            batch_size=65536 if pts2.shape[0] > 100_000 else None,
            generator=torch.Generator(device=dev).manual_seed(0),
        )
    return params, model


def _as_f32(v, dev) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``dev``, floats as float32 (the
    JAX package runs with x64 disabled)."""
    t = torch.as_tensor(v).to(dev)
    return t.float() if t.is_floating_point() else t


def _logit(x: float) -> float:
    return float(np.log(x / (1.0 - x)))
