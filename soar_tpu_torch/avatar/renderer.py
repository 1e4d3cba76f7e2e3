"""Posed-avatar view rendering: LBS skinning -> field query -> rasterize
(port of ``soar_tpu.avatar.renderer``).

Pose the canonical surfels and their frames with the kNN-blended skinning
matrices, query the attribute field for colors/scales, rasterize a main
pass plus a front-face-culled occlusion pass, and post-process normals and
curvature.  ``both_faces`` renders the front and back surfaces (plus the
shared occ pass) from one preprocess and sort.

A view rendered on CUDA without autograd is replayed from two CUDA graphs
around its composite launches (:mod:`soar_tpu_torch.render.graphs`); every
other call runs the same three phases eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Hashable, Optional, Tuple

import torch

from ..body.model import smplx_forward
from ..body.skinning import apply_point_mats, point_skinning_mats
from ..core import spans
from ..core.camera import Camera
from ..core.constants import constant
from ..core.transforms import quat_to_rotmat, rotmat_to_quat
from ..field.attribute_field import attribute_field_apply
from ..render import graphs
from ..render.postprocess import depth2normal, normal2curv
from ..render.tiled import Passes, composite_passes, raster_passes
from ..render.types import GaussianInputs, RasterConfig
from . import state as S
from .state import AvatarModel, AvatarParams


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static per-call switches; defaults equal the JAX package's."""

    use_explicit: bool = False  # explicit colors/scales vs attribute field
    offset: bool = False  # add field offsets to the posed points
    gen_view: bool = False  # random novel view: zero root + axis permute
    render_front: bool = True  # False => back-surface pass
    force_opaque: bool = True  # SOAR surfels composite with opacity 1
    raster: RasterConfig = RasterConfig()
    # lite: skip the occlusion pass and the curvature / depth->normal post
    # ops; render/normal/depth/mask are identical to the full render.
    lite: bool = False
    # both_faces: front and back surface passes from one shared preprocess
    # and sort; render_view then returns a (front_dict, back_dict) tuple.
    both_faces: bool = False


# Axis permutation "+z,+x,+y" applied to gen-view points: points transform
# as x @ T and frames as T^T @ R.
_PERMUTE_T = ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
# The y/z flip of a view-space normal.
_FLIP = (1.0, -1.0, -1.0)


@spans.spanned("soar.field")
def query_attributes(params: AvatarParams, model: AvatarModel):
    """Query the canonical attribute field at the (detached) surfel
    positions — camera-independent, so one query serves every view."""
    return attribute_field_apply(params.field, params.xyz.detach())


@spans.spanned("soar.pose")
def posed_gaussians(
    params: AvatarParams,
    model: AvatarModel,
    frame_idx: int,
    settings: RenderSettings = RenderSettings(),
    attrs: Optional[Dict[str, torch.Tensor]] = None,
    smpl_override: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[GaussianInputs, torch.Tensor]:
    """LBS-pose the avatar for one frame and assemble the rasterizer inputs.
    Returns ``(GaussianInputs, occ_colors)``."""
    fp = S.frame_params(model, frame_idx, settings.gen_view, smpl_override)
    return _posed(params, model, fp, settings, attrs)


def _posed(params, model, fp, settings, attrs):
    """:func:`posed_gaussians` from the frame's SMPL parameters ``fp``
    (:func:`soar_tpu_torch.avatar.state.frame_params`)."""
    points = params.xyz
    rot = S.get_rotation(params)

    with spans.span("soar.pose.lbs"):
        live_A = smplx_forward(model.body, fp).A[0]

    if attrs is None:
        attrs = query_attributes(params, model)

    with spans.span("soar.pose.skin"):
        pt_mats = point_skinning_mats(model.skin, live_A)
        posed = apply_point_mats(pt_mats, points)
    if settings.offset:
        posed = posed + attrs["offsets"]

    # Multiply the (blended) skinning rotation with the surfel frame, then
    # convert back to a normalized quaternion, as the reference does.
    R_surf = quat_to_rotmat(rot)
    R_out = pt_mats[..., :3, :3] @ R_surf
    if settings.gen_view:
        T = constant(_PERMUTE_T, posed.dtype, posed.device)
        posed = posed @ T
        R_out = T.T @ R_out
    rot_out = rotmat_to_quat(R_out)

    if settings.use_explicit:
        scale1 = S.get_scaling(params)  # [N, 1]
        colors = S.get_colors(params)
    else:
        scale1 = attrs["scales"]
        colors = attrs["shs"]
    scales = torch.cat([scale1, scale1, torch.zeros_like(scale1)], dim=-1)

    if settings.force_opaque:
        opac = torch.ones_like(params.opacity[:, 0])
    else:
        opac = S.get_opacity(params)[:, 0]

    g_main = GaussianInputs(
        means3d=posed, quats=rot_out, scales=scales, opacities=opac, colors=colors
    )
    occ_colors = S.get_occ(params).expand(points.shape[0], 3)
    return g_main, occ_colors


def _view_passes(params, model, settings, image_size, fp, camera, bg_color, attrs) -> Passes:
    """A view up to its composites: the pose, the field query and the
    rasterizer's front end."""
    with spans.span("soar.pose"):
        g_main, occ_colors = _posed(params, model, fp, settings, attrs)
    main_cfg = dataclasses.replace(
        settings.raster,
        render_front=False,
        sort_descending=False,
        # Back-surface pass: composite farthest-first without re-sorting,
        # sharing the ascending sort with the occlusion pass.
        compose_reverse=not (settings.render_front or settings.both_faces),
    )
    return raster_passes(g_main, camera, image_size, bg_color, main_cfg,
                         None if settings.lite else occ_colors, also_back=settings.both_faces)


def _view_outputs(settings, image_size, raster_out, camera):
    """The render dict (a ``(front, back)`` pair with ``both_faces``) from
    the rasterizer's ``(main, occ)``: the normals' flip and the post ops."""
    main, occ_out = raster_out
    dev = (main[0] if settings.both_faces else main).color.device
    flip = constant(_FLIP, torch.get_default_dtype(), dev)

    def post(out):
        mask = out.opac > 1e-5
        # Outside the mask keep the values but stop gradients.
        normal = torch.where(mask[..., None], out.normal, out.normal.detach())
        normal = normal * flip  # y/z flip of the view-space normal
        normal01 = (normal + 1.0) / 2.0
        if settings.lite:
            return {
                "render": out.color,
                "normal": normal01,
                "depth": out.depth,
                "mask": out.opac,
                "overflow": out.overflow,
            }
        hard = out.opac.detach() > 1e-5
        curv = normal2curv(normal, hard)
        dn = depth2normal(out.depth, hard, camera, image_size) * flip
        return {
            "render": out.color,
            "normal": normal01,
            "depth": out.depth,
            "pred_normal": (dn + 1.0) / 2.0,
            "mask": out.opac,
            "occ": occ_out.color,
            "curv": curv,
            "overflow": out.overflow,
            "visible": out.visible,
        }

    if settings.both_faces:
        # The occ image is the same for both faces (same camera, colors and
        # ascending order): computed once and shared.
        front, back = main
        return post(front), post(back)
    return post(main)


def avatar_key(params: AvatarParams, model: AvatarModel) -> Hashable:
    """Every tensor of ``params`` and ``model`` by address, and the field's
    configuration: what a capture reads in place of the avatar."""
    return (tuple(map(graphs.tensor_key, params.parameters())),
            tuple(map(graphs.tensor_key, params.buffers())), params.field.cfg,
            tuple(graphs.tensor_key(getattr(model, f.name)) for f in dataclasses.fields(model)))


def _graphed(params: AvatarParams, inputs, settings: RenderSettings, rows) -> bool:
    """Whether a view with the copied inputs ``inputs`` replays from CUDA
    graphs: autograd off, the composite kernel, no row sharding and
    :func:`soar_tpu_torch.render.graphs.eligible`."""
    return (not torch.is_grad_enabled() and settings.raster.composite == "kernel" and rows is None
            and graphs.eligible(params.xyz.device, graphs.leaves(inputs)))


@spans.spanned("soar.render", unit="view")
def render_view(
    params: AvatarParams,
    model: AvatarModel,
    camera: Camera,
    image_size: Tuple[int, int],
    bg_color: torch.Tensor,
    frame_idx: int,
    settings: RenderSettings = RenderSettings(),
    attrs: Optional[Dict[str, torch.Tensor]] = None,
    smpl_override: Optional[Dict[str, torch.Tensor]] = None,
    rows=None,
) -> Dict[str, torch.Tensor]:
    """One posed view's render dict (a ``(front, back)`` pair with
    ``settings.both_faces``).  ``rows`` (a
    :func:`soar_tpu_torch.parallel.row_sharder`) composites only this
    rank's band of tile rows and gathers the bands before the post ops
    (:mod:`soar_tpu_torch.render.tiled`).

    On CUDA, with autograd, autocast and tracing off, the composite kernel
    and no ``rows``, the view is replayed from CUDA graphs
    (:func:`soar_tpu_torch.render.graphs.run`): the same phases, the same
    values.  ``render_view.eager``, ``.captures`` and ``.replays`` count
    those calls of each kind since import."""
    fp = S.frame_params(model, frame_idx, settings.gen_view, smpl_override)
    inputs = (fp, camera, bg_color, attrs)

    def front(x):
        p = _view_passes(params, model, settings, image_size, *x)
        return p.finish, [p], ()

    def back(x, finish, results, regs):
        return _view_outputs(settings, image_size, finish(results[0]), x[1])

    def eager(x):
        finish, (p,), _ = front(x)
        return back(x, finish, [composite_passes(p, settings.raster, rows)], ())

    if _graphed(params, inputs, settings, rows):
        key = (tuple(image_size), settings, avatar_key(params, model))
        return graphs.run(graphs.VIEWS, key, graphs.Segments(front, back, eager), inputs,
                          render_view)
    return eager(inputs)


# Calls of each kind since import.
render_view.eager = render_view.captures = render_view.replays = 0
