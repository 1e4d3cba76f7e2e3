"""Novel poses: the avatar on an SMPL-X-sized body, reposed per request.
One client in a closed loop, one request a view: request ``n`` renders
frame ``n mod views`` of the capture, its full SMPL-X pose in its seven
segments (global orientation, 21 body joints, jaw, eyes, both hands, the
expression), through that frame's camera, white background, the field
queried on every view, as ``soar_tpu_torch.cli.render_rot`` renders a
checkpoint's avatar.  A request ends when the images ``run_turntable``
saves for a view (rgb, normal, occ, mask) are uint8 arrays on the host.

Set-up writes the body (:mod:`benchmark.smplx_body`) from the seed to a
temporary ``.npz`` in SMPL-X's layout and reads it back through
``cli.common.load_body_model``, as a user's ``SMPLX_NEUTRAL.npz`` is read;
the avatar is ``init_avatar`` on it with the configuration's subdivision.
Each frame's pose, the subject's betas and the expressions are drawn from
the seed on the device (:func:`frame_params`).

Correctness is the turntable's: a sample of the window's requests, drawn
from the seed, is kept, and after the window the reference
(``benchmark/reference``, the body read by its own ``np.load``) renders the
same frames; each image kind is compared by the share of the covered
pixels that differ by more than one level of 255 (the worst sampled view).

For the per-layer readers of ``benchmark/metrics/*.novel.py`` the cell set
up in this process sits in :data:`LIVE`; the first span reader profiles
``span_units`` views with the program's spans on
(``benchmark.spans.measure``) and the others read the same table.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import cell as C
from .. import scene, smplx_body
from . import turntable as T
from .turntable import images

UNIT = "view"

# The cell set up in this process, for the per-layer readers (the harness
# calls them after the traced run and before ``Cell.free``).
LIVE = []

# SMPL-X's pose segments in the order the frames draw them: (name, joints,
# the draw scale's key in the mix's ``draws``).
SEGMENTS = (("body_pose", 21, "body_std"), ("jaw_pose", 1, "face_std"),
            ("leye_pose", 1, "face_std"), ("reye_pose", 1, "face_std"),
            ("left_hand_pose", 15, "hand_std"), ("right_hand_pose", 15, "hand_std"))
HANDS = ("left_hand_pose", "right_hand_pose")


def frame_params(cfg: Dict, mix: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Every frame's SMPL-X parameters, drawn on the device from the seed:
    ``global_orient`` a yaw U(-yaw, yaw) about y, then the segments of
    :data:`SEGMENTS` N(0, std^2) per axis-angle component, the expressions
    N(0, expression_std^2), one subject's betas N(0, betas_std^2), and the
    capture's translation."""
    F, d, b = mix["views"], mix["draws"], cfg["body"]
    g = scene.generator(seed, "pose", device)

    def normal(rows, n, std):
        return (torch.randn((rows, n), generator=g, device=device) * std).cpu().numpy()

    yaw = (2.0 * torch.rand((F,), generator=g, device=device) - 1.0) * d["yaw"]
    go = np.zeros((F, 3), np.float32)
    go[:, 1] = yaw.cpu().numpy()
    out = {"global_orient": go}
    for name, joints, std in SEGMENTS:
        out[name] = normal(F, 3 * joints, d[std])
    out["expression"] = normal(F, b["num_expression"], d["expression_std"])
    out["betas"] = normal(1, b["num_betas"], d["betas_std"])
    out["transl"] = np.tile(np.asarray(cfg["capture"]["transl"], np.float32)[None], (F, 1))
    return {k: v.astype(np.float32) for k, v in out.items()}


def body_counts(body) -> Dict[str, int]:
    """The sizes the configuration's ``body`` entry states, read off a
    loaded body (the program's or the reference's)."""
    return {"num_joints": body.num_joints, "vertices": body.num_verts,
            "faces": int(body.faces.shape[0]),
            "pose_directions": int(body.posedirs.shape[0]),
            "kept_directions": int(body.shapedirs.shape[-1]),
            "hand_means": int(body.pose_mean is not None
                              and bool(body.pose_mean[75:].any()))}


def expected_counts(b: Dict) -> Dict[str, int]:
    return {"num_joints": b["num_joints"], "vertices": b["vertices"], "faces": b["faces"],
            "pose_directions": b["pose_directions"],
            "kept_directions": b["num_betas"] + b["num_expression"], "hand_means": 1}


class Cell:
    unit = UNIT

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
        from soar_tpu_torch.avatar.state import init_avatar
        from soar_tpu_torch.cli.common import load_body_model
        from soar_tpu_torch.cli.render_rot import gt_camera
        from soar_tpu_torch.data.dataset import AvatarDataset
        from soar_tpu_torch.field import attribute_field, hashgrid

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self._spans = None
        self._ref = None
        b, F = cfg["body"], mix["views"]
        if cfg["capture"]["frames"] != F:
            raise ValueError(f"the mix cycles {F} frames, the capture holds "
                             f"{cfg['capture']['frames']}")
        self.sp = frame_params(cfg, mix, seed, device)
        self.arrays = scene.capture_arrays(cfg["capture"], seed, device)
        C.stage("inputs", device)
        path = smplx_body.write(seed, self.tubes())
        try:
            body = load_body_model(path, device=device)
        finally:
            os.remove(path)
        got, want = body_counts(body), expected_counts(b)
        if got != want:
            raise RuntimeError(f"the body reads {got}, the configuration states {want}")
        C.stage("body", device)
        ds = AvatarDataset(smpl_params=self.sp, train_idx=list(range(F)), val_idx=[],
                           test_idx=[], **self.arrays)
        params, model = init_avatar(body, self.sp, num_subdiv=b["num_subdiv"],
                                    field_cfg=C._field_cfg(attribute_field, hashgrid,
                                                           cfg["field"]),
                                    seed=C.init_seed(seed), distill_steps=0, device=device)
        scene.fill_field_(params.field, seed)
        C.stage("avatar", device)
        if params.xyz.shape[0] != cfg["surfels"]:
            raise RuntimeError(f"{params.xyz.shape[0]} surfels, the configuration states "
                               f"{cfg['surfels']}")
        H, W = ds.image_size
        cams = [gt_camera(ds, i, device) for i in range(F)]
        bg = torch.ones(3, device=device)
        settings = RenderSettings(use_explicit=False)
        self.params, self.model = params, model

        def render(i: int):
            return render_view(params, model, cams[i], (H, W), bg, i, settings)

        self._render = render
        self.n_views = F
        self.i = 0
        self.sample_rng = np.random.RandomState(scene.sub_seed(seed, "sample") % 2**32)
        self.kept: List = []  # (request number, frame, images)
        self.done = 0
        LIVE[:] = [self]

    def tubes(self):
        """The body's tube layout (``smplx_body.LAYOUTS``)."""
        return smplx_body.LAYOUTS[self.cfg["body"]["layout"]]

    @torch.no_grad()
    def unit_call(self, keep: bool = True):
        """One request: the next frame, its images on the host, kept in the
        sample when ``keep``."""
        i = self.i
        self.i = (self.i + 1) % self.n_views
        imgs = images(self._render(i))
        if keep:
            self._keep(i, imgs)
        return imgs

    _keep = T.Cell._keep
    window = T.Cell.window
    readings = T.Cell.readings

    def warmup(self):
        for _ in range(self.n_views):
            self.unit_call(keep=False)
        C.stage("warmup_views", self.device)
        self.i = 0

    def span_table(self) -> Dict:
        """The program's span table over the mix's ``span_units`` views
        (``benchmark.spans.measure``), measured once."""
        if self._spans is None:
            from ..spans import measure

            self._spans = measure(self, self.mix, self.mix["span_units"])
        return self._spans

    def free(self):
        LIVE.clear()
        del self.params, self.model, self._render
        C.empty_cache(self.device)

    # ---------------------------------------------------------------- check

    def reference_views(self, frames, mode: str = "reference") -> Dict[int, List[np.ndarray]]:
        """The reference's images of the given frames: ``mode``
        "reference" (float32, the configuration's precision), "control"
        (a precision below: the composite in bf16), "hands_zeroed" or
        "expression_zeroed" (faults: those parameters of every frame
        zero)."""
        from ..reference import full_float32

        with full_float32():
            return self._reference_views(frames, mode)

    def _reference_avatar(self):
        """The reference's camera list, avatar params and model, built once
        from the same inputs: the body written again from the seed and read
        by the reference's own reader."""
        if self._ref is None:
            from ..reference.avatar.state import init_avatar
            from ..reference.body.smplx_file import load_smplx_npz
            from ..reference.core.camera import camera_from_c2w
            from ..reference.field import attribute_field, hashgrid

            cfg, dev, b = self.cfg, self.device, self.cfg["body"]
            path = smplx_body.write(self.seed, self.tubes())
            try:
                body = load_smplx_npz(path, b["num_betas"], b["num_expression"], device=dev)
            finally:
                os.remove(path)
            ds = C.Capture(smpl_params=self.sp, **self.arrays)
            params, model = init_avatar(body, self.sp, num_subdiv=b["num_subdiv"],
                                        field_cfg=C._field_cfg(attribute_field, hashgrid,
                                                               cfg["field"]),
                                        seed=C.init_seed(self.seed), distill_steps=0,
                                        device=dev)
            scene.fill_field_(params.field, self.seed)
            H, W = ds.image_size
            cams = []
            for i in range(self.n_views):
                fov = ds.frame_fovs(i)
                cams.append(camera_from_c2w(
                    torch.as_tensor(ds.gt_c2w(i), dtype=torch.float32, device=dev),
                    fov["fovx"], fov["fovy"], znear=0.1, zfar=100.0,
                    prcppoint=torch.tensor([fov["cx"] / W, fov["cy"] / H],
                                           dtype=torch.float32, device=dev)))
            self._ref = (cams, (H, W), params, model)
        return self._ref

    def _reference_views(self, frames, mode: str) -> Dict[int, List[np.ndarray]]:
        import dataclasses

        from ..reference.avatar.renderer import RenderSettings, render_view
        from ..reference.render.types import RasterConfig

        dev = self.device
        cams, size, params, model = self._reference_avatar()
        raster = RasterConfig()
        if mode == "control":
            raster = dataclasses.replace(raster, composite="plain", composite_dtype="bf16")
        zeroed = {"hands_zeroed": HANDS, "expression_zeroed": ("expression",)}.get(mode, ())
        settings = RenderSettings(use_explicit=False, raster=raster)
        bg = torch.ones(3, device=dev)
        out = {}
        with torch.no_grad():
            for i in sorted(set(frames)):
                override = {k: torch.zeros_like(model.smpl_params[k][i]) for k in zeroed}
                r = render_view(params, model, cams[i], size, bg, i, settings,
                                smpl_override=override or None)
                out[i] = images({k: v.float() for k, v in r.items()
                                 if k in ("render", "normal", "occ", "mask")})
        return out

    def check(self) -> Dict[str, float]:
        """The numbers compared: per image kind, the largest share of pixels
        off by more than one level over the sampled requests."""
        frames = [i for _, i, _ in self.kept]
        want = self.reference_views(frames)
        got = {i: imgs for _, i, imgs in self.kept}
        return self.readings(got, want, frames)

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The planted faults, each against the reference on the sampled
        frames: every view answered with the next frame's images; the hand
        poses zeroed; the expressions zeroed."""
        frames = sorted({i for _, i, _ in self.kept})
        nxt = sorted({(i + 1) % self.n_views for i in frames})
        ref = self.reference_views(sorted(set(frames) | set(nxt)))
        out = {"next_frame": self.readings(
            {i: ref[(i + 1) % self.n_views] for i in frames}, ref, frames)}
        for mode in ("hands_zeroed", "expression_zeroed"):
            out[mode] = self.readings(self.reference_views(frames, mode), ref, frames)
        return out

    def control(self) -> Dict[str, float]:
        """The same numbers for the control against the reference (the
        sampled frames)."""
        frames = sorted({i for _, i, _ in self.kept})
        return self.readings(self.reference_views(frames, "control"),
                             self.reference_views(frames), frames)


# ------------------------------------------------------ the per-layer readers


def live(ctx: Dict):
    """The novel-pose cell set up in this process, or None for another
    cell's units."""
    return LIVE[0] if LIVE and ctx.get("unit") == UNIT else None


def reading(ctx: Dict, span: str, prefix: bool = False) -> Optional[float]:
    """Device ms a view inside ``span`` (with ``prefix``, and inside every
    span whose name starts with ``span.``) of the cell set up in this
    process, from its span table; None for another cell's units, where the
    program's view opens no ``soar.render`` or where no such span ran."""
    cell = live(ctx)
    if cell is None:
        return None
    table = cell.span_table()["table"]
    if not table or "soar.render" not in table["spans"]:
        return None
    rows = table["spans"]
    got = [r["device_ms"] for name, r in rows.items()
           if name == span or (prefix and name.startswith(span + "."))]
    return sum(got) if got else None
