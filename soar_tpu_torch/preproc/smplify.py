"""SMPLify: keypoint-based SMPL-X refinement (port of
``soar_tpu.preproc.smplify``).

Optimizes 6D joint rotations, translation and frame-averaged betas against
2D keypoints with L-BFGS (:mod:`soar_tpu_torch.preproc.lbfgs`, optax's
algorithm) in two stages: the body alone (20 steps, hand confidences
zeroed), then body and hands (40 steps), all frames jointly.

Losses:
- GMoF-robustified keypoint reprojection, scale-normalized to 200 px, x100;
- preserve-to-initialization L2, x60;
- temporal smoothness, the geodesic distance between consecutive frames'
  rotations, x10000.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..body.model import BodyModel, smplx_forward, smplx_forward_full
from ..core.transforms import batch_rodrigues, rotmat_to_rotvec
from . import lbfgs

# --- rotation parameterizations -------------------------------------------


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp_min(torch.linalg.norm(a1, dim=-1, keepdim=True), 1e-8)
    b2 = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = b2 / torch.clamp_min(torch.linalg.norm(b2, dim=-1, keepdim=True), 1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def matrix_to_rotation_6d(R: torch.Tensor) -> torch.Tensor:
    return R[..., :2, :].reshape(R.shape[:-2] + (6,))


def gmof(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Geman-McClure robustifier."""
    x2 = x * x
    s2 = sigma * sigma
    return s2 * x2 / (s2 + x2)


def smooth_loss_6d(d6: torch.Tensor) -> torch.Tensor:
    """Mean squared geodesic distance between consecutive frames'
    rotations.  d6: [F, J*6] (or [F, 6])."""
    R = rotation_6d_to_matrix(d6.reshape(d6.shape[0], -1, 6))
    R12 = torch.einsum("fjab,fjcb->fjac", R[1:], R[:-1])
    return torch.mean(torch.sum(rotmat_to_rotvec(R12) ** 2, dim=-1))


def target_scales_from_kps(target_kps_px: np.ndarray) -> np.ndarray:
    """Per-frame extent of the keypoints with confidence above 0.3 (1 for a
    frame without any)."""
    scales = []
    for frame in target_kps_px:
        valid = frame[frame[:, -1] > 0.3]
        if len(valid) == 0:
            scales.append(1.0)
            continue
        ext = valid[:, :2].max(0) - valid[:, :2].min(0)
        scales.append(float(max(ext[0], ext[1])))
    return np.asarray(scales, np.float32)


@dataclasses.dataclass(frozen=True)
class SMPLifyConfig:
    body_steps: int = 20
    hand_steps: int = 40
    kp_weight: float = 100.0
    preserve_weight: float = 60.0
    smooth_weight: float = 10000.0
    sigma: float = 100.0


_POSE_KEYS = ("body_pose", "global_orient", "left_hand_pose", "right_hand_pose")


def _to_6d(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in params.items():
        if k in _POSE_KEYS:
            aa = v.reshape(v.shape[0], -1, 3)
            out[k] = matrix_to_rotation_6d(batch_rodrigues(aa)).reshape(v.shape[0], -1)
        elif k == "betas":
            out[k] = torch.mean(torch.atleast_2d(v), dim=0, keepdim=True)
        else:
            out[k] = v
    return out


def _to_axis_angle(params6: Dict[str, torch.Tensor], n_frames: int) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in params6.items():
        if k in _POSE_KEYS:
            R = rotation_6d_to_matrix(v.reshape(v.shape[0], -1, 6))
            out[k] = rotmat_to_rotvec(R).reshape(v.shape[0], -1)
        elif k == "betas":
            out[k] = v.expand(n_frames, v.shape[-1])
        else:
            out[k] = v
    return out


class SMPLify:
    """Two-stage keypoint refinement.

    Args:
        body: the body model.
        joint_map: [K] model-joint indices for the target keypoints'
            columns (:func:`smplx_to_openpose25`); ignored with
            ``openpose137``.
        hand_kp_slice: (start, end) of the hand columns zeroed in stage 1.
        openpose137: the full SMPL-X -> OpenPose-137 mapping on the 144-joint
            output (vertex landmarks, face landmarks, dynamic contour), with
            the 137-column validity mask; needs the body's landmark tables.

    ``history`` keeps, per stage, the loss at the start of each step, the
    function evaluations per step and the stage's seconds.
    """

    def __init__(
        self,
        body: BodyModel,
        joint_map: Optional[np.ndarray] = None,
        cfg: SMPLifyConfig = SMPLifyConfig(),
        hand_kp_slice: Optional[Tuple[int, int]] = None,
        openpose137: bool = False,
    ):
        dev = body.v_template.device
        self.body = body
        self.joint_map = (None if joint_map is None
                          else torch.as_tensor(np.asarray(joint_map), dtype=torch.int64, device=dev))
        self.cfg = cfg
        self.hand_kp_slice = hand_kp_slice
        self.openpose137 = openpose137
        self.kp_mask = None
        self.history: List[Dict] = []
        if openpose137:
            src, dst, mask = smplx_to_openpose137()
            self._src = torch.as_tensor(src, device=dev)
            self._dst = torch.as_tensor(dst, device=dev)
            self.kp_mask = torch.as_tensor(mask, device=dev)
        elif joint_map is None:
            raise ValueError("need joint_map unless openpose137=True")

    def _loss(self, opt6, fixed6, init6, Ks, w2c, target_kps_px, target_scales,
              ignore_hands: bool) -> torch.Tensor:
        params6 = {**fixed6, **opt6}
        aa = _to_axis_angle(params6, Ks.shape[0])
        if self.openpose137:
            _, j144 = smplx_forward_full(self.body, aa)
            pred = convert_kps_137(j144, self._src, self._dst)  # [F, 137, 3]
        else:
            joints = smplx_forward(self.body, aa).joints[:, : self.body.num_joints]
            pred = joints[:, self.joint_map]  # [F, K, 3]

        pred_c = torch.einsum("ij,fkj->fki", w2c[:3],
                              torch.cat([pred, torch.ones_like(pred[..., :1])], -1))
        pix = torch.einsum("fij,fkj->fki", Ks, pred_c)
        pix = pix[..., :2] / torch.clamp_min(pix[..., 2:], 1e-5)

        conf = target_kps_px[..., 2:]
        if self.kp_mask is not None:
            conf = conf * self.kp_mask[None, :, None]
        if ignore_hands and self.hand_kp_slice is not None:
            s, e = self.hand_kp_slice
            conf = conf.clone()
            conf[:, s:e] = 0.0
        resid = (pix - target_kps_px[..., :2]) / target_scales[:, None, None] * 200.0
        kp_loss = torch.mean(gmof(resid, self.cfg.sigma) * conf)

        # eps-safe norm: params == init at a stage's start, where the exact
        # L2 norm has a NaN gradient.
        preserve = sum(torch.mean(torch.sqrt(torch.sum((params6[k] - init6[k]) ** 2, -1) + 1e-12))
                       for k in params6)
        smooth = sum(smooth_loss_6d(params6[k]) for k in _POSE_KEYS if k in params6)
        return (self.cfg.kp_weight * kp_loss + self.cfg.preserve_weight * preserve
                + self.cfg.smooth_weight * smooth)

    def _run_stage(self, opt6, fixed6, init6, aux, steps, ignore_hands):
        def loss_fn(p):
            return self._loss(p, fixed6, init6, *aux, ignore_hands=ignore_hands)

        t0 = time.perf_counter()
        opt6, values, evaluations = lbfgs.run(opt6, loss_fn, steps)
        self.history.append({"values": values, "evaluations": evaluations,
                             "seconds": time.perf_counter() - t0})
        return opt6

    def fit(
        self,
        init_params: Dict[str, torch.Tensor],  # axis-angle, per frame
        Ks: torch.Tensor,  # [F, 3, 3]
        w2c: torch.Tensor,  # [4, 4]
        target_kps: np.ndarray,  # [F, K, 3] normalized (x, y in [0, 1], conf)
        img_wh: Tuple[int, int],
    ) -> Dict[str, torch.Tensor]:
        dev = self.body.v_template.device
        target_px = np.concatenate(
            [np.asarray(target_kps[..., :2]) * np.asarray(img_wh, np.float32),
             np.asarray(target_kps[..., 2:])], axis=-1).astype(np.float32)
        scales = target_scales_from_kps(target_px)

        def dev_f32(a):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                   dtype=torch.float32).to(dev)

        aux = (dev_f32(Ks), dev_f32(w2c), dev_f32(target_px), dev_f32(scales))
        params6 = _to_6d({k: dev_f32(v) for k, v in init_params.items()})
        init6 = {k: v.clone() for k, v in params6.items()}
        self.history = []

        stage1_keys = ("betas", "body_pose", "global_orient", "transl")
        opt6 = {k: params6[k] for k in stage1_keys if k in params6}
        fixed6 = {k: v for k, v in params6.items() if k not in opt6}
        opt6 = self._run_stage(opt6, fixed6, init6, aux, self.cfg.body_steps, ignore_hands=True)
        params6 = {**fixed6, **opt6}

        stage2_keys = stage1_keys + ("left_hand_pose", "right_hand_pose")
        opt6 = {k: params6[k] for k in stage2_keys if k in params6}
        fixed6 = {k: v for k, v in params6.items() if k not in opt6}
        opt6 = self._run_stage(opt6, fixed6, init6, aux, self.cfg.hand_steps, ignore_hands=False)
        params6 = {**fixed6, **opt6}
        with torch.no_grad():
            return {k: v.detach() for k, v in _to_axis_angle(params6, int(aux[0].shape[0])).items()}


def smplx_to_openpose137():
    """``(src_inds, dst_inds, kp_mask)`` of the full SMPL-X -> OpenPose-137
    keypoint mapping: ``src_inds`` index the 144-joint output
    (:func:`soar_tpu_torch.body.model.smplx_forward_full`), ``dst_inds`` the
    OpenPose-137 columns ([25 body, 21 L hand, 21 R hand, 70 face]);
    ``kp_mask`` zeroes the columns SMPL-X cannot represent (the duplicate
    hand-wrist columns 25/46, the 10 jawline-contour points 84-93 beyond
    SMPL-X's 17-point contour, and the eye pupils 135/136)."""
    # fmt: off
    src = [
        55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,        # body
        56, 57, 58, 59, 60, 61, 62, 63, 64, 65,                     # face/feet
        37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68,             # L hand
        34, 35, 36, 69, 31, 32, 33, 70,
        52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73,             # R hand
        49, 50, 51, 74, 46, 47, 48, 75,
        127, 128, 129, 130, 131, 132, 133, 134, 135, 136, 137, 138,  # contour
        139, 140, 141, 142, 143,
        86, 87, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 98, 99,     # face 51
        100, 101, 102, 103, 104, 105, 106, 107, 108, 109, 110, 111,
        112, 113, 114, 115, 116, 117, 118, 119, 120, 121, 122, 123,
        124, 125, 126,
    ]
    dst = [
        0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
        15, 16, 17, 18, 19, 20, 21, 22, 23, 24,
        26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37,
        38, 39, 40, 41, 42, 43, 44, 45,
        47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
        59, 60, 61, 62, 63, 64, 65, 66,
        67, 68, 69, 70, 71, 72, 73, 74, 75, 76, 77, 78,
        79, 80, 81, 82, 83,
        94, 95, 96, 97, 98, 99, 100, 101, 102, 103, 104, 105, 106,
        107, 108, 109, 110, 111, 112, 113, 114, 115, 116, 117, 118,
        119, 120, 121, 122, 123, 124, 125, 126, 127, 128, 129, 130,
        131, 132, 133, 134,
    ]
    # fmt: on
    mask = np.ones(137, np.float32)
    mask[[25, 46, 84, 85, 86, 87, 88, 89, 90, 91, 92, 93, 135, 136]] = 0.0
    return np.asarray(src, np.int64), np.asarray(dst, np.int64), mask


def convert_kps_137(j144: torch.Tensor, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[F, 144, 3] SMPL-X joints -> [F, 137, 3] OpenPose columns, with the
    mid-hip synthesis (column 8 = mean of the hips) and the hips widened
    (columns 9/12 pushed outward in x/y: +-0.25 of the hip-to-hip vector,
    re-centred on the mid-hip), on the 3D joints before projection."""
    F, dev = j144.shape[0], j144.device
    src = torch.as_tensor(src, device=dev)
    dst = torch.as_tensor(dst, device=dev)
    new = torch.zeros((F, 137, 3), dtype=j144.dtype, device=dev).index_copy(1, dst, j144[:, src])
    mid = 0.5 * (new[:, 9] + new[:, 12])
    hips_idx = torch.tensor([9, 12], device=dev)
    hips = new[:, hips_idx, :2]
    swapped = new[:, torch.tensor([12, 9], device=dev), :2]
    adj = hips + 0.25 * (hips - swapped) + 0.5 * (mid[:, None, :2] - 0.5 * (hips + swapped))
    new = new.index_copy(1, torch.tensor([8], device=dev), mid[:, None])
    return new.index_copy(1, hips_idx, torch.cat([adj, new[:, hips_idx, 2:]], dim=-1))


def smplx_to_openpose25() -> np.ndarray:
    """Model-joint indices for the OpenPose BODY_25 columns from SMPL-X
    kinematic joints only (nose, eye, ear and toe columns reuse the head and
    foot joints, which the confidence weighting tolerates)."""
    return np.asarray(
        [
            15,  # nose -> head
            12,  # neck
            17, 19, 21,  # R shoulder, elbow, wrist
            16, 18, 20,  # L shoulder, elbow, wrist
            0,  # mid hip -> pelvis
            2, 5, 8,  # R hip, knee, ankle
            1, 4, 7,  # L hip, knee, ankle
            15, 15, 15, 15,  # eyes/ears -> head
            10, 10, 7,  # L toe, toe, heel -> L foot/ankle
            11, 11, 8,  # R toe, toe, heel -> R foot/ankle
        ],
        np.int64,
    )


def smplx_to_openpose_hands() -> np.ndarray:
    """Model-joint indices for the OpenPose hand-21 columns (left then
    right): wrist, then 4 points per finger (thumb, index, middle, ring,
    pinky) ending at the tip, which reuses the distal joint.  SMPL-X joints
    25-39 (left) / 40-54 (right) are finger joints 1..3 in (index, middle,
    pinky, ring, thumb) order."""
    left = [
        20,              # wrist
        37, 38, 39, 39,  # thumb 1..3 + tip
        25, 26, 27, 27,  # index
        28, 29, 30, 30,  # middle
        34, 35, 36, 36,  # ring
        31, 32, 33, 33,  # pinky
    ]
    right = [
        21,
        52, 53, 54, 54,
        40, 41, 42, 42,
        43, 44, 45, 45,
        49, 50, 51, 51,
        46, 47, 48, 48,
    ]
    return np.asarray(left + right, np.int64)
