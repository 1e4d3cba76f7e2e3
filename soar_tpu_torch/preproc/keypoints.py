"""OpenPose keypoint JSON loading (port of ``soar_tpu.preproc.keypoints``)."""

from __future__ import annotations

import json
import os.path as osp
from glob import glob

import numpy as np


def load_keypoints(kp_dir: str) -> np.ndarray:
    """Stack pose + left/right hand + face keypoints of every ``*.json``
    (sorted) -> [F, 137, 3]; a frame where OpenPose found nobody gives a
    zero row (zero confidence), so every consumer weights it out."""
    keypoints = []
    for path in sorted(glob(osp.join(kp_dir, "*.json"))):
        with open(path) as f:
            data = json.load(f)
        if not data["people"]:
            keypoints.append(np.zeros((137, 3), np.float32))
            continue
        person = data["people"][0]
        keypoints.append(
            np.array(
                person["pose_keypoints_2d"]
                + person["hand_left_keypoints_2d"]
                + person["hand_right_keypoints_2d"]
                + person["face_keypoints_2d"],
                dtype=np.float32,
            ).reshape(-1, 3)
        )
    return np.stack(keypoints, axis=0)
