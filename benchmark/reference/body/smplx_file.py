"""The reference's reader of a body in the official SMPL-X ``.npz`` layout,
written for the benchmark beside the frozen copies: a plain ``np.load``
into this package's :class:`~.model.BodyModel`, keeping what SMPL-X's
published loader keeps (the first ``num_betas`` of the 300 shape
directions, the first ``num_expression`` of the 100 expression directions,
the MANO hand means added to the hand joints' pose).  No landmark tables:
the views never read them."""

from __future__ import annotations

import numpy as np
import torch

from .model import BodyModel

NUM_SHAPE = 300
LEFT_HAND, RIGHT_HAND = slice(25 * 3, 40 * 3), slice(40 * 3, 55 * 3)


def load_smplx_npz(path: str, num_betas: int = 10, num_expression: int = 10,
                   device="cuda") -> BodyModel:
    with np.load(path) as data:
        d = {k: data[k] for k in data.files}
    shapedirs = np.concatenate([d["shapedirs"][..., :num_betas],
                                d["shapedirs"][..., NUM_SHAPE:NUM_SHAPE + num_expression]], -1)
    V, _, P = d["posedirs"].shape
    parents = [int(p) for p in d["kintree_table"][0]]
    parents[0] = -1
    J = len(parents)
    pose_mean = np.zeros(J * 3, np.float32)
    pose_mean[LEFT_HAND] = d["hands_meanl"]
    pose_mean[RIGHT_HAND] = d["hands_meanr"]

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    return BodyModel(
        v_template=t(d["v_template"]),
        shapedirs=t(shapedirs),
        posedirs=t(d["posedirs"].reshape(V * 3, P).T),
        J_regressor=t(d["J_regressor"]),
        lbs_weights=t(d["weights"]),
        parents=tuple(parents),
        faces=t(d["f"].astype(np.int64), torch.int64),
        num_betas=num_betas,
        pose_mean=t(pose_mean),
    )
