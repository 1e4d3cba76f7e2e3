"""SMPL-X fitting CLI (port of ``soar_tpu.preproc.compute_smplx``).

    python -m soar_tpu_torch.preproc.compute_smplx --data-dir DIR \
        --smpl-model SMPLX_NEUTRAL.npz [--smplerx-dir SMPLer-X] [--device cuda]

Stage 1: SMPLer-X inference, an external model run as a subprocess in its
own environment when ``--smplerx-dir`` is given (skipped when its per-frame
results ``smplx/smplx/*_0.npz`` exist).  Stage 2: SMPLify keypoint
refinement (:mod:`soar_tpu_torch.preproc.smplify`) against the OpenPose
keypoints.  Writes ``smplx/params.pth`` in the reference layout with
``torch.save``: betas, poses ([F, J, 3] for body and hands), transl, Ks,
w2c and img_wh.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import subprocess
from glob import glob

import numpy as np
import torch

from .. import resolve_device

SMPLERX_KEYS = ("betas", "global_orient", "body_pose", "left_hand_pose", "right_hand_pose",
                "jaw_pose", "leye_pose", "reye_pose", "expression", "transl")


def load_smplerx_results(result_dir: str) -> dict:
    """SMPLer-X's per-frame ``*_0.npz`` results, each key stacked to
    [F, n] float32."""
    data = [np.load(p) for p in sorted(glob(osp.join(result_dir, "*_0.npz")))]
    return {k: np.concatenate([np.asarray(d[k], np.float32).reshape(1, -1) for d in data], 0)
            for k in SMPLERX_KEYS}


def load_K(smplx_dir: str, i: int) -> np.ndarray:
    """Frame ``i``'s intrinsics from SMPLer-X's ``meta/{i:05d}_0.json``."""
    with open(osp.join(smplx_dir, f"meta/{i:05d}_0.json")) as f:
        data = json.load(f)
    K = np.eye(3, dtype=np.float32)
    K[0, 0], K[1, 1] = data["focal"]
    K[0, 2], K[1, 2] = data["princpt"]
    return K


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--smplerx-dir", default=None)
    ap.add_argument("--smpl-model", required=True, help="SMPLX_*.npz path")
    ap.add_argument("--preserve-weight", type=float, default=60.0)
    ap.add_argument("--smooth-weight", type=float, default=10000.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    img_dir = osp.join(args.data_dir, "images")
    kp_dir = osp.join(args.data_dir, "keypoints")
    smplx_dir = osp.join(args.data_dir, "smplx")
    smplerx_result_dir = osp.join(smplx_dir, "smplx")
    img_paths = sorted(glob(osp.join(img_dir, "*.png")))
    N = len(img_paths)

    n_results = len(glob(osp.join(smplerx_result_dir, "*_0.npz")))
    if osp.exists(smplerx_result_dir) and N == n_results:
        print("SMPLER-X already computed.")
    elif args.smplerx_dir:
        cmd = [
            "python", "inference.py", "--num_gpus", "1",
            "--pretrained_model", "smpler_x_h32",
            "--agora_benchmark", "agora_model",
            "--img_path", osp.abspath(img_dir),
            "--output_folder", osp.abspath(smplx_dir),
            "--show_verts", "--show_bbox",
        ]
        print("Running command:", subprocess.list2cmdline(cmd))
        subprocess.run(cmd, cwd=osp.join(args.smplerx_dir, "main"), check=True)
    else:
        raise SystemExit(
            "no SMPLer-X results and --smplerx-dir not given: SMPLer-X is an "
            "external model the reference also shells out to")

    if osp.exists(osp.join(smplx_dir, "params.pth")):
        print("SMPL-X already optimized.")
        return

    from ..body.model import load_smplx_npz
    from ..io.png import read_png
    from .keypoints import load_keypoints
    from .smplify import SMPLify, SMPLifyConfig, smplx_to_openpose25, smplx_to_openpose_hands

    dev = resolve_device(args.device)
    body = load_smplx_npz(args.smpl_model, device=dev)
    init = load_smplerx_results(smplerx_result_dir)
    Ks = np.stack([load_K(smplx_dir, i) for i in range(N)])
    w2c = np.eye(4, dtype=np.float32)
    h, w = read_png(img_paths[0]).shape[:2]
    img_wh = (w, h)

    keypoints = load_keypoints(kp_dir)
    keypoints[..., :2] /= np.asarray(img_wh, np.float32)
    cfg = SMPLifyConfig(preserve_weight=args.preserve_weight, smooth_weight=args.smooth_weight)
    if body.lmk_faces_idx is not None:
        # The full mapping: all 137 OpenPose columns against the 144-joint
        # output; stage 1 zeroes the hand confidences.
        target = keypoints
        fitter = SMPLify(body, cfg=cfg, hand_kp_slice=(25, 67), openpose137=True)
    else:
        # Bodies without landmark tables: the body-25 and hand-21 blocks
        # on kinematic joints.
        target = keypoints[:, :67]
        fitter = SMPLify(body, np.concatenate([smplx_to_openpose25(), smplx_to_openpose_hands()]),
                         cfg, hand_kp_slice=(25, 67))
    fitted = fitter.fit({k: torch.from_numpy(v) for k, v in init.items()}, torch.from_numpy(Ks),
                        torch.from_numpy(w2c), target, img_wh)
    for stage, hist in zip(("body", "body+hands"), fitter.history):
        vals = hist["values"]
        print(f"[compute_smplx] SMPLify {stage}: {len(vals)} steps, {hist['seconds']:.3f} s, "
              f"{sum(hist['evaluations'])} function evaluations"
              + (f", loss {vals[0]:.6g} -> {vals[-1]:.6g}" if vals else ""))

    out = {k: v.contiguous().cpu() for k, v in fitted.items()}
    # The reference stores body and hand poses as [F, J, 3].
    for k, j in (("body_pose", 21), ("left_hand_pose", 15), ("right_hand_pose", 15)):
        out[k] = out[k].reshape(N, j, 3)
    out.update({"Ks": torch.from_numpy(Ks), "w2c": torch.from_numpy(w2c), "img_wh": img_wh})
    os.makedirs(smplx_dir, exist_ok=True)
    torch.save(out, osp.join(smplx_dir, "params.pth"))
    print(f"wrote {osp.join(smplx_dir, 'params.pth')}")


if __name__ == "__main__":
    main()
