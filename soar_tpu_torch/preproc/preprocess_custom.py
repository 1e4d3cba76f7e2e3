"""Preprocessing orchestrator (port of ``soar_tpu.preproc.preprocess_custom``):
frames -> keypoints and masks -> SMPL-X fit -> normal maps, each stage
skipped when its output exists.

    python -m soar_tpu_torch.preproc.preprocess_custom --video-path VIDEO \
        --data-root ROOT --smpl-model SMPLX_NEUTRAL.npz \
        [--openpose-dir OPENPOSE] [--smplerx-dir SMPLer-X] [--econ-ckpt normal.ckpt] \
        [--mask-backend sam|alpha|bbox] [--sam-checkpoint-path sam_vit_h_4b8939.pth] \
        [--device cuda]

``--device`` goes to every stage that computes (the masks' SAM, the SMPL-X
fit, the normal maps); ``cpu`` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import os.path as osp


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--video-path", required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--smpl-model", required=True)
    ap.add_argument("--openpose-dir", default=None)
    ap.add_argument("--smplerx-dir", default=None)
    ap.add_argument("--econ-ckpt", default=None)
    ap.add_argument("--height", type=int, default=-1)
    ap.add_argument("--skip-time", type=int, default=1)
    ap.add_argument("--start-time", default="00:00:00")
    ap.add_argument("--end-time", default=None)
    ap.add_argument("--mask-backend", default="bbox")
    ap.add_argument("--sam-checkpoint-path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from . import compute_kp_and_mask, compute_normal, compute_smplx, extract_frames

    extract_frames.main(
        ["--video-path", args.video_path, "--data-root", args.data_root,
         "--height", str(args.height), "--skip-time", str(args.skip_time),
         "--start-time", args.start_time]
        + (["--end-time", args.end_time] if args.end_time else []))

    seq = osp.splitext(osp.basename(args.video_path))[0]
    data_dir = osp.join(args.data_root, seq)
    dev = ["--device", args.device]

    kp_args = ["--data-dir", data_dir, "--mask-backend", args.mask_backend] + dev
    if args.openpose_dir:
        kp_args += ["--openpose-dir", args.openpose_dir]
    if args.sam_checkpoint_path:
        kp_args += ["--sam-checkpoint-path", args.sam_checkpoint_path]
    compute_kp_and_mask.main(kp_args)

    sx_args = ["--data-dir", data_dir, "--smpl-model", args.smpl_model] + dev
    if args.smplerx_dir:
        sx_args += ["--smplerx-dir", args.smplerx_dir]
    compute_smplx.main(sx_args)

    cn_args = ["--data-dir", data_dir, "--smpl-model", args.smpl_model] + dev
    if args.econ_ckpt:
        cn_args += ["--econ-ckpt", args.econ_ckpt]
    compute_normal.main(cn_args)


if __name__ == "__main__":
    main()
