"""Keypoints and person-mask CLI (port of
``soar_tpu.preproc.compute_kp_and_mask``).

    python -m soar_tpu_torch.preproc.compute_kp_and_mask --data-dir DIR \
        [--openpose-dir OPENPOSE] [--mask-backend sam|alpha|bbox] \
        [--sam-checkpoint-path sam_vit_h_4b8939.pth] [--device cuda]

Stage 1: the OpenPose binary (body, hand and face JSON), an external tool
run as a subprocess when ``--openpose-dir`` is given (skipped when every
frame has its keypoints).  Stage 2: a person mask per frame, prompted by
the body keypoints of confidence above 0.5, then cleaned (5x5 open and
close, largest 8-connected component).  Backends:

- ``sam``: SAM ViT-H (:mod:`soar_tpu_torch.preproc.sam`) on the device,
  from the user's ``sam_vit_h_4b8939.pth``;
- ``alpha``: the frames' own alpha channel;
- ``bbox``: GrabCut seeded by the keypoint bbox, which needs OpenCV; it is
  loaded by name only for this backend, and without it the command exits
  and names the other two.
"""

from __future__ import annotations

import argparse
import importlib
import os
import os.path as osp
import subprocess
import time
from glob import glob

import numpy as np
from scipy import ndimage

from ..io.png import read_png
from ..train.evaluate import save_png

_SQUARE5 = np.ones((5, 5), bool)


def largest_component(mask: np.ndarray) -> np.ndarray:
    """The largest 8-connected component of a bool mask.  A tie in area goes
    to the component OpenCV's ``connectedComponentsWithStats`` labels first:
    its block-based scan numbers components by the first 2x2 block (in
    raster order of blocks) that holds one of their pixels."""
    labels, n = ndimage.label(mask, structure=np.ones((3, 3), bool))
    if n == 0:
        return mask
    rows, cols = np.nonzero(labels)
    lab = labels[rows, cols] - 1
    area = np.bincount(lab, minlength=n)
    block = (rows // 2) * ((mask.shape[1] + 1) // 2) + cols // 2
    first = np.full(n, np.iinfo(np.int64).max)
    np.minimum.at(first, lab, block)
    order = np.argsort(first)  # OpenCV's label order
    return labels == order[np.argmax(area[order])] + 1


def cleanup_mask(mask_u8: np.ndarray) -> np.ndarray:
    """5x5 morphological open, then close, then the largest component, as
    OpenCV computes them: its morphology treats the outside of the image as
    neutral (255 for an erosion, 0 for a dilation), so a blob that touches
    the border is not eaten away."""
    m = mask_u8 > 0
    m = ndimage.binary_erosion(m, _SQUARE5, border_value=1)
    m = ndimage.binary_dilation(m, _SQUARE5, border_value=0)
    m = ndimage.binary_dilation(m, _SQUARE5, border_value=0)
    m = ndimage.binary_erosion(m, _SQUARE5, border_value=1)
    return largest_component(m)


def _opencv(backend: str):
    try:
        return importlib.import_module("cv2")
    except ImportError:
        raise SystemExit(f"--mask-backend {backend} needs OpenCV (GrabCut), which is not "
                         "installed; use --mask-backend sam (with --sam-checkpoint-path) or "
                         "--mask-backend alpha (RGBA frames)") from None


def grabcut_from_kps(cv2, img_bgr: np.ndarray, kps: np.ndarray) -> np.ndarray:
    """GrabCut seeded by the keypoint bbox, the no-SAM fallback."""
    conf = kps[kps[:, 2] > 0.5, :2]
    if len(conf) < 4:
        return np.zeros(img_bgr.shape[:2], bool)
    x0, y0 = np.maximum(conf.min(0) - 30, 0).astype(int)
    x1, y1 = conf.max(0) + 30
    x1 = min(int(x1), img_bgr.shape[1] - 1)
    y1 = min(int(y1), img_bgr.shape[0] - 1)
    mask = np.zeros(img_bgr.shape[:2], np.uint8)
    bgd, fgd = np.zeros((1, 65), np.float64), np.zeros((1, 65), np.float64)
    rect = (int(x0), int(y0), int(x1 - x0), int(y1 - y0))
    cv2.grabCut(img_bgr, mask, rect, bgd, fgd, 3, cv2.GC_INIT_WITH_RECT)
    return np.isin(mask, (cv2.GC_FGD, cv2.GC_PR_FGD))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--openpose-dir", default=None)
    ap.add_argument("--mask-backend", default="bbox", choices=["sam", "alpha", "bbox"])
    ap.add_argument("--sam-checkpoint-path", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    img_dir = osp.join(args.data_dir, "images")
    kp_dir = osp.join(args.data_dir, "keypoints")
    mask_dir = osp.join(args.data_dir, "masks")
    img_paths = sorted(glob(osp.join(img_dir, "*.png")))

    have_kps = osp.exists(kp_dir) and len(glob(osp.join(kp_dir, "*.json"))) >= len(img_paths)
    if have_kps:
        print("Keypoints already computed.")
    elif args.openpose_dir:
        os.makedirs(kp_dir, exist_ok=True)
        cmd = [
            "./build/examples/openpose/openpose.bin",
            "--image_dir", osp.abspath(img_dir),
            "--write_json", osp.abspath(kp_dir),
            "--write_images", osp.abspath(kp_dir),
            "--display", "0", "--hand", "--face",
        ]
        print("Running command:", subprocess.list2cmdline(cmd))
        subprocess.run(cmd, cwd=args.openpose_dir, check=True)
    else:
        raise SystemExit(
            "no keypoints found and --openpose-dir not given: OpenPose is an external "
            "binary the reference also shells out to")

    if osp.exists(mask_dir) and len(os.listdir(mask_dir)) >= len(img_paths):
        print("Masks already computed.")
        return
    cv2 = _opencv(args.mask_backend) if args.mask_backend == "bbox" else None
    os.makedirs(mask_dir, exist_ok=True)

    from .keypoints import load_keypoints

    keypoints = load_keypoints(kp_dir)
    predictor = None
    if args.mask_backend == "sam":
        from .sam import load_sam_predictor

        predictor = load_sam_predictor(args.sam_checkpoint_path, device=args.device)

    t0 = time.perf_counter()
    for i, img_path in enumerate(img_paths):
        img = read_png(img_path)
        kps = keypoints[i][:25]
        if args.mask_backend == "alpha":
            if img.ndim != 3 or img.shape[-1] != 4:
                raise SystemExit("--mask-backend alpha needs RGBA frames")
            mask = img[..., 3] > 0
        elif args.mask_backend == "sam":
            raw = predictor(img[..., :3], kps[kps[:, 2] > 0.5, :2])
            mask = cleanup_mask(raw.astype(np.uint8) * 255)
        else:
            bgr = np.ascontiguousarray(img[..., 2::-1])
            mask = cleanup_mask(grabcut_from_kps(cv2, bgr, kps).astype(np.uint8) * 255)
        save_png(osp.join(mask_dir, f"{i:05d}.png"), mask.astype(np.float32))
    print(f"wrote {len(img_paths)} masks ({args.mask_backend}) in "
          f"{time.perf_counter() - t0:.3f} s")


if __name__ == "__main__":
    main()
