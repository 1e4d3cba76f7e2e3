"""Frame extraction CLI (port of ``soar_tpu.preproc.extract_frames``).

    python -m soar_tpu_torch.preproc.extract_frames --video-path VIDEO \
        --data-root ROOT [--height H] [--skip-time N] [--start-time T] [--end-time T]

Runs the ffmpeg binary with the reference's filter chain (every
skip-time'th frame, scaled to height, vfr).  Without ffmpeg it decodes with
OpenCV, loaded by name only then and only when installed; with neither
the command exits.  Output: ``<data-root>/<seq>/images/%05d.png`` and a
``video.mp4`` symlink; a sequence whose frames exist is skipped.
"""

from __future__ import annotations

import argparse
import importlib
import os
import os.path as osp
import shutil
import subprocess


def _hms_to_sec(s: str) -> float:
    parts = [float(p) for p in s.split(":")]
    return sum(p * 60**i for i, p in enumerate(reversed(parts)))


def extract_with_cv2(video_path, img_dir, height, skip_time, start_time, end_time):
    """Decode with OpenCV: every ``skip_time``'th frame from ``start_time``
    to ``end_time``, resized to ``height`` (area interpolation)."""
    try:
        cv2 = importlib.import_module("cv2")
    except ImportError:
        raise SystemExit("extract_frames needs the ffmpeg binary or OpenCV; neither is "
                         "installed") from None
    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {video_path}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    start_f = int(_hms_to_sec(start_time) * fps)
    end_f = int(_hms_to_sec(end_time) * fps) if end_time else None
    n_out = 0
    i = 0
    while True:
        ok, frame = cap.read()
        if not ok or (end_f is not None and i >= end_f):
            break
        if i >= start_f and (i - start_f) % max(skip_time, 1) == 0:
            if height > 0 and frame.shape[0] != height:
                w = int(round(frame.shape[1] * height / frame.shape[0]))
                frame = cv2.resize(frame, (w, height), interpolation=cv2.INTER_AREA)
            cv2.imwrite(osp.join(img_dir, f"{n_out:05d}.png"), frame)
            n_out += 1
        i += 1
    cap.release()
    return n_out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--video-path", required=True)
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--height", type=int, default=-1)
    ap.add_argument("--skip-time", type=int, default=1)
    ap.add_argument("--start-time", default="00:00:00")
    ap.add_argument("--end-time", default=None)
    args = ap.parse_args(argv)

    seq = osp.splitext(osp.basename(args.video_path))[0]
    img_dir = osp.join(args.data_root, seq, "images")
    if osp.exists(img_dir) and len(os.listdir(img_dir)) > 0:
        print("Frames already extracted.")
        return
    os.makedirs(img_dir, exist_ok=True)

    if shutil.which("ffmpeg"):
        cmd = [
            "ffmpeg", "-i", args.video_path,
            "-vf", f"select='not(mod(n,{args.skip_time}))',scale=-1:{args.height}",
            "-fps_mode", "vfr", "-start_number", "0", "-ss", args.start_time,
        ]
        if args.end_time:
            cmd += ["-to", args.end_time]
        cmd.append(osp.join(img_dir, "%05d.png"))
        print("Running command:", subprocess.list2cmdline(cmd))
        subprocess.run(cmd, check=True)
    else:
        n = extract_with_cv2(args.video_path, img_dir, args.height, args.skip_time,
                             args.start_time, args.end_time)
        print(f"extracted {n} frames via cv2 (no ffmpeg binary)")

    link = osp.join(args.data_root, seq, "video.mp4")
    if not osp.exists(link):
        os.symlink(osp.abspath(args.video_path), link)


if __name__ == "__main__":
    main()
