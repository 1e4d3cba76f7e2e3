"""Write a capture on disk in the layout :func:`soar_tpu_torch.data.dataset.
load_sequence` reads, made from the procedural test body (a torch-only
port of ``scripts/make_mock_capture.py``, which needs JAX and OpenCV).

    python -m soar_tpu_torch.data.mock_capture --out DIR --frames 20 --size 512 \
        --joints 10 --segments 7 --ring 28 [--subdiv 1] [--blob] [--device cuda]

Writes ``images/*.png`` (RGB), ``masks/*.png`` (gray), ``normal_F/*.png``
and ``normal_B/*.png`` (RGBA, the mask in alpha) through
:func:`soar_tpu_torch.train.evaluate.save_png`, and ``smplx/params.pth``
through ``torch.save``.  The default mode renders the ground truth from the
posed body itself, so every GT loss of a training run on the capture can
descend: the avatar is posed per frame in the loader's own GT camera (the
``w2c`` row flip included; the z sign of ``transl`` that puts the body in
view is found by rendering coverage at both signs), coloured by position,
and rendered front and back with a per-tile capacity above every tile's
splat count (``--gt-k``), which is checked per frame on the overflow
counters.  ``--blob`` paints an ellipse the body cannot reach instead
(layout-only data).  The same command with ``python -m`` runs on the
card (``--device cuda``, the default) or the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..train.evaluate import _to_u8, save_png

SUBDIRS = ("images", "masks", "normal_F", "normal_B", "smplx")


def _write_png(path: str, u8: np.ndarray, written: Optional[Dict[str, np.ndarray]]):
    """Write the uint8 image ``u8``: ``save_png`` truncates ``x * 255``, so
    it is given the levels' midpoints.  ``written[path]`` keeps the uint8
    image ``save_png`` makes of what it was given."""
    img = (u8.astype(np.float32) + 0.5) / 255.0
    save_png(path, img)
    if written is not None:
        written[path] = _to_u8(img)


def _round_u8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(x) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_params(out: str, sp: Dict[str, np.ndarray], K: np.ndarray, S: int):
    F = len(sp["transl"])
    params = {
        "betas": torch.from_numpy(sp["betas"]),
        "body_pose": torch.from_numpy(sp["body_pose"]),
        "global_orient": torch.from_numpy(sp["global_orient"]),
        "transl": torch.from_numpy(sp["transl"]),
        "w2c": torch.from_numpy(np.eye(4, dtype=np.float32)),
        "Ks": torch.from_numpy(np.tile(K[None], (F, 1, 1))),
        "normal_Ks": torch.from_numpy(np.tile(K[None], (F, 1, 1))),
        "img_wh": torch.tensor([S, S]),
    }
    torch.save(params, os.path.join(out, "smplx", "params.pth"))


def write_blob_frames(out: str, F: int, S: int, written=None):
    """The painted-ellipse GT: only the layout is meaningful."""
    yy, xx = np.mgrid[0:S, 0:S].astype(np.float32)
    for i in range(F):
        cx = S / 2 + 30 * np.sin(2 * np.pi * i / F)
        cy = S / 2
        r = (xx - cx) ** 2 / (S * 0.18) ** 2 + (yy - cy) ** 2 / (S * 0.38) ** 2
        mask = (r < 1.0).astype(np.uint8) * 255
        img = np.stack([(0.5 + 0.5 * np.sin(xx / 37 + i)) * 255,
                        (0.5 + 0.5 * np.cos(yy / 29)) * 255,
                        np.full_like(xx, 140.0)], -1).astype(np.uint8)
        img[mask == 0] = 0
        _write_png(os.path.join(out, f"images/{i:05d}.png"), img, written)
        _write_png(os.path.join(out, f"masks/{i:05d}.png"), mask, written)
        nrm = np.stack([np.full_like(xx, 127.0), np.full_like(xx, 127.0),
                        np.full_like(xx, 255.0), mask.astype(np.float32)], -1).astype(np.uint8)
        for sub in ("normal_F", "normal_B"):
            _write_png(os.path.join(out, f"{sub}/{i:05d}.png"), nrm, written)


def make_capture(
    out: str,
    frames: int = 20,
    size: int = 512,
    joints: int = 10,
    segments: int = 7,
    ring: int = 28,
    subdiv: int = 1,
    gt_scale_mult: float = 1.5,
    gt_k: int = 512,
    seed: int = 0,
    blob: bool = False,
    fill: float = 0.75,
    device="cuda",
    written: Optional[Dict[str, np.ndarray]] = None,
) -> Dict:
    """Write the capture under ``out``; returns a summary (coverage per
    frame, the chosen z of ``transl``, seconds).  ``written``, when given,
    receives path -> uint8 image of every PNG written."""
    from .. import resolve_device
    from ..avatar.renderer import RenderSettings, render_view
    from ..avatar.state import init_avatar
    from ..body.model import make_test_body
    from ..train.trainer import make_gt_batch
    from .dataset import load_sequence

    t0 = time.perf_counter()
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    F, S = frames, size
    for sub in SUBDIRS:
        os.makedirs(os.path.join(out, sub), exist_ok=True)

    body = make_test_body(joints, segments, ring, device=dev)
    v = body.v_template.cpu().numpy()
    y0, y1 = float(v[:, 1].min()), float(v[:, 1].max())
    focal = 1.1 * S
    dist = focal * (y1 - y0) / (fill * S)
    sp = {
        "betas": np.zeros((1, body.num_betas), np.float32),
        "body_pose": (rng.randn(F, (body.num_joints - 1) * 3) * 0.05).astype(np.float32),
        "global_orient": np.zeros((F, 3), np.float32),
        # The z sign is chosen by rendering below: the loader's w2c flip
        # decides which half-space the GT camera sees.
        "transl": np.tile([[0.0, -(y0 + y1) / 2.0, -dist]], (F, 1)).astype(np.float32),
    }
    K = np.array([[focal, 0, S / 2], [0, focal, S / 2], [0, 0, 1]], np.float32)
    write_params(out, sp, K, S)
    if blob:
        write_blob_frames(out, F, S, written)
        return {"frames": F, "size": S, "blob": True, "seconds": time.perf_counter() - t0}

    # A placeholder frame, so load_sequence gives the training run's exact
    # GT camera (w2c flip included) before the frames exist.
    save_png(os.path.join(out, "images", "00000.png"), np.zeros((S, S, 3), np.float32))
    save_png(os.path.join(out, "masks", "00000.png"), np.zeros((S, S), np.float32))

    # A cheap probe avatar (no subdivision) picks the z sign of transl.
    probe_params, probe_model = init_avatar(body, sp, num_subdiv=0, distill_steps=0,
                                            seed=seed, device=dev)
    ds = load_sequence(out)
    cam = make_gt_batch(ds, probe_model, 0, device=dev)["gt_cam"]
    explicit = RenderSettings(use_explicit=True)
    bg = torch.zeros(3, device=dev)

    def coverage(tz):
        override = {k: torch.as_tensor(val[0] if k != "betas" else val, device=dev)
                    for k, val in sp.items()}
        override["transl"] = torch.tensor([0.0, -(y0 + y1) / 2.0, tz], device=dev)
        with torch.no_grad():
            o = render_view(probe_params, probe_model, cam, (S, S), bg, 0, explicit,
                            smpl_override=override)
        return float((o["mask"] > 0.5).float().mean())

    covs = {tz: coverage(tz) for tz in (-dist, dist)}
    tz = max(covs, key=covs.get)
    if covs[tz] < 0.01:
        raise SystemExit(f"GT camera sees no body at either z sign: {covs}")
    sp["transl"] = np.tile([[0.0, -(y0 + y1) / 2.0, tz]], (F, 1)).astype(np.float32)
    write_params(out, sp, K, S)

    # The GT avatar, coloured by position: a run on the capture starts from
    # a fresh init and must learn these colours.
    params, model = init_avatar(body, sp, num_subdiv=subdiv, distill_steps=0, seed=seed,
                                device=dev)
    xyz = params.xyz.detach().cpu().numpy()
    gt_colors = (np.tanh(xyz * 3.0) + 1.0) / 2.0
    with torch.no_grad():
        params.colors.copy_(torch.from_numpy(np.log(gt_colors / (1 - gt_colors + 1e-6) + 1e-6)))
    both = RenderSettings(
        use_explicit=True, both_faces=True,
        raster=dataclasses.replace(RenderSettings().raster, scale_modifier=gt_scale_mult,
                                   max_per_tile=gt_k, dup_side=3, fat_budget=0))

    covs_all = []
    for i in range(F):
        with torch.no_grad():
            front, back = render_view(params, model, cam, (S, S), bg, i, both)
        dropped, capped = (int(x) for x in front["overflow"].cpu())
        if dropped or capped:
            raise SystemExit(
                f"GT frame {i} is not an exact composite (dropped={dropped}, "
                f"capped={capped}); raise --gt-k, lower --subdiv or --gt-scale-mult")
        mask = (front["mask"].cpu().numpy() > 0.5).astype(np.uint8) * 255
        covs_all.append(float((mask > 0).mean()))
        rgb = front["render"].cpu().numpy() * (mask[..., None] > 0)
        _write_png(os.path.join(out, f"images/{i:05d}.png"), _round_u8(rgb), written)
        _write_png(os.path.join(out, f"masks/{i:05d}.png"), mask, written)
        for sub, o in (("normal_F", front), ("normal_B", back)):
            rgba = np.dstack([_round_u8(o["normal"].cpu().numpy()), mask])
            _write_png(os.path.join(out, f"{sub}/{i:05d}.png"), rgba, written)
    if min(covs_all) < 0.6 * covs[tz]:
        raise SystemExit(
            f"full-size GT coverage collapsed ({min(covs_all):.4f} vs probe {covs[tz]:.4f}): "
            "per-tile truncation punches holes; lower --subdiv or raise --gt-scale-mult")
    return {"frames": F, "size": S, "blob": False, "transl_z": tz, "probe_coverage": covs,
            "coverage": covs_all, "surfels": int(params.xyz.shape[0]),
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--joints", type=int, default=10)
    ap.add_argument("--segments", type=int, default=7)
    ap.add_argument("--ring", type=int, default=28)
    ap.add_argument("--subdiv", type=int, default=1,
                    help="GT avatar subdivision; the GT must render without truncation "
                    "(--gt-k above every tile's splat count, checked), which fails past 1 "
                    "for the procedural body")
    ap.add_argument("--gt-scale-mult", type=float, default=1.5,
                    help="scale_modifier of the GT renders (overlap keeps the silhouette "
                    "watertight)")
    ap.add_argument("--gt-k", type=int, default=512,
                    help="per-tile capacity of the GT renders")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--blob", action="store_true",
                    help="painted-ellipse GT the body cannot reach (layout-only data)")
    ap.add_argument("--fill", type=float, default=0.75,
                    help="body height as a fraction of the frame height")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    info = make_capture(args.out, args.frames, args.size, args.joints, args.segments,
                        args.ring, args.subdiv, args.gt_scale_mult, args.gt_k, args.seed,
                        args.blob, args.fill, args.device)
    if info["blob"]:
        print(f"wrote {info['frames']} blob frames @ {info['size']}px + smplx/params.pth "
              f"under {args.out}")
    else:
        print(f"wrote {info['frames']} rendered frames @ {info['size']}px (coverage "
              f"{min(info['coverage']):.3f}-{max(info['coverage']):.3f}, probe "
              f"{max(info['probe_coverage'].values()):.3f}, transl z {info['transl_z']:+.2f}) "
              f"+ smplx/params.pth under {args.out} in {info['seconds']:.1f}s")
    return info


if __name__ == "__main__":
    main()
