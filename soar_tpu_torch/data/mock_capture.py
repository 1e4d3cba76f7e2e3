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


def write_mesh_frames(out: str, body, sp: Dict[str, np.ndarray], K: np.ndarray, S: int,
                      gt_k: int, written=None):
    """Ground truth rendered from the posed mesh in the capture's camera
    (``w2c`` the identity, intrinsics ``K``): the image is the front normal
    map shaded, the mask the silhouette, the normal maps the front and far
    surfaces; each render is checked free of truncation.  Returns the
    coverage per frame."""
    from ..body.model import smplx_forward
    from ..render.mesh_raster import get_proj_mat, render_mesh

    dev = body.v_template.device
    with torch.no_grad():
        verts = smplx_forward(body, {k: torch.from_numpy(v).to(dev) for k, v in sp.items()}
                              ).vertices
    w2c = torch.eye(4, device=dev)
    proj_f = get_proj_mat(torch.from_numpy(K).to(dev), (S, S))
    proj_b = proj_f.clone()
    proj_b[2] *= -1.0
    covs = []
    for i in range(len(verts)):
        front, back = (render_mesh(verts[i], body.faces, w2c, p, (S, S), max_per_tile=gt_k,
                                   dup_side=16) for p in (proj_f, proj_b))
        for o in (front, back):
            if int(o["overflow"].sum()):
                raise SystemExit(f"mesh GT frame {i} is truncated (overflow "
                                 f"{o['overflow'].tolist()}); raise --gt-k")
        mask = (front["mask"][..., 0].cpu().numpy() > 0.5).astype(np.uint8) * 255
        covs.append(float((mask > 0).mean()))
        nf, nb = front["normal"].cpu().numpy(), back["normal"].cpu().numpy()
        _write_png(os.path.join(out, f"images/{i:05d}.png"),
                   _round_u8(nf * (mask[..., None] > 0)), written)
        _write_png(os.path.join(out, f"masks/{i:05d}.png"), mask, written)
        for sub, n in (("normal_F", nf), ("normal_B", nb)):
            _write_png(os.path.join(out, f"{sub}/{i:05d}.png"),
                       np.dstack([_round_u8(n), mask]), written)
    return covs


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
    body=None,
    mesh: bool = False,
) -> Dict:
    """Write the capture under ``out``; returns a summary (coverage per
    frame, the chosen z of ``transl``, seconds).  ``written``, when given,
    receives path -> uint8 image of every PNG written.  ``body``, when
    given, replaces ``make_test_body(joints, segments, ring)``.  ``mesh``
    renders the ground truth from the posed body's mesh
    (:func:`soar_tpu_torch.render.mesh_raster.render_mesh` with a per-tile
    capacity of ``gt_k``, checked exact) instead of its splat avatar: the
    masks are then the template's own silhouette, which preprocessing's
    template normals must reproduce."""
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

    if body is None:
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
    if mesh:
        covs_all = write_mesh_frames(out, body, sp, K, S, gt_k, written)
        if min(covs_all) < 0.6 * covs[tz]:
            raise SystemExit(f"mesh GT coverage {min(covs_all):.4f} against the splat probe's "
                             f"{covs[tz]:.4f}: the mesh camera is not the loader's")
        return {"frames": F, "size": S, "blob": False, "mesh": True, "transl_z": tz,
                "probe_coverage": covs, "coverage": covs_all,
                "seconds": time.perf_counter() - t0}

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


# The mock SMPL-X body's tube widening and the seed of its landmark tables.
MOCK_BODY_WIDTH, MOCK_BODY_SEED = 48.0, 3
# SMPLer-X's mock initialisation: the truth plus Gaussian noise of these
# standard deviations on the body pose (rad) and on ``transl``.
TOOL_POSE_NOISE, TOOL_TRANSL_NOISE = 0.1, 0.02


def mock_smplx_body(joints: int = 55, segments: int = 4, ring: int = 48, device="cuda"):
    """The procedural body dressed as an SMPL-X model, for preprocessing
    without the proprietary npz: ``make_test_body`` with its tube
    ``MOCK_BODY_WIDTH`` times as wide (x and z of the template).  The
    55-joint chain is 13.75 units tall and 0.12 wide: ~5 px in a 512²
    frame, its 21,120 faces packed some 300 to a 16x16 tile, where
    ``render_mesh``'s K = 64 keeps a third of the silhouette.  At 48 times
    that width, 5.76 units, the body covers ~20% of the frame, as a person
    does, and a tile holds ~60 faces, as SMPL-X's 20,908 spread over a
    person's crop.  Its shape directions are padded to 10 betas and 10
    expressions (zeros past its own 4), zero MANO hand means, SMPL-X's
    extra-joint vertex ids and landmark tables fabricated from
    ``MOCK_BODY_SEED`` (barycentric weights normalized, as
    ``scripts/bench_preproc.py`` makes them).  At 55 joints, 4 segments and
    a ring of 48 it has 10,608 vertices (SMPL-X: 10,475); a body with fewer
    vertices than SMPL-X's extra-joint ids reach gets its extra joints'
    vertices from the seed too, and :func:`save_smplx_npz` cannot carry
    them."""
    from .. import resolve_device
    from ..body.model import SMPLX_EXTRA_JOINT_VERTEX_IDS, make_test_body

    dev = resolve_device(device)
    body = make_test_body(joints, segments, ring, device=dev)
    V, Fc = body.num_verts, body.faces.shape[0]
    rng = np.random.RandomState(MOCK_BODY_SEED)
    bary = rng.rand(51, 3).astype(np.float32)
    bary /= bary.sum(-1, keepdims=True)
    dyn_bary = rng.rand(79, 17, 3).astype(np.float32)
    dyn_bary /= dyn_bary.sum(-1, keepdims=True)
    shapedirs = torch.zeros((V, 3, 20), device=dev)
    shapedirs[..., :body.num_betas] = body.shapedirs
    v_template = body.v_template * torch.tensor([MOCK_BODY_WIDTH, 1.0, MOCK_BODY_WIDTH],
                                                device=dev)
    extra = np.asarray(SMPLX_EXTRA_JOINT_VERTEX_IDS, np.int64)
    if V <= extra.max():  # a smaller body: vertex ids from the seed
        extra = rng.randint(0, V, len(extra)).astype(np.int64)

    def t(a):
        return torch.from_numpy(a).to(dev)

    return body._replace(
        v_template=v_template, shapedirs=shapedirs, num_betas=10,
        pose_mean=torch.zeros(joints * 3, device=dev), extra_joint_idxs=t(extra),
        lmk_faces_idx=t(rng.randint(0, Fc, 51).astype(np.int64)), lmk_bary_coords=t(bary),
        dyn_lmk_faces_idx=t(rng.randint(0, Fc, (79, 17)).astype(np.int64)),
        dyn_lmk_bary_coords=t(dyn_bary))


def smplx_segments(sp: Dict[str, np.ndarray], num_betas: int = 10,
                   num_expression: int = 10) -> Dict[str, np.ndarray]:
    """A capture's per-frame parameters (``body_pose`` covering the 54 joints
    after the root) split into SMPL-X's segments, betas and expression
    padded with zeros: the per-frame layout of SMPLer-X's results."""
    F = len(sp["transl"])
    bp = np.asarray(sp["body_pose"], np.float32).reshape(F, -1)
    cuts = {"body_pose": 21, "jaw_pose": 1, "leye_pose": 1, "reye_pose": 1,
            "left_hand_pose": 15, "right_hand_pose": 15}
    out, i = {}, 0
    for k, n in cuts.items():
        out[k] = bp[:, i * 3:(i + n) * 3].copy()
        i += n
    betas = np.zeros((F, num_betas), np.float32)
    b = np.asarray(sp["betas"], np.float32).reshape(-1, np.shape(sp["betas"])[-1])
    betas[:, :b.shape[-1]] = b
    out.update(betas=betas, expression=np.zeros((F, num_expression), np.float32),
               global_orient=np.asarray(sp["global_orient"], np.float32).reshape(F, 3),
               transl=np.asarray(sp["transl"], np.float32).reshape(F, 3))
    return out


def write_tool_outputs(out: str, body, params: Dict[str, np.ndarray], Ks: np.ndarray,
                       seed: int = 0) -> Dict[str, np.ndarray]:
    """What OpenPose and SMPLer-X would write for a capture, made from its
    own SMPL-X parameters ``params`` (SMPL-X segments per frame): the 137
    OpenPose columns of ``smplx_forward_full`` -> ``convert_kps_137``
    projected through each frame's K (the capture's ``w2c`` is the
    identity), with confidence 1 where the 137-column mask is valid, as
    ``keypoints/{i:05d}_keypoints.json``; the parameters perturbed from
    ``seed`` (``TOOL_POSE_NOISE`` rad of Gaussian noise on the body pose,
    ``TOOL_TRANSL_NOISE`` on ``transl``) as ``smplx/smplx/{i:05d}_0.npz``; and
    focal and principal point as ``smplx/meta/{i:05d}_0.json``.  Returns
    the perturbed parameters."""
    import json

    from ..body.model import smplx_forward_full
    from ..preproc.smplify import convert_kps_137, smplx_to_openpose137

    dev = body.v_template.device
    src, dst, mask = smplx_to_openpose137()
    with torch.no_grad():
        _, j144 = smplx_forward_full(body, {k: torch.from_numpy(v).to(dev)
                                            for k, v in params.items()})
        kps = convert_kps_137(j144, torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev))
    kps = kps.cpu().numpy().astype(np.float64)
    pix = np.einsum("fij,fkj->fki", Ks.astype(np.float64), kps)
    pix = pix[..., :2] / np.maximum(pix[..., 2:], 1e-5)
    rng = np.random.RandomState(seed)
    init = {k: v.copy() for k, v in params.items()}
    init["body_pose"] = (params["body_pose"] + TOOL_POSE_NOISE * rng.randn(*params["body_pose"].shape)
                         ).astype(np.float32)
    init["transl"] = (params["transl"] + TOOL_TRANSL_NOISE * rng.randn(*params["transl"].shape)
                      ).astype(np.float32)
    for sub in ("keypoints", "smplx/smplx", "smplx/meta"):
        os.makedirs(os.path.join(out, sub), exist_ok=True)
    blocks = (("pose_keypoints_2d", 0, 25), ("hand_left_keypoints_2d", 25, 46),
              ("hand_right_keypoints_2d", 46, 67), ("face_keypoints_2d", 67, 137))
    for i in range(len(pix)):
        cols = np.concatenate([pix[i], mask[:, None]], -1)
        person = {name: cols[a:b].reshape(-1).tolist() for name, a, b in blocks}
        with open(os.path.join(out, f"keypoints/{i:05d}_keypoints.json"), "w") as f:
            json.dump({"version": 1.3, "people": [person]}, f)
        np.savez(os.path.join(out, f"smplx/smplx/{i:05d}_0.npz"),
                 **{k: v[i] for k, v in init.items()})
        with open(os.path.join(out, f"smplx/meta/{i:05d}_0.json"), "w") as f:
            json.dump({"focal": [float(Ks[i, 0, 0]), float(Ks[i, 1, 1])],
                       "princpt": [float(Ks[i, 0, 2]), float(Ks[i, 1, 2])]}, f)
    return init


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
