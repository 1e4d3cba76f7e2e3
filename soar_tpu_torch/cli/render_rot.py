"""Standalone inference: avatar -> 360° turntable renders (port of
``soar_tpu.cli.render_rot``).

Each of ``num_views`` azimuth steps composes the first frame's global
orientation with a rotation about y (``global_orient_i = R_0 @
Ry(2*pi*i/n)``), renders rgb / normal / occ / mask through the frame-0
camera and writes pngs.

    python -m soar_tpu_torch.cli.render_rot --dataroot D --smpl-model M \
        [--num-subdiv 2] --ckpt outputs/run/stage1 --out outputs/run/rot
    python -m soar_tpu_torch.cli.render_rot --synthetic --num-views 4
    python -m soar_tpu_torch.cli.render_rot --synthetic --ckpt outputs/run/stage1
    python -m soar_tpu_torch.cli.render_rot --dataroot D --smpl-model M --ckpt reference.ckpt

``--dataroot`` rebuilds the capture's avatar as ``cli.train --dataroot``
does (``cli.common.real_setup``, undistilled; ``--num-subdiv`` must be the
training run's) and renders at the capture's own size.  ``--synthetic``
renders the procedural fixture (no downloads): without ``--ckpt`` the
fixture's own avatar, with ``--ckpt`` the synthetic avatar the trainer
starts from.  A checkpoint directory written by ``cli.train`` is loaded
into the rebuilt avatar and rendered through the field, as the JAX
package's CLI does for its own checkpoints; without ``--ckpt`` a capture's
avatar renders its explicit attributes.  A reference Lightning ``.ckpt``
gives the explicit surfel tensors by name and, unless ``--use-explicit``,
its attribute field, evaluated once at the canonical points (they do not
move at inference) for every view; a checkpoint without a field renders
the explicit attributes, with a warning.
"""

from __future__ import annotations

import argparse
import os


def gt_camera(ds, frame_idx: int, device):
    """The GT RGB camera of a frame, built as ``soar_tpu.train.trainer.
    make_gt_batch`` builds ``gt_cam``: principal point via ``prcppoint``,
    projection without cxcy, znear 0.1, zfar 100."""
    import torch

    from ..core.camera import camera_from_c2w

    H, W = ds.image_size
    fov = ds.frame_fovs(frame_idx)
    c2w = torch.as_tensor(ds.gt_c2w(frame_idx), dtype=torch.float32, device=device)
    return camera_from_c2w(
        c2w,
        fov["fovx"],
        fov["fovy"],
        znear=0.1,
        zfar=100.0,
        prcppoint=torch.tensor(
            [fov["cx"] / W, fov["cy"] / H], dtype=torch.float32, device=device
        ),
    )


def run_turntable(out_dir, ds, params, model, use_explicit, num_views=36,
                  attrs=None, device="cuda"):
    """Render and save the turntable; ``params`` / ``model`` must live on
    ``device``.  Returns the per-view output dicts (tensors on ``device``)."""
    import numpy as np
    import torch

    from .. import resolve_device
    from ..avatar.renderer import RenderSettings, render_view
    from ..core.transforms import batch_rodrigues, rotmat_to_rotvec
    from ..train.evaluate import save_png

    dev = resolve_device(device)
    if params.xyz.device.type != dev.type:
        raise ValueError(f"params live on {params.xyz.device}, not {dev}")
    os.makedirs(out_dir, exist_ok=True)
    settings = RenderSettings(use_explicit=use_explicit)
    H, W = ds.image_size
    cam = gt_camera(ds, 0, dev)

    go0 = torch.as_tensor(
        np.asarray(ds.smpl_params["global_orient"][0], np.float32), device=dev
    ).reshape(1, 3)
    R0 = batch_rodrigues(go0)[0]
    bg = torch.ones(3, device=dev)

    outs = []
    with torch.no_grad():
        for i in range(num_views):
            angle = 2.0 * np.pi * i / num_views
            c, s = np.cos(angle), np.sin(angle)
            Ry = torch.as_tensor(
                np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32), device=dev
            )
            R = R0 @ Ry
            out = render_view(
                params, model, cam, (H, W), bg, 0, settings, attrs=attrs,
                smpl_override={"global_orient": rotmat_to_rotvec(R)},
            )
            outs.append(out)
            frame = {
                "rgb": out["render"].cpu().numpy(),
                "normal": out["normal"].cpu().numpy(),
                "occ": out["occ"].cpu().numpy(),
                "mask": out["mask"].cpu().numpy()[..., None].repeat(3, -1),
            }
            for name, img in frame.items():
                save_png(os.path.join(out_dir, f"{name}_{i:03d}.png"), img)
    print(f"wrote {num_views} views to {out_dir}")
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataroot", type=str, default=None)
    ap.add_argument("--smpl-model", type=str, default=None)
    ap.add_argument("--num-subdiv", type=int, default=2)
    ap.add_argument("--synthetic", action="store_true",
                    help="render the procedural fixture")
    ap.add_argument("--out", type=str, default="outputs/rot")
    ap.add_argument("--num-views", type=int, default=36)
    ap.add_argument("--use-explicit", action="store_true",
                    help="explicit per-surfel colors/scales (the synthetic "
                         "fixture always renders explicit, as in soar_tpu)")
    ap.add_argument("--ckpt", type=str, default=None,
                    help="checkpoint directory written by soar_tpu_torch.cli.train "
                         "(e.g. <out>/stage1), or a reference Lightning .ckpt")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if not args.synthetic and not (args.dataroot and args.smpl_model):
        ap.error("--dataroot and --smpl-model required (or --synthetic)")

    if args.synthetic and not args.ckpt:
        from ..data.dataset import make_synthetic_sequence

        ds, (params, model) = make_synthetic_sequence(
            num_frames=8, image_size=(128, 128), device=args.device
        )
        run_turntable(args.out, ds, params, model, True, args.num_views,
                      device=args.device)
        return

    from ..io.checkpoint import load_avatar
    from .common import real_setup, synthetic_setup

    # The avatar constructions shared with cli.train: they must match it or
    # checkpoints stop round-tripping.
    if args.synthetic:
        ds, params, model = synthetic_setup(distill_steps=0, device=args.device)
    else:
        ds, params, model = real_setup(args.dataroot, args.smpl_model,
                                       num_subdiv=args.num_subdiv, distill_steps=0,
                                       device=args.device)
    attrs = None
    force_explicit = False
    if args.ckpt and args.ckpt.endswith(".ckpt"):
        import torch

        from ..field.reference_import import reference_field_apply
        from ..io.checkpoint import (
            apply_reference_tensors,
            import_reference_ckpt,
            import_reference_field_from_ckpt,
            load_reference_state_dict,
        )

        ref_sd = load_reference_state_dict(args.ckpt)
        apply_reference_tensors(params, import_reference_ckpt(args.ckpt, like=params,
                                                              state_dict=ref_sd))
        if not args.use_explicit:
            rf = import_reference_field_from_ckpt(args.ckpt, state_dict=ref_sd,
                                                  device=args.device)
            if rf is not None:
                with torch.no_grad():
                    attrs = reference_field_apply(rf, params.xyz)
                print(f"imported reference attribute field ({'tcnn' if rf.tcnn else 'torch'} "
                      "layout)")
            else:
                print("[warn] reference ckpt has no attribute field; rendering with explicit "
                      "params")
                force_explicit = True
    elif args.ckpt:
        params, step = load_avatar(args.ckpt, params)
        print(f"loaded {args.ckpt} (step {step})")
    run_turntable(args.out, ds, params, model,
                  args.use_explicit or force_explicit or args.ckpt is None,
                  args.num_views, attrs=attrs, device=args.device)


if __name__ == "__main__":
    main()
