"""Mesh export CLI (port of ``soar_tpu.cli.export_mesh``): checkpoint ->
density field -> isosurface -> cleaned/decimated OBJ.

    python -m soar_tpu_torch.cli.export_mesh --ckpt outputs/run/stage1 \
        --dataroot D --smpl-model M [--num-subdiv 2] --out mesh.obj
    python -m soar_tpu_torch.cli.export_mesh --synthetic \
        --ckpt outputs/run/stage1 --out mesh.obj [--device cpu]

The flags and defaults are the JAX CLI's, plus ``--device``.  The avatar is
rebuilt through the same ``cli.common`` helpers as ``cli.train`` /
``cli.render_rot`` (``real_setup`` for a capture, ``synthetic_setup`` for
the procedural fixture), so a checkpoint either of those produced restores
here with matching shapes; ``--num-subdiv`` must be the training run's.
``--ckpt`` takes a checkpoint directory written by this package.  The
density field runs on ``--device``; the isosurface, cleaning and
decimation run in numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--dataroot", default=None)
    ap.add_argument("--smpl-model", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--num-subdiv", type=int, default=2,
                    help="must match the value the checkpoint was trained "
                    "with (surfel count is part of the checkpoint's shape)")
    ap.add_argument("--out", default="mesh.obj")
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--density-thresh", type=float, default=0.8)
    ap.add_argument("--decimate-target", type=int, default=100000)
    ap.add_argument(
        "--field-attrs", action="store_true",
        help="build the density from the trained attribute field's "
        "scales/opacities instead of the explicit logits.  The default "
        "matches the reference's extract_fields (get_scaling/get_opacity, "
        "``gaussian_io.py:184-191``) — which for a field-driven SOAR run "
        "reads INIT-time values, since its renderer takes scales from the "
        "field and forces opacity to 1; pass this flag to export what the "
        "trained avatar actually renders",
    )
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if not args.synthetic and not (args.dataroot and args.smpl_model):
        ap.error("--dataroot and --smpl-model required (or --synthetic)")
    if args.ckpt and args.ckpt.endswith(".ckpt"):
        ap.error("importing a reference .ckpt is not ported yet")

    import torch

    from ..io.checkpoint import load_avatar
    from ..io.meshing import extract_mesh, write_obj
    from .common import real_setup, synthetic_setup

    if args.synthetic:
        _, params, model = synthetic_setup(distill_steps=0, device=args.device)
    else:
        _, params, model = real_setup(args.dataroot, args.smpl_model,
                                      num_subdiv=args.num_subdiv, distill_steps=0,
                                      device=args.device)
    if args.ckpt:
        params, _ = load_avatar(args.ckpt, params)

    scales = opacities = None
    if args.field_attrs:
        from ..avatar.renderer import query_attributes

        with torch.no_grad():
            attrs = query_attributes(params, model)
        scales = attrs["scales"]
        opacities = attrs["opacities"][:, 0]

    timings = {}
    verts, faces = extract_mesh(
        params,
        density_thresh=args.density_thresh,
        resolution=args.resolution,
        decimate_target=args.decimate_target,
        scales=scales,
        opacities=opacities,
        timings=timings,
    )
    write_obj(args.out, verts, faces)
    print(f"wrote {args.out}: {len(verts)} verts, {len(faces)} faces "
          f"(density field {timings['density_field_s']:.3f} s on {params.xyz.device}, "
          f"isosurface, cleaning and decimation {timings['host_s']:.3f} s on the host)")
    return {"verts": len(verts), "faces": len(faces), **timings}


if __name__ == "__main__":
    main()
