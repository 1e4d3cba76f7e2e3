"""Shared CLI helpers (port of ``soar_tpu.cli.common``).

``synthetic_setup`` and ``real_setup`` are the one definition of the
avatar each input builds, shared by ``cli.train``, ``cli.render_rot`` and
``cli.export_mesh``: body dims, field capacity, subdivision and frame count
are the checkpoint contract, so a checkpoint one tool wrote restores in the
others.
"""

from __future__ import annotations


def synthetic_setup(distill_steps: int = 0, seed: int = 0, device="cuda"):
    """Returns (ds, params, model) for the procedural demo sequence with the
    canonical synthetic avatar on ``device``; ``distill_steps`` > 0 distils
    its field (``cli.train --synthetic`` uses 100, as the JAX package's)."""
    from ..avatar.state import init_avatar
    from ..body.model import make_test_body
    from ..data.dataset import make_synthetic_sequence
    from ..field.attribute_field import AttributeFieldConfig
    from ..field.hashgrid import HashGridConfig

    ds, _ = make_synthetic_sequence(num_frames=8, image_size=(128, 128), device=device)
    body = make_test_body(num_joints=4, segments_per_bone=3, ring=8, device=device)
    field_cfg = AttributeFieldConfig(
        grid=HashGridConfig(num_levels=8, min_res=8, max_res=256, log2_hashmap_size=14)
    )
    params, model = init_avatar(
        body,
        ds.smpl_params,
        num_subdiv=1,
        field_cfg=field_cfg,
        seed=seed,
        distill_steps=distill_steps,
        device=device,
    )
    return ds, params, model


def load_body_model(smpl_model: str, device="cuda"):
    """The body by name: ``test:J,S,R`` builds the procedural test body (J
    joints, S segments per bone, R ring vertices; no download), a ``.pkl``
    is a legacy SMPL model, anything else an SMPL-X ``.npz``.  All three
    CLIs dispatch through here, so they accept the same model files."""
    from ..body.model import load_smpl_pkl, load_smplx_npz, make_test_body

    if smpl_model.startswith("test:"):
        j, s, r = (int(x) for x in smpl_model[5:].split(","))
        return make_test_body(num_joints=j, segments_per_bone=s, ring=r, device=device)
    if smpl_model.endswith(".pkl"):
        return load_smpl_pkl(smpl_model, device=device)
    return load_smplx_npz(smpl_model, device=device)


def real_setup(
    dataroot: str,
    smpl_model: str,
    num_subdiv: int = 2,
    seed: int = 0,
    distill_steps: int = 1000,
    device="cuda",
):
    """Returns (ds, params, model) for a capture on disk, with the avatar at
    full field size (``AttributeFieldConfig()``) on ``device``.  The
    insav_wild (GaussianAvatar-style) layout keeps SMPL-24 parameters in
    ``train/smpl_parms.pth`` (or ``smpl_parms.pth``), which then pose the
    avatar, and its images under ``train/`` when ``train/images`` exists."""
    import os

    from ..avatar.state import init_avatar
    from ..data.dataset import load_insav_smpl_params, load_sequence
    from ..field.attribute_field import AttributeFieldConfig

    insav_params = None
    if any(os.path.exists(os.path.join(dataroot, c))
           for c in ("train/smpl_parms.pth", "smpl_parms.pth")):
        insav_params = load_insav_smpl_params(dataroot)
    img_root = dataroot
    if insav_params is not None and os.path.isdir(os.path.join(dataroot, "train", "images")):
        img_root = os.path.join(dataroot, "train")
    ds = load_sequence(img_root)
    smpl_params = insav_params if insav_params is not None else ds.smpl_params
    params, model = init_avatar(
        load_body_model(smpl_model, device=device),
        smpl_params,
        num_subdiv=num_subdiv,
        field_cfg=AttributeFieldConfig(),
        seed=seed,
        distill_steps=distill_steps,
        device=device,
    )
    return ds, params, model
