"""Shared CLI helpers (port of ``soar_tpu.cli.common``).

``synthetic_setup`` builds the same demo avatar as the JAX package's (body
dims, field capacity, subdiv and frame count are the checkpoint contract).
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
    """``test:J,S,R`` builds the procedural test body (J joints, S segments
    per bone, R ring vertices).  The SMPL-X npz / SMPL pkl loaders are not
    ported yet."""
    from ..body.model import make_test_body

    if smpl_model.startswith("test:"):
        j, s, r = (int(x) for x in smpl_model[5:].split(","))
        return make_test_body(num_joints=j, segments_per_bone=s, ring=r, device=device)
    raise NotImplementedError(
        f"body model {smpl_model!r}: only the procedural 'test:J,S,R' body is "
        "ported so far"
    )
