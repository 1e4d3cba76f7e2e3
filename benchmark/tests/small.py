"""Small shapes for the benchmark's CPU tests."""

import copy
import time

from benchmark import harness

CONFIG_OF = {"soar_train_guided": "soar_imagedream_train", "soar_turntable": "soar_avatar_render"}


def small_config(name: str) -> dict:
    """A configuration cut to CPU test size: a 4-joint body subdivided
    once, a 4-level field, 4 frames of 64x64, the tiny guidance networks."""
    from benchmark.reference.body.model import make_test_body
    from benchmark.reference.body.template import subdivide_n
    from benchmark.reference.guidance.build import (
        NetworkShapes,
        make_image_encoder,
        make_networks,
    )

    cfg = copy.deepcopy(harness.load_json(harness.BENCH_DIR / "configs" / f"{name}.json"))
    cfg["body"].update(num_joints=4, segments_per_bone=3, ring=8, num_subdiv=1)
    cfg["field"].update(num_levels=4, max_res=128, log2_hashmap_size=10, hidden_dim=16)
    cfg["capture"].update(frames=4, size=64, focal=75.0)
    if "train" in cfg:
        cfg["train"].update(gen_size=32, normal_size=64)
        cfg["guidance"].update(shapes="tiny", image_size=32, context_dim=16)
        sh = NetworkShapes.tiny(32)
        unet, vae = make_networks(sh, True, device="meta")
        clip, res = make_image_encoder(sh, device="meta")
        cfg["parameters"] = {k: sum(p.numel() for p in m.parameters()) for k, m in
                             (("unet", unet), ("vae", vae), ("clip", clip), ("resampler", res))}
    body = make_test_body(4, 3, 8, device="cpu")
    cfg["surfels"] = int(subdivide_n(body.v_template.numpy(), body.faces.numpy(), 1)[0].shape[0])
    return cfg


def run_small(bench, workload, seed=12345678901, trace=False):
    """One run of a cell at the small shapes on the CPU (the harness's look
    for a chip skipped)."""
    return harness.run(bench, workload, seed, 0.5, trace, time.perf_counter(), device="cpu",
                       cfg_override=small_config(CONFIG_OF[workload]))
