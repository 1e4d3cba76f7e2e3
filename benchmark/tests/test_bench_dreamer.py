"""The ``dreamer_train`` cell at small shapes on the CPU: its configuration
holds the published values, set-up refuses networks of another size, a run
is correct and its per-layer readers read the program's spans, the control
and the planted faults fail the cell's limits, and the readers are silent
on every other cell's units."""

import copy
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.runners import dreamer_step as D
from benchmark.tests.test_bench_imports import SETUP_ONLY

CELL = "dreamer_train"
READERS = ("field_ms.dreamer", "densify_ms.dreamer", "guidance_ms.dreamer",
           "sort_key_use.dreamer", "host_syncs.dreamer")
SEED = 12345678901


def small_config() -> dict:
    """The configuration cut to CPU test size: a 4-joint body subdivided
    once at twice its surfels, a 4-level field, 4 views at 32x32 with
    K = 32, the tiny text-only guidance, and a densify threshold that takes
    some of the surfels (the published 1e-4 takes every one at this size:
    the position regulariser alone gives each 1 / capacity)."""
    from benchmark.reference.body.model import make_test_body
    from benchmark.reference.body.template import subdivide_n
    from benchmark.reference.guidance.build import NetworkShapes, make_networks

    cfg = copy.deepcopy(harness.load_json(harness.BENCH_DIR / "configs"
                                          / "gaussiandreamer_mvdream.json"))
    cfg["body"].update(num_joints=4, segments_per_bone=3, ring=8, num_subdiv=1)
    cfg["field"].update(num_levels=4, max_res=128, log2_hashmap_size=10, hidden_dim=16)
    cfg["capture"].update(size=32, focal=40.0)
    cfg["dreamer"].update(image_size=32, densify_grad_threshold=0.002)
    cfg["raster"].update(max_per_tile=32, dup_side=3)
    cfg["guidance"].update(shapes="tiny", image_size=32, context_dim=16)
    unet, vae = make_networks(NetworkShapes.tiny(32), False, device="meta")
    cfg["parameters"] = {"unet": sum(p.numel() for p in unet.parameters()),
                         "vae": sum(p.numel() for p in vae.parameters())}
    body = make_test_body(4, 3, 8, device="cpu")
    cfg["surfels"] = int(subdivide_n(body.v_template.numpy(), body.faces.numpy(), 1)[0].shape[0])
    cfg["capacity"] = 2 * cfg["surfels"]
    return cfg


def run_small(bench, trace=False):
    return harness.run(bench, CELL, SEED, 0.5, trace, time.perf_counter(), device="cpu",
                       cfg_override=small_config())


def test_the_configuration_is_the_published_one(bench):
    from soar_tpu_torch.data.cameras import CameraSampleConfig
    from soar_tpu_torch.train.config import StageConfig
    from soar_tpu_torch.train.systems import DreamerConfig

    _, cfg, mix, _ = harness.cell_spec(bench, CELL)
    pub, d = DreamerConfig(), cfg["dreamer"]
    assert {k: v for k, v in d.items() if k not in ("loss", "image_size")} == {
        k: getattr(pub, k) for k in d if k not in ("loss", "image_size")}
    assert (d["image_size"],) * 2 == pub.image_size
    assert d["loss"] == {k: getattr(pub.loss, k) for k in d["loss"]}
    assert {k: getattr(pub.raster, k) for k in cfg["raster"]} == cfg["raster"]
    cam = CameraSampleConfig()
    assert {k: list(v) if isinstance(v, tuple) else v
            for k, v in ((k, getattr(cam, k)) for k in cfg["cameras"])} == cfg["cameras"]
    assert cfg["guidance"]["guidance_scale"] == StageConfig().guidance_scale
    assert cfg["parameters"] == {"unet": 867_572_164, "vae": 34_163_664}
    assert cfg["capacity"] == 2 * cfg["surfels"] == 251_328
    assert mix["last_step"] < d["prune_from"] and mix["wrap_to"] == d["densify_from"]
    assert D.densifies(D.dreamer_cfg(*_program_modules(), cfg),
                       mix["start_step"] + mix["checked_steps"] - 1)


def _program_modules():
    from soar_tpu_torch.data import cameras
    from soar_tpu_torch.render import types
    from soar_tpu_torch.train import config, systems

    return systems, types, cameras, config


def test_set_up_refuses_networks_of_another_size(bench):
    _, _, mix, _ = harness.cell_spec(bench, CELL)
    cfg = small_config()
    cfg["parameters"]["unet"] += 1
    with pytest.raises(RuntimeError, match="guidance parameters"):
        D.Cell(cfg, mix, SEED, torch.device("cpu"))


def test_a_run_is_correct_and_its_readers_read(bench):
    r = run_small(bench)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_step_ms", "peak_mem_gib", "setup_s"}
    t = run_small(bench, trace=True)
    assert t["correct"], t["checks"]
    assert set(t["metrics"]) == set(READERS)  # on the CPU the device ms read 0
    assert 0.0 < t["metrics"]["sort_key_use.dreamer"]["value"] < 100.0
    assert t["metrics"]["host_syncs.dreamer"]["value"] == 0.0
    assert D.LIVE == []


def test_the_control_and_the_faults_fail_the_limits(bench):
    _, _, mix, limits = harness.cell_spec(bench, CELL)
    cell = D.Cell(small_config(), mix, 4242, torch.device("cpu"))
    cell.warmup()
    cell.free()
    program = cell.check()
    assert all(program[k] <= limits[k] for k in limits), program
    control = cell.control()
    assert any(control[k] > limits[k] for k in limits), control
    for name, got in cell.faults().items():
        assert any(got[k] > limits[k] for k in limits), (name, got)


def test_a_program_that_skips_the_densify_is_caught(bench, monkeypatch):
    import soar_tpu_torch.train.systems as S

    make = S.make_gaussiandreamer_step

    def broken(*args, **kwargs):
        loss_step, _ = make(*args, **kwargs)
        return loss_step, lambda params, dstate, pw, step, **kw: (params, dstate, pw)

    monkeypatch.setattr(S, "make_gaussiandreamer_step", broken)
    r = run_small(bench)
    assert not r["correct"]
    assert r["checks"]["alive_gap"]["value"] > r["checks"]["alive_gap"]["limit"]


def test_a_program_over_half_of_its_views_is_caught(bench, monkeypatch):
    import soar_tpu_torch.guidance.build as B
    import soar_tpu_torch.train.systems as S

    make, build = S.make_gaussiandreamer_step, B.build_guidance

    def half(*args, **kwargs):
        loss_step, maintain = make(*args, **kwargs)

        def step(params, dstate, pw, draws, i):
            return loss_step(params, dstate, pw, D.half_draws(draws, 2), i)

        return step, maintain

    monkeypatch.setattr(S, "make_gaussiandreamer_step", half)
    monkeypatch.setattr(B, "build_guidance", lambda *a, **k: build(*a, **dict(k, n_view=2)))
    r = run_small(bench)
    assert not r["correct"], r["checks"]


def test_the_readers_are_silent_on_other_cells(bench):
    D.LIVE.clear()
    for name in READERS:
        read = harness.reader(name)
        assert read({"unit": "step", "units": 5}) is None
        assert read({"unit": "view", "units": 36}) is None
    _, _, mix, _ = harness.cell_spec(bench, CELL)
    cell = D.Cell(small_config(), mix, SEED, torch.device("cpu"))
    try:
        for name in READERS:
            assert harness.reader(name)({"unit": "view", "units": 36}) is None
    finally:
        cell.free()
    assert D.LIVE == []


def test_set_up_and_the_window_import_nothing_of_the_reference():
    out = subprocess.run([sys.executable, "-c", SETUP_ONLY, str(harness.ROOT),
                          json.dumps(small_config()), CELL],
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
