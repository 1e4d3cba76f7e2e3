"""The ``soar_train_warm`` cell at small shapes on the CPU: its configuration
holds the published stage 0 at the guided cell's widths, its counter wraps
from ``sds_start`` back to step 1 without a guided step, a run is correct
and its per-layer readers read, the control and the planted faults fail the
cell's limits, and the readers are silent on every other cell's units."""

import copy
import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.runners import train_warm as W
from benchmark.tests.small import small_config
from benchmark.tests.test_bench_imports import SETUP_ONLY
from benchmark.trace import traced

CELL = "soar_train_warm"
CONFIG = "soar_imagedream_stage0"
READERS = ("idle_share.warm", "aten_ops.warm", "lpips_ms.warm", "raster_front_ms.warm",
           "host_syncs.warm")
SEED = 12345678901


def small():
    return small_config(CONFIG)


def cell_of(bench, seed=SEED, **mix_kw):
    _, _, mix, _ = harness.cell_spec(bench, CELL)
    return W.Cell(small(), dict(mix, **mix_kw), seed, torch.device("cpu"))


def run_small(bench, trace=False):
    return harness.run(bench, CELL, SEED, 0.5, trace, time.perf_counter(), device="cpu",
                       cfg_override=small())


def test_the_configuration_is_stage0_at_the_guided_cells_widths(bench):
    from benchmark.reference.train import config as R_config
    from soar_tpu_torch.train import config as P_config

    _, cfg, mix, limits = harness.cell_spec(bench, CELL)
    guided = harness.cell_spec(bench, "soar_train_guided")[1]
    for key in ("body", "surfels", "field", "capture", "raster", "guidance", "lpips_dtype",
                "parameters"):
        assert cfg[key] == guided[key], key
    assert {k: v for k, v in cfg["train"].items() if k in guided["train"] and k != "stage"} == {
        k: v for k, v in guided["train"].items() if k != "stage"}
    for config in (P_config, R_config):
        stage = W.stage_config(config, cfg["train"])
        assert stage.training_stage == 0 and mix["last_step"] == stage.sds_start == 500
    assert mix["start_step"] == mix["wrap_to"] == 1
    assert mix["span_units"] >= 20 and mix["checked_steps"] == 3
    assert limits["guided_steps"] < 1


def test_the_counter_wraps_from_sds_start_to_1_and_no_step_guides(bench):
    cell = cell_of(bench, start_step=499)
    counters = []
    step = cell.unit_call

    def unit_call():
        counters.append(cell.state.step)
        return step()

    cell.unit_call = unit_call
    cell.warmup()
    assert counters == [499, 500, 1, 2] and cell.state.step == 3
    assert cell.guided == 0
    cell.free()


def test_a_mix_that_reaches_a_guided_step_is_refused(bench):
    with pytest.raises(ValueError, match="sds_start"):
        cell_of(bench, last_step=501)
    cfg = small()
    cfg["train"]["sds_start"] = 400
    _, _, mix, _ = harness.cell_spec(bench, CELL)
    with pytest.raises(RuntimeError, match="StageConfig"):
        W.Cell(cfg, mix, SEED, torch.device("cpu"))


def test_set_up_refuses_networks_of_another_size(bench):
    cfg = small()
    cfg["parameters"]["clip"] += 1
    _, _, mix, _ = harness.cell_spec(bench, CELL)
    with pytest.raises(RuntimeError, match="guidance parameters"):
        W.Cell(cfg, mix, SEED, torch.device("cpu"))


def test_a_run_is_correct(bench):
    r = run_small(bench)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"train_step_ms", "peak_mem_gib", "setup_s"}
    assert r["checks"]["guided_steps"]["value"] == 0.0
    assert W.LIVE == []


def test_the_traced_readers_read(bench):
    """The traced run's context and a span window of 2 steps (the cell's
    20 take minutes on a CPU); on the CPU the device ms read 0."""
    cell = cell_of(bench, span_units=2)
    cell.warmup()
    try:
        ctx = traced(cell, cell.mix)
        got = {name: harness.reader(name)(ctx) for name in READERS}
    finally:
        cell.free()
    assert all(v is not None for v in got.values()), got
    assert got["host_syncs.warm"] == 0.0 and got["aten_ops.warm"] > 0
    assert cell.guided == 0 and W.LIVE == []


def test_the_control_and_the_faults_fail_the_limits(bench):
    _, _, _, limits = harness.cell_spec(bench, CELL)
    cell = cell_of(bench, seed=4242)
    cell.warmup()
    cell.free()
    program = cell.check()
    assert all(program[k] <= limits[k] for k in limits), program
    control = cell.control()
    assert any(control[k] > limits[k] for k in control), control
    for name, got in cell.faults().items():
        assert any(got[k] > limits[k] for k in limits if k in got), (name, got)


def test_a_program_that_guides_in_the_warm_up_is_caught(bench, monkeypatch):
    import soar_tpu_torch.train.trainer as T

    make = T.make_train_step

    def early(model, cfg, stage, *args, **kwargs):
        return make(model, cfg, dataclasses.replace(stage, sds_start=0), *args, **kwargs)

    monkeypatch.setattr(T, "make_train_step", early)
    r = run_small(bench)
    assert not r["correct"]
    assert r["checks"]["guided_steps"]["value"] >= 3


def test_a_step_that_leaves_the_state_unchanged_is_caught(bench, monkeypatch):
    import soar_tpu_torch.train.trainer as T

    make = T.make_train_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def still(state, batch, draws):
            _, metrics, _ = step.loss_fn(state.params, state.bg_params, batch, draws, state.step)
            state.step += 1
            return state, {k: v.detach() for k, v in metrics.items()}

        return still

    monkeypatch.setattr(T, "make_train_step", broken)
    r = run_small(bench)
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] == 1.0


def test_the_readers_are_silent_on_other_cells(bench):
    W.LIVE.clear()
    for name in READERS[2:]:
        read = harness.reader(name)
        assert read({"unit": "step", "units": 5}) is None
        assert read({"unit": "view", "units": 36}) is None
    cell = cell_of(bench)
    try:
        for name in READERS:
            assert harness.reader(name)({"unit": "view", "units": 36, "window_s": 1.0,
                                         "busy_s": 0.5, "aten_ops": 1}) is None
    finally:
        cell.free()
    assert W.LIVE == []


def test_set_up_and_the_window_import_nothing_of_the_reference():
    cfg = copy.deepcopy(small())
    out = subprocess.run([sys.executable, "-c", SETUP_ONLY, str(harness.ROOT),
                          json.dumps(cfg), CELL],
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
