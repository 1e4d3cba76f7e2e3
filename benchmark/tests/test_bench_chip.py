"""On the card (``cuda`` marker; skipped without one): each cell runs at
its own size through the harness with a short window and comes out correct,
and its control, the reference a precision below the configuration's, does
not."""

import time

import pytest
import torch

from benchmark import harness


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["soar_turntable", "soar_train_guided"])
def test_cell_runs_correct_and_its_control_does_not(bench, workload):
    need_card()
    r = harness.run(bench, workload, 97, 2.0, False, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["memory_peak_bytes"] > 0
    _, cfg, mix, limits = harness.cell_spec(bench, workload)
    run_mod = harness.runner(mix)
    cell = run_mod.Cell(cfg, mix, 98, torch.device("cuda"))
    if run_mod.UNIT == "step":
        cell.warmup()
    else:
        for _ in range(mix["views"]):
            cell.unit_call()
    cell.free()
    control = cell.control()
    assert any(control[k] > limits[k] for k in limits), control
