"""The ``soar_novel_pose`` cell at small shapes on the CPU: its configuration
keeps SMPL-X's structure and the turntable's field and camera, each frame
draws a full SMPL-X pose in its seven segments, requests cycle the 20 frames,
a run is correct and its per-layer readers read, the control and the planted
faults fail the cell's limits, and set-up refuses a body or an avatar of
another size."""

import copy
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import harness, smplx_body
from benchmark.runners import novel_pose as N
from benchmark.tests.test_bench_imports import SETUP_ONLY
from benchmark.trace import traced

CELL = "soar_novel_pose"
READERS = ("idle_share.novel", "aten_ops.novel", "pose_ms.novel", "lbs_ms.novel",
           "field_ms.novel")
SEED = 12345678901


def small():
    """The cell's configuration cut to CPU size: the small tube layout
    (SMPL-X's joints and tree) subdivided once, a 4-level field, 64x64."""
    _, cfg, _, _ = harness.cell_spec(harness.load_json(harness.ROOT / "BENCHMARK.json"), CELL)
    cfg = copy.deepcopy(cfg)
    V, F = smplx_body.counts(smplx_body.SMALL_TUBES)
    cfg["body"].update(layout="small", vertices=V, faces=F, num_subdiv=1)
    cfg["surfels"] = 4 * V - 6 * len(smplx_body.SMALL_TUBES)
    cfg["field"].update(num_levels=4, max_res=128, log2_hashmap_size=10, hidden_dim=16)
    cfg["capture"].update(size=64, focal=75.0)
    return cfg


def cell_of(bench, seed=SEED, cfg=None, **mix_kw):
    _, _, mix, _ = harness.cell_spec(bench, CELL)
    return N.Cell(cfg or small(), dict(mix, **mix_kw), seed, torch.device("cpu"))


def test_the_configuration_keeps_smplx_and_the_turntables_view(bench):
    _, cfg, mix, limits = harness.cell_spec(bench, CELL)
    _, turn, _, _ = harness.cell_spec(bench, "soar_turntable")
    for key in ("field", "raster"):
        assert cfg[key] == turn[key], key
    assert {k: cfg["capture"][k] for k in ("size", "focal")} == {"size": 512, "focal": 600.0}
    b = cfg["body"]
    assert (b["num_joints"], b["shape_directions"], b["pose_directions"]) == (55, 400, 486)
    assert (b["num_betas"], b["num_expression"], b["num_subdiv"]) == (10, 10, 2)
    assert (b["vertices"], b["faces"]) == smplx_body.counts(smplx_body.LAYOUTS[b["layout"]])
    assert mix["views"] == cfg["capture"]["frames"] == 20
    assert (mix["sample"], mix["trace_units"], mix["trace_host_units"]) == (8, 20, 10)
    assert mix["span_units"] >= 20
    assert set(limits) == {"rgb_px", "normal_px", "occ_px", "mask_px"}


def test_each_frame_draws_a_full_smplx_pose_in_its_segments(bench):
    _, cfg, mix, _ = harness.cell_spec(bench, CELL)
    sp = N.frame_params(cfg, mix, SEED, torch.device("cpu"))
    shapes = {k: v.shape for k, v in sp.items()}
    assert shapes == {"global_orient": (20, 3), "body_pose": (20, 63), "jaw_pose": (20, 3),
                      "leye_pose": (20, 3), "reye_pose": (20, 3), "left_hand_pose": (20, 45),
                      "right_hand_pose": (20, 45), "expression": (20, 10), "betas": (1, 10),
                      "transl": (20, 3)}
    go = sp["global_orient"]
    assert not go[:, [0, 2]].any() and np.abs(go[:, 1]).max() <= np.pi
    assert np.ptp(go[:, 1]) > 2.0  # the yaws spread over the circle
    for k, std in (("body_pose", 0.3), ("left_hand_pose", 0.3), ("expression", 1.0)):
        assert 0.7 * std < sp[k].std() < 1.3 * std, k
    assert np.abs(np.concatenate([sp[k] for k in ("jaw_pose", "leye_pose", "reye_pose")])
                  ).max() < 0.6
    assert np.array_equal(sp["transl"], np.tile(np.float32(cfg["capture"]["transl"]), (20, 1)))
    again = N.frame_params(cfg, mix, SEED, torch.device("cpu"))
    assert all(np.array_equal(v, again[k]) for k, v in sp.items())
    other = N.frame_params(cfg, mix, SEED + 1, torch.device("cpu"))
    assert not np.array_equal(sp["body_pose"], other["body_pose"])


def test_requests_cycle_the_20_frames(bench):
    cell = cell_of(bench)
    frames = []
    render = cell._render

    def spy(i):
        frames.append(i)
        return render(i)

    cell._render = spy
    cell.warmup()
    assert frames == list(range(20)) and cell.i == 0 and cell.kept == []
    for _ in range(22):
        cell.unit_call()
    assert frames[20:] == list(range(20)) + [0, 1] and cell.i == 2
    assert len(cell.kept) == 8 and {i for _, i, _ in cell.kept} <= set(range(20))
    cell.free()
    assert N.LIVE == []


def test_a_run_is_correct(bench):
    r = harness.run(bench, CELL, SEED, 0.5, False, time.perf_counter(), device="cpu",
                    cfg_override=small())
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"view_ms", "view_p95_ms", "peak_mem_gib", "setup_s"}
    assert all(c["value"] == 0.0 for c in r["checks"].values())
    assert N.LIVE == []


def test_the_traced_readers_read(bench):
    """The traced run's context and a span window of 2 views; on the CPU
    the device ms read 0."""
    cell = cell_of(bench, span_units=2)
    cell.warmup()
    try:
        ctx = traced(cell, cell.mix)
        got = {name: harness.reader(name)(ctx) for name in READERS}
        table = cell.span_table()["table"]
    finally:
        cell.free()
    assert all(v is not None for v in got.values()), got
    assert got["aten_ops.novel"] > 0
    assert table["spans"]["soar.pose.lbs"]["calls"] == table["spans"]["soar.pose"]["calls"] == 1
    assert table["spans"]["soar.pose.skin"]["calls"] == 1
    assert N.LIVE == []


def test_the_control_and_the_faults_fail_the_limits(bench):
    _, _, _, limits = harness.cell_spec(bench, CELL)
    cell = cell_of(bench, seed=4242)
    for _ in range(20):
        cell.unit_call()
    cell.free()
    program = cell.check()
    assert all(program[k] <= limits[k] for k in limits), program
    control = cell.control()
    assert any(control[k] > limits[k] for k in control), control
    faults = cell.faults()
    assert set(faults) == {"next_frame", "hands_zeroed", "expression_zeroed"}
    for name, got in faults.items():
        assert any(got[k] > limits[k] for k in limits), (name, got)


def test_set_up_refuses_a_body_or_an_avatar_of_another_size(bench):
    cfg = small()
    cfg["body"]["faces"] += 1
    with pytest.raises(RuntimeError, match="the body reads"):
        cell_of(bench, cfg=cfg)
    cfg = small()
    cfg["surfels"] += 1
    with pytest.raises(RuntimeError, match="surfels"):
        cell_of(bench, cfg=cfg)
    N.LIVE.clear()


def test_the_readers_are_silent_on_other_cells(bench):
    N.LIVE.clear()
    for name in READERS:
        read = harness.reader(name)
        assert read({"unit": "view", "units": 36, "window_s": 1.0, "busy_s": 0.5,
                     "aten_ops": 1}) is None
        assert read({"unit": "step", "units": 5, "window_s": 1.0, "busy_s": 0.5,
                     "aten_ops": 1}) is None


def test_set_up_and_the_window_import_nothing_of_the_reference():
    out = subprocess.run([sys.executable, "-c", SETUP_ONLY, str(harness.ROOT),
                          json.dumps(small()), CELL],
                         capture_output=True, text=True, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
