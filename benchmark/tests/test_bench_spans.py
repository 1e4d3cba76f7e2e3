"""The span table of ``benchmark/spans.py``: backward nodes put back on the
span of their forward op, idle gaps on the span open at their middle, the
readings of a window with and without spans, and the whole measurement on
both cells at small shapes (on the CPU: no kernel, so no device time)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spans as B
from benchmark.tests.small import CONFIG_OF, small_config
from soar_tpu_torch.core import spans


def test_backward_nodes_go_to_their_forward_span():
    W = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.tracing():
        with spans.span("soar.step", unit="step"):
            with spans.span("soar.field"):
                h = torch.relu(x @ W)
            with spans.span("soar.lpips"):
                loss = (torch.sin(h) * 2.0).sum()
            with spans.span("soar.backward"):
                loss.backward()
    host = B._host(prof.events())
    owner = B.owner_of(host)
    nodes = {e.name[len(B.NODE):]: owner(e) for e in host if e.name.startswith(B.NODE)}
    assert nodes["MmBackward0"] == "soar.field"
    assert nodes["ReluBackward0"] == "soar.field"
    assert nodes["SinBackward0"] == nodes["MulBackward0"] == nodes["SumBackward0"] == (
        "soar.lpips")
    assert nodes["torch::autograd::AccumulateGrad"] == "soar.backward"
    # The ops a node runs follow it; forward ops keep their own span.
    for e in host:
        if e.name == "aten::mm":
            p = e.cpu_parent
            while p is not None and not p.name.startswith(("soar.", B.NODE)):
                p = p.cpu_parent
            want = "soar.field" if p.name == "soar.field" else nodes[p.name[len(B.NODE):]]
            assert owner(e) == want == "soar.field"
    table = B.span_table(prof.events(), 1)
    assert table["spans"]["soar.step"]["calls"] == 1
    assert table["spans"]["soar.step"]["host_self_ms"] < table["spans"]["soar.step"]["host_ms"]


def test_idle_gaps_go_to_the_span_open_at_their_middle():
    # Kernels busy [0,10), [20,30), [50,60), [100,110) us; spans on the host.
    merged = [[0, 10], [20, 30], [50, 60], [100, 110]]
    sp = sorted([(0, 45, "soar.step", None), (5, 25, "soar.field", "soar.step"),
                 (80, 120, "soar.render", None)])
    got = B.idle_by_span(merged, sp)
    # Gap 10-20 (mid 15) in the field; 30-50 (mid 40) in the step; 60-100
    # (mid 80) opens the render at its very middle.
    assert got == pytest.approx({"soar.field": 10e-6, "soar.step": 20e-6,
                                 "soar.render": 40e-6})
    assert B.idle_by_span(merged, [(200, 300, "soar.step", None)]) == pytest.approx(
        {B.OUTSIDE: 70e-6})


def test_readings_are_none_without_spans():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).mul(2.0)
    assert B.span_table(prof.events(), 1) is None
    for unit, n in (("step", 6), ("view", 4)):
        r = B.readings(None, unit)
        assert len(r) == n and all(v is None for v in r.values())
    assert set(B.readings(None, "step")) == {
        "field_ms.train", "raster_front_ms.train", "lpips_ms.train", "optim_ms.train",
        "host_syncs.train", "sort_key_use.train"}


@pytest.mark.parametrize("workload", ["soar_train_guided", "soar_turntable"])
def test_measure_reads_every_layer_of_a_cell(bench, workload):
    from benchmark import harness

    _, _, mix, _ = harness.cell_spec(bench, workload)
    cell = harness.runner(mix).Cell(small_config(CONFIG_OF[workload]), mix, 12345678901,
                                    torch.device("cpu"))
    cell.warmup()
    out = B.measure(cell, mix, units=1)
    rows = out["table"]["spans"]
    need = {"soar.field", "soar.pose", "soar.render", "soar.composite", *B.FRONT_END}
    if workload == "soar_train_guided":
        need |= {"soar.step", "soar.backward", "soar.optim", "soar.lpips", "soar.guidance",
                 "soar.losses", "soar.draws", "soar.batch"}
    assert need <= set(rows)
    r = out["readings"]
    assert all(v is not None for v in r.values()), r
    sfx = B.SUFFIX[cell.unit]
    assert r[f"host_syncs.{sfx}"] == 0.0  # no CUDA: nothing synchronises
    assert 0.0 < r[f"sort_key_use.{sfx}"] < 100.0
    # Spans dispatch nothing; on, the counters add their reads' few ops.
    assert out["aten_ops"]["off"] < out["aten_ops"]["on"] < out["aten_ops"]["off"] + 100
    assert not spans.on()
