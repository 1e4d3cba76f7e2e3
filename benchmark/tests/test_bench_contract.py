"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, the
characters of every name and unit, the cells' metrics, the bounds."""

import json
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes(bench):
    raw = (harness.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"] and all(PATH.match(p) for p in bench["paths"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128


def test_names_units_and_lines(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("benchmark/") and (harness.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert all(k in cfg for k in c["reduced"]) and cfg["reduced"] == c["reduced"]
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["config"] in names and w["chips"] in (1, 4) and line(w["why"])
    metric_names = []
    for key, extra in (("end_to_end", {"bound"}), ("per_layer", {"layer", "moves"})):
        for m in bench[key]:
            assert set(m) - {"workloads"} == {"name", "unit", "better", "source"} | extra
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
            metric_names.append(m["name"])
    assert len(set(metric_names)) == len(metric_names)
    assert len({w["name"] for w in bench["workloads"]}) == len(bench["workloads"])
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(
        bench["workloads"])


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m["workloads"]) <= set(moved)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", [cell])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])
