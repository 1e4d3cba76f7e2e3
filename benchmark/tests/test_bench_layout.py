"""The harness finds a configuration, a traffic mix, a cell's limits and a
per-layer metric's reader by name, from their files alone."""

import json
import shutil

from benchmark import harness


def test_every_name_in_benchmark_json_has_its_file(bench):
    for wl in bench["workloads"]:
        _, cfg, mix, limits = harness.cell_spec(bench, wl["name"])
        assert cfg["name"] == wl["config"]
        assert harness.runner(mix).UNIT in ("step", "view")
        assert limits and all(v > 0 for v in limits.values())
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"]))


def test_new_files_are_found_without_an_edit(tmp_path, monkeypatch):
    """A later change adds a traffic mix, a cell's limits and a metric as
    new files; the harness finds each by its name."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, root, ignore=shutil.ignore_patterns("tests", "*.pyc"))
    (root / "traffic" / "turntable72.json").write_text(
        json.dumps({"runner": "turntable", "views": 72, "sample": 8, "trace_units": 72,
                    "trace_host_units": 12}))
    (root / "limits" / "soar_turntable72.json").write_text(json.dumps({"rgb_px": 0.02}))
    (root / "metrics" / "views_traced.view.py").write_text(
        "def read(ctx):\n    return float(ctx['units']) if ctx.get('unit') == 'view' else None\n")
    monkeypatch.setattr(harness, "BENCH_DIR", root)
    assert harness.find("traffic", "turntable72")["views"] == 72
    assert harness.find("limits", "soar_turntable72") == {"rgb_px": 0.02}
    read = harness.reader("views_traced.view")
    assert read({"unit": "view", "units": 36}) == 36.0 and read({"unit": "step"}) is None
    assert harness.runner(harness.find("traffic", "turntable72")).UNIT == "view"


def test_a_missing_file_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(harness, "BENCH_DIR", tmp_path)
    for kind in ("traffic", "limits"):
        try:
            harness.find(kind, "nope")
        except FileNotFoundError as e:
            assert "nope.json" in str(e)
        else:
            raise AssertionError("found a file that is not there")
