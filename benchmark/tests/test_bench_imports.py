"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``soar_tpu_torch`` is the program), and the
reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

from benchmark import harness

from benchmark.tests.small import CONFIG_OF, run_small, small_config


def imported_top_levels(path):
    """(absolute top-level names, relative imports as (level, module))."""
    tree = ast.parse(path.read_text())
    names, rel = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                rel.append((node.level, node.module))
            else:
                names.add(node.module.split(".")[0])
    return names, rel


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(harness.BENCH_DIR.rglob("*.py"))
    assert files
    for f in files:
        names, _ = imported_top_levels(f)
        assert not names & set(harness.FORBIDDEN), (f.name, names & set(harness.FORBIDDEN))


def test_the_reference_imports_nothing_of_the_program():
    ref = harness.BENCH_DIR / "reference"
    for f in sorted(ref.rglob("*.py")):
        names, rel = imported_top_levels(f)
        assert "soar_tpu_torch" not in names, f
        depth = len(f.relative_to(ref).parts)  # a module's package depth inside the reference
        assert all(level < depth + 1 for level, _ in rel), (f, rel)


def test_a_run_loads_no_forbidden_module(bench):
    run_small(bench, "soar_turntable")
    assert harness.forbidden_modules() == []


def test_the_names_compare_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "soar_tpu_torch_extra", types.ModuleType("x"))
    assert "soar_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["jaxlib"]


SETUP_ONLY = """
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from benchmark import harness
cfg = json.loads(sys.argv[2])
_, _, mix, _ = harness.cell_spec(harness.load_json(harness.ROOT / "BENCHMARK.json"), sys.argv[3])
torch.set_num_threads(2)
cell = harness.runner(mix).Cell(cfg, mix, 31, torch.device("cpu"))
cell.warmup()
cell.window(0.2)
print(json.dumps(sorted(m for m in sys.modules if m.startswith("benchmark.reference"))))
"""


def test_set_up_and_the_window_import_nothing_of_the_reference():
    """The reference is imported only for the check, after the window: its
    imports cannot change the program's settings while it is timed."""
    for workload in ("soar_turntable", "soar_train_guided"):
        cfg = small_config(CONFIG_OF[workload])
        out = subprocess.run([sys.executable, "-c", SETUP_ONLY, str(harness.ROOT),
                              json.dumps(cfg), workload],
                             capture_output=True, text=True, check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1]) == [], workload


def test_the_reference_leaves_the_callers_tf32_settings():
    import torch

    from benchmark.reference import full_float32

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with full_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
