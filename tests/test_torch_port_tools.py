"""The tools around the training CLI against the repository's JAX-side
ones: ``soar_tpu_torch.cli.eval_ckpt`` against ``scripts/eval_ckpt.py``,
and the two-stage driver ``soar_tpu_torch/scripts/run_dance_0.sh`` against
``scripts/run_dance_0.sh``.

Tolerances: the eval's ``average.txt`` to 1e-4 relative, the bound of
``test_torch_port_lpips.py::test_evaluate_lpips_matches_jax`` (renders
~1e-6 apart through PSNR and SSIM).
"""

import importlib.util
import os
import subprocess

import numpy as np
import pytest

from soar_tpu.cli import common as jcommon
from soar_tpu.io import checkpoint as jckpt
from soar_tpu_torch.cli import eval_ckpt
from soar_tpu_torch.data import mock_capture
from soar_tpu_torch.io.checkpoint import save_avatar
from soar_tpu_torch.io.from_jax import avatar_from_numpy
from torch_port_helpers import avatar_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_eval_ckpt_matches_the_jax_script(tmp_path):
    cap = str(tmp_path / "cap")
    mock_capture.make_capture(cap, frames=5, size=64, joints=4, segments=3, ring=8,
                              device="cpu")
    body = "test:4,3,8"
    # A JAX checkpoint of the capture's avatar, its explicit colours drawn
    # away from the init so they matter under --use-explicit, and the
    # same parameters carried across as the port's checkpoint.
    _, jparams, jmodel = jcommon.real_setup(cap, body, num_subdiv=1, distill_steps=0)
    rng = np.random.RandomState(3)
    jparams = jparams._replace(colors=rng.randn(*jparams.colors.shape).astype(np.float32))
    jckpt.save_avatar(str(tmp_path / "jax_ckpt"), jparams, step=7)
    tparams, _ = avatar_from_numpy(*avatar_to_numpy(jparams, jmodel), device="cpu")
    save_avatar(str(tmp_path / "port_ckpt"), tparams, step=7)

    flags = ["--dataroot", cap, "--smpl-model", body, "--num-subdiv", "1",
             "--max-per-tile", "64"]
    for extra in ([], ["--use-explicit"]):
        jout, tout = str(tmp_path / f"jax{len(extra)}"), str(tmp_path / f"port{len(extra)}")
        want = _script("eval_ckpt").main(flags + extra + ["--ckpt", str(tmp_path / "jax_ckpt"),
                                                          "--out", jout])
        got = eval_ckpt.main(flags + extra + ["--ckpt", str(tmp_path / "port_ckpt"),
                                              "--out", tout, "--device", "cpu"])
        assert set(got) == set(want) == {"psnr", "ssim"}
        w = open(os.path.join(jout, "average.txt")).read().split()
        g = open(os.path.join(tout, "average.txt")).read().split()
        assert len(g) == len(w) == 3 and g[2] == w[2] == "nan"
        np.testing.assert_allclose([float(x) for x in g[:2]], [float(x) for x in w[:2]],
                                   rtol=1e-4)
        for f in ("psnrs.txt", "ssims.txt"):
            np.testing.assert_allclose(np.loadtxt(os.path.join(tout, f)),
                                       np.loadtxt(os.path.join(jout, f)), rtol=1e-4)
    with pytest.raises(ValueError, match="import"):
        eval_ckpt.main(flags + ["--ckpt", str(tmp_path / "ref.ckpt"), "--out", tout,
                                "--device", "cpu"])


SWITCHES = {
    "none": {},
    "mock": {"MOCK_GUIDANCE": "1"},
    "ckpt": {"GUIDANCE_CKPT": "/w/ipmv.pt"},
    "ckpt_embeddings": {"GUIDANCE_CKPT": "/w/ipmv.pt", "PROMPT_EMBEDDINGS": "/w/prompt.npz"},
    "ckpt_clip": {"GUIDANCE_CKPT": "/w/ipmv.pt", "CLIP_MODEL_DIR": "/w/clip"},
    "smpl_model": {"SMPL_MODEL": "/w/SMPLX_NEUTRAL.npz", "MOCK_GUIDANCE": "1"},
}


def _driver_commands(script, switches, tmp_path):
    """The ``python`` command lines ``script`` runs, recorded by a shim
    first on ``PATH``, one argv list per command."""
    shim = tmp_path / "bin"
    shim.mkdir(exist_ok=True)
    log = tmp_path / f"argv_{len(list(tmp_path.glob('argv_*')))}"
    (shim / "python").write_text('#!/bin/bash\nprintf "%s\\n" "$@" >> "$ARGV_LOG"\n'
                                 'echo "--end--" >> "$ARGV_LOG"\n')
    (shim / "python").chmod(0o755)
    env = {k: v for k, v in os.environ.items()
           if k not in ("SMPL_MODEL", "GUIDANCE_CKPT", "PROMPT_EMBEDDINGS", "CLIP_MODEL_DIR",
                        "MOCK_GUIDANCE")}
    env.update(switches, PATH=f"{shim}:{env['PATH']}", ARGV_LOG=str(log))
    out = subprocess.run(["bash", script], env=env, cwd=tmp_path, capture_output=True,
                         text=True, check=True).stdout
    assert out.split("\n")[:2] == ["Running Stage 0", "Running Stage 1"]
    cmds, cur = [], []
    for line in log.read_text().splitlines():
        if line == "--end--":
            cmds.append(cur)
            cur = []
        else:
            cur.append(line)
    return cmds


@pytest.mark.parametrize("case", list(SWITCHES))
def test_driver_runs_the_jax_drivers_commands(tmp_path, case):
    want = _driver_commands(os.path.join(REPO, "scripts", "run_dance_0.sh"), SWITCHES[case],
                            tmp_path)
    got = _driver_commands(os.path.join(REPO, "soar_tpu_torch", "scripts", "run_dance_0.sh"),
                           SWITCHES[case], tmp_path)
    assert len(want) == 2 and want[0][:2] == ["-m", "soar_tpu.cli.train"]
    assert got == [[a.replace("soar_tpu.", "soar_tpu_torch.") for a in cmd] for cmd in want]
    assert ("--eval" in got[1] and "--resume" in got[1] and "--eval" not in got[0])
    guided = "--guidance" in got[0]
    assert guided == (case != "none")


def test_every_module_of_soar_tpu_has_its_counterpart():
    """The port is complete: each module of ``soar_tpu`` has one of the same
    path in ``soar_tpu_torch``, but for the one renamed (the Pallas tile
    walk, ``render/tiles_composite.py`` with ``csrc/composite_tiles.cu``)
    and the torch converter, which the port, reading torch state_dicts
    directly, needs no counterpart of."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root)
                for f in fs if f.endswith(".py")}

    missing = modules("soar_tpu") - modules("soar_tpu_torch")
    assert missing == {"core/torch_convert.py", "render/pallas_composite.py"}
    for counterpart in ("render/tiles_composite.py", "csrc/composite_tiles.cu",
                        "parallel/views.py", "cli/eval_ckpt.py", "scripts/run_dance_0.sh"):
        assert os.path.exists(os.path.join(REPO, "soar_tpu_torch", counterpart)), counterpart
