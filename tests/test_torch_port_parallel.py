"""The port's parallel layer against one process and against soar_tpu on
the CPU: the view- and row-sharded step on two gloo ranks (even and uneven
splits), ``gen_chunk`` and the two remats, and ``cli.train --multichip``.

The ranks run in processes that ``torch.multiprocessing.spawn`` starts
(``torch_port_parallel_worker``: no JAX, no conftest, one thread each).

Tolerances, each with its reason:
- the sharded step against the one-process port step:
  ``tests/test_parallel.py``'s bounds, loss 1e-4 relative and the updated
  ``xyz`` and ``colors`` 1e-5 absolute (a rank renders its views and tile
  rows with the same arithmetic; the gradients are summed in another
  order);
- against JAX's unsharded step, with its draws injected: the bounds of
  ``test_torch_port_train.py::test_train_step_matches_jax`` (losses 1e-4
  relative, gradients 1e-3 relative L2, the hash tables 1e-2, updates where
  |g| is well above the noise);
- ``gen_chunk`` and remat against the plain step: float32 rounding (1e-6
  relative), since they run the same ops on the same inputs;
- the CLI's metrics rows, two ranks against one process: 1e-4 absolute,
  the rows' own rounding (5 decimals) plus the second step's spread (the
  first step's Adam moves every entry with a nonzero gradient by about its
  learning rate, noise-level ones too).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_parallel_worker as W
from soar_tpu.avatar.optim import make_optimizer as jmake_opt
from soar_tpu.render.types import RasterConfig as JRasterConfig
from soar_tpu.train import background as jbg
from soar_tpu.train import trainer as jtr
from soar_tpu.train.config import LossWeights as JLossWeights
from soar_tpu.train.config import StageConfig as JStageConfig
from soar_tpu.train.config import TrainConfig as JTrainConfig
from soar_tpu_torch.cli import train as tcli
from soar_tpu_torch.parallel import ViewMesh, view_sharder
from soar_tpu_torch.render import tiled
from test_torch_port_train import _datasets, _grab_grads, _jax_draws, _rel_l2, jax_leaves
from torch_port_helpers import assert_close, avatar_to_numpy, n, small_avatar

GEN, SIZE = (32, 32), (48, 48)  # 2x2 gen tiles; 3 GT tile rows: 2 + 1 over two ranks


@pytest.fixture(scope="module")
def scene():
    jparams, jmodel, _, _ = small_avatar()
    jds, tds = _datasets(jmodel)
    arrays = {k: getattr(tds, k) for k in (
        "images", "masks", "normal_F", "normal_B", "normal_mask", "images_crop", "masks_crop",
        "smpl_params", "w2c", "Ks", "normal_Ks", "train_idx", "val_idx", "test_idx")}
    bg = jbg.init_background(jax.random.PRNGKey(7))
    return {"jparams": jparams, "jmodel": jmodel, "jds": jds, "bg": bg,
            "avatar": avatar_to_numpy(jparams, jmodel), "dataset": arrays}


def _spec(scene, nv, options=None, guidance=None):
    """The step of ``test_train_step_matches_jax`` (explicit attributes,
    normal passes, curvature on) at ``nv`` views, JAX's draws injected;
    with ``guidance``, split SDS through tiny random networks of that
    kind."""
    key = np.asarray(jax.random.PRNGKey(11))  # numpy: the ranks import no JAX
    return {
        "avatar": scene["avatar"], "dataset": scene["dataset"], "train_cfg": {"n_views": nv},
        "loss": {"curv": 0.05}, "sds_start": 0, "step": 3, "frame": 2,
        "bg": jax.tree_util.tree_map(np.asarray, scene["bg"]),
        "raster": {"max_per_tile": 48, "dup_side": 3}, "use_explicit": True,
        "sizes": {"gen_size": GEN, "gt_size": SIZE, "normal_size": SIZE},
        "draws": _jax_draws(key, JTrainConfig(n_views=nv), nv), "key": key,
        "options": options or {}, "guidance": guidance,
    }


def _jax_step(scene, spec, gen_chunk=None):
    """JAX's unsharded step on the spec: metrics, grads and the updated
    leaves (by the JAX package's leaf names)."""
    nv = spec["train_cfg"]["n_views"]
    jcfg = JTrainConfig(n_views=nv)
    grab = _grab_grads()
    jstep = jax.jit(jtr.make_train_step(
        scene["jmodel"], jcfg, JStageConfig(loss=JLossWeights(curv=0.05), sds_start=0), grab,
        raster=JRasterConfig(composite="xla", composite_dtype="f32", max_per_tile=48,
                             dup_side=3),
        use_explicit=True, gen_chunk=gen_chunk, **spec["sizes"]))
    jp = scene["jparams"]
    jstate = jtr.TrainState(params=jp, bg_params=scene["bg"], opt_state=grab.init(jp),
                            step=jnp.asarray(spec["step"], jnp.int32))
    jnew, jmetrics = jstep(jstate, jtr.make_gt_batch(scene["jds"], scene["jmodel"],
                                                     spec["frame"]), spec["key"])
    jopt = jmake_opt(jp, jcfg.optim)
    upd, _ = jopt.update(jnew.opt_state, jopt.init(jp), jp)
    return {"metrics": {k: float(v) for k, v in jmetrics.items()},
            "grads": {k: np.asarray(v) for k, v in jax_leaves(jnew.opt_state).items()},
            "updated": {k: np.asarray(v) for k, v in
                        jax_leaves(optax.apply_updates(jp, upd)).items()}}


def _jax_name(name):
    """A port parameter's name -> (the JAX leaf name, transposed?)."""
    parts = name.split(".")
    if parts[0] != "field":
        return name, False
    if len(parts) == 2:
        return f"field/{parts[1]}", False
    return f"field/{parts[1]}/{parts[2]}/{'w' if parts[3] == 'weight' else 'b'}", \
        parts[3] == "weight"


def assert_matches_jax(got, want):
    """``test_train_step_matches_jax``'s checks on a port result."""
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        assert_close(got["metrics"][k], v, 1e-7, 1e-4, msg=k)
    grads = {}
    for name, g in got["grads"].items():
        k, transposed = _jax_name(name)
        grads[k] = g.T if transposed else g
    for k, jg in want["grads"].items():
        tg = grads.get(k)
        if not np.any(jg):
            assert tg is None or not bool(tg.any()), k
            continue
        tol = 1e-2 if k.endswith("encoding") else 1e-3
        assert _rel_l2(tg, jg) <= tol, (k, _rel_l2(tg, jg))
        if k in ("xyz", "colors"):
            sel = (np.abs(jg) > 1e-3 * np.abs(jg).max()) & (np.sign(n(tg)) == np.sign(jg))
            assert sel.any(), k
            diff = np.abs(n(got[k]) - want["updated"][k])[sel]
            assert float(diff.max()) <= 1e-6 + 1e-5 * float(np.abs(want["updated"][k]).max())


@pytest.fixture(scope="module")
def sharded(scene, tmp_path_factory):
    """Per case (4 views, 3 views, 4 views with split SDS): the spec, the
    one-process port step and the two ranks' sharded steps (both
    sharders)."""
    specs = {"views4_even": _spec(scene, 4), "views3_uneven": _spec(scene, 3),
             "views4_split_sds": _spec(scene, 4, guidance="mvdream")}
    d = str(tmp_path_factory.mktemp("sharded"))
    W.spawn(W.sharded_steps, 2, d, list(specs.values()), os.path.join(d, "rank"))
    ranks = [torch.load(os.path.join(d, f"rank.{r}"), weights_only=False) for r in (0, 1)]
    return {name: {"spec": spec, "one": W.run_step(spec), "ranks": [ranks[0][i], ranks[1][i]]}
            for i, (name, spec) in enumerate(specs.items())}


@pytest.mark.parametrize("case", ["views4_even", "views3_uneven", "views4_split_sds"])
def test_two_ranks_match_one_process(sharded, case):
    one, ranks = sharded[case]["one"], sharded[case]["ranks"]
    for r in ranks:
        assert set(r["metrics"]) == set(one["metrics"])
        assert np.isfinite(r["metrics"]["loss"])
        np.testing.assert_allclose(r["metrics"]["loss"], one["metrics"]["loss"], rtol=1e-4)
        for k in ("xyz", "colors"):
            assert_close(r[k], one[k], 1e-5, msg=k)
        if "latents" in one:  # the prelude's sharded renders, VAE-encoded
            assert "loss_sds" in r["metrics"]
            assert_close(r["latents"], one["latents"], 1e-6, 1e-5, msg="latents")
    # The ranks hold one replicated state after the step.
    for k in ("xyz", "colors"):
        assert torch.equal(ranks[0][k], ranks[1][k]), k


def test_two_ranks_match_jax(scene, sharded):
    case = sharded["views4_even"]
    assert_matches_jax(case["ranks"][0], _jax_step(scene, case["spec"]))


def test_gen_chunk_matches_jax_lax_map(scene):
    spec = _spec(scene, 4, {"gen_chunk": 2})
    assert_matches_jax(W.run_step(spec), _jax_step(scene, spec, gen_chunk=2))


@pytest.mark.parametrize("gen_chunk", [None, 1, 2])
@pytest.mark.parametrize("remat", ["remat_gen", "remat_gt"])
def test_gen_chunk_and_remat_match_plain_step(scene, monkeypatch, gen_chunk, remat):
    counted = []
    composite = tiled.composite_block

    def count(*args):
        counted.append(args[0].shape[0])
        return composite(*args)

    monkeypatch.setattr(tiled, "composite_block", count)
    plain = W.run_step(_spec(scene, 4))
    plain_launches = len(counted)
    counted.clear()
    other = "remat_gt" if remat == "remat_gen" else "remat_gen"
    got = W.run_step(_spec(scene, 4, {"gen_chunk": gen_chunk, remat: True, other: False}))
    # Forward composites: 13 a step; a recompute renders again the gen
    # views' main and occ passes, or the GT pass (main, occ) and the normal
    # pair (front, back, occ).
    assert plain_launches == 13
    assert len(counted) == 13 + (2 * 4 if remat == "remat_gen" else 5)
    for k, v in plain["metrics"].items():
        assert_close(got["metrics"][k], v, 0, 1e-6, msg=k)
    assert set(got["grads"]) == set(plain["grads"])
    for k, g in plain["grads"].items():
        assert _rel_l2(got["grads"][k], n(g)) <= 1e-6, k
    for k in ("xyz", "colors"):
        assert_close(got[k], plain[k], 1e-7, 1e-6, msg=k)


@pytest.mark.parametrize("world,views", [(1, 4), (2, 4), (2, 3), (3, 4), (4, 5)])
def test_sharder_blocks_follow_tensor_split(world, views):
    blocks = [view_sharder(ViewMesh(None, r, world, torch.device("cpu"))).block(views)
              for r in range(world)]
    want = [(int(b[0]), int(b[-1]) + 1) for b in torch.tensor_split(torch.arange(views), world)]
    assert blocks == want
    with pytest.raises(ValueError, match="cannot shard"):
        view_sharder(ViewMesh(None, 0, views + 1, torch.device("cpu"))).block(views)


# ------------------------------------------------------------------- CLI

CLI_ARGS = ["--synthetic", "--multichip", "--device", "cpu", "--stage", "0", "--steps", "2",
            "--log-every", "1", "--dump-every", "0", "--val-every", "0"]


@pytest.fixture(scope="module")
def one_process_cli(tmp_path_factory):
    """``cli.train --multichip`` in one process, its stdout and rows."""
    import contextlib
    import io

    out = str(tmp_path_factory.mktemp("cli_one"))
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        tcli.main(CLI_ARGS + ["--out", out])
    rows = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    return text.getvalue(), rows, out


def test_multichip_in_one_process_warns_and_trains(one_process_cli):
    text, rows, out = one_process_cli
    assert "warning: --multichip with a single device; ignoring" in text
    assert [r["step"] for r in rows] == [0, 1] and all(np.isfinite(r["loss"]) for r in rows)
    assert os.path.exists(os.path.join(out, "stage0", "avatar.pt"))


def test_cli_multichip_two_ranks(one_process_cli, tmp_path):
    _, want, _ = one_process_cli
    outs = [str(tmp_path / f"rank{r}") for r in (0, 1)]
    W.spawn(W.cli_train, 2, str(tmp_path), [CLI_ARGS + ["--out", o] for o in outs])
    rows = [json.loads(line) for line in open(os.path.join(outs[0], "metrics.jsonl"))]
    assert [r["step"] for r in rows] == [r["step"] for r in want]
    for got, ref in zip(rows, want):
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k] == pytest.approx(v, abs=1e-4), k
    assert os.path.exists(os.path.join(outs[0], "stage0", "avatar.pt"))
    assert not os.path.exists(outs[1])  # rank 1 writes nothing
