"""The training step replayed from CUDA graphs
(``soar_tpu_torch.render.graphs``) and what capture asked of the code the
step runs.

On the CPU: which steps take the graph path, the capture policy (a fake
capture), the renders a step counts toward the views' policy, the graphs
module's imports, the per-step scalars fed to the graphs against the
host's values, and the SSIM window's device constant.  The tests marked ``cuda``
run on the card (this file imports no JAX):

    python -m pytest tests/test_torch_train_graph.py --noconftest -q

They hold replayed steps against the eager path over several steps from
the same state and draws (every metric to the bit, the gradients to the
benchmark's program limits: the gathers' backward adds with atomics),
count the composite launches through their wrappers, and check host
syncs, memory and the counters.
"""

import ast
import dataclasses
import importlib.util
import itertools
import pickle
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from soar_tpu_torch.core import spans
from soar_tpu_torch.guidance.sds import GuidanceConfig, sample_timestep, timestep_window
from soar_tpu_torch.render import graphs as G
from soar_tpu_torch.train import config as P
from soar_tpu_torch.train import losses as L
from soar_tpu_torch.train.trainer import STEP_SCALARS, step_scalars

NV = 4


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(device, frames=3, size=48):
    """The synthetic sequence with normal maps (its renders stand in for
    them) and its avatar, hash field included."""
    from soar_tpu_torch.data.dataset import make_synthetic_sequence

    ds, (params, model) = make_synthetic_sequence(num_frames=frames, image_size=(size, size),
                                                  device=device)
    ds = dataclasses.replace(ds, normal_F=ds.images.copy(), normal_B=ds.images[..., ::-1].copy(),
                             normal_mask=ds.masks.copy())
    return ds, params, model


def _guided(tmp_path, device="cpu", size=48, gen=32, seed=1, **options):
    """A stage-1 ImageDream step at small shapes, with LPIPS on the normal
    terms, as the benchmark's training cell builds it.  Returns ``(run,
    step, state, nets)``: ``run()`` draws a frame's batch and the draws and
    takes one step; ``nets`` the guidance and the LPIPS module."""
    from soar_tpu_torch.guidance.build import build_guidance
    from soar_tpu_torch.render.types import RasterConfig
    from soar_tpu_torch.train.lpips import make_lpips_fn, mock_lpips_variables
    from soar_tpu_torch.train.trainer import (
        init_train_state,
        make_gt_batch_stack,
        make_train_step,
        sample_step_draws,
    )

    ds, params, model = _scene(device, size=size)
    path = tmp_path / "lpips.pkl"
    if not path.exists():
        with open(path, "wb") as f:
            pickle.dump(mock_lpips_variables(0), f)
    lpips_fn = make_lpips_fn(str(path), dtype=torch.float32, device=device)
    stage = P.stage1_config()
    tcfg = P.TrainConfig(n_views=NV)
    g = build_guidance("imagedream", stage,
                       generator=torch.Generator(device=device).manual_seed(0), mock=True,
                       tiny=True, image_size=32, n_view=NV, device=device)
    with torch.no_grad():
        ip = torch.stack([g.embed_ref(np.asarray(r, np.float32)) for r in ds.images_crop])
    g.release_image_encoder()
    state, opt = init_train_state(params, tcfg, seed=0, stage=stage)
    state.step = 1
    stacked, select, pos_of = make_gt_batch_stack(ds, model, ds.train_idx, ip_table=ip,
                                                  device=device)
    step = make_train_step(model, tcfg, stage, opt, gen_size=(gen, gen), gt_size=ds.image_size,
                           normal_size=(size, size), raster=RasterConfig(max_per_tile=32),
                           use_explicit=False, has_normals=True, has_normal_B=True,
                           guidance_fn=g, lpips_fn=lpips_fn, **options)
    draw_gen = torch.Generator(device=device).manual_seed(seed)
    frames = itertools.cycle(ds.train_idx)

    def inputs():
        batch = select(stacked, pos_of[next(frames)])
        return batch, sample_step_draws(draw_gen, tcfg, latent_size=g.latent_size)

    def run():
        return step(state, *inputs())[1]

    return run, step, state, types.SimpleNamespace(guidance=g, lpips=lpips_fn.net,
                                                   inputs=inputs)


def _kinds(step):
    return step.eager, step.captures, step.replays


# ------------------------------------------------------------ the path choice


class _OnCuda0(torch.Tensor):
    """A CPU tensor that reports cuda:0 as its device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_the_card(monkeypatch):
    """Stands in for the card in :func:`graphs.eligible`: the step's device
    and inputs read as cuda:0, every other condition as it is."""
    eligible = G.eligible
    monkeypatch.setattr(G, "eligible", lambda device, leaves: eligible(
        torch.device("cuda", 0), [t.as_subclass(_OnCuda0) for t in leaves]))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)


@pytest.mark.parametrize("case", ["plain", "cpu", "sharded", "remat", "traced", "hooked"])
def test_sharded_remat_traced_and_hooked_steps_run_eagerly(case, tmp_path, monkeypatch):
    """With the device check stood in for (the card's steps), a plain step
    takes the graph path; a CPU step, a sharded step, a remat step, a traced
    step and a step with a hook on the guidance each run eagerly."""
    from soar_tpu_torch.parallel import ViewMesh, view_sharder

    graphed = []

    def fake_step(policy, key, seg, x, counts):
        graphed.append(key)
        return seg.eager(x)

    monkeypatch.setattr(G, "run", fake_step)
    options = {"sharded": dict(shard_views=view_sharder(ViewMesh(None, 0, 1,
                                                                 torch.device("cpu")))),
               "remat": dict(remat_gen=True)}.get(case, {})
    run, _, _, nets = _guided(tmp_path, **options)
    if case != "cpu":
        _on_the_card(monkeypatch)
    handle = None
    if case == "hooked":
        handle = nets.guidance.unet.register_forward_hook(lambda *a: None)
    if case == "sharded":  # a one-process group for the sharder's gathers
        dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'group'}",
                                world_size=1, rank=0)
    try:
        with spans.tracing(case == "traced"):
            metrics = run()
            counted = spans.counters()
    finally:
        if case == "sharded":
            dist.destroy_process_group()
        if handle is not None:
            handle.remove()
    assert np.isfinite(float(metrics["loss"]))
    assert len(graphed) == (case == "plain"), case
    assert bool(counted) == (case == "traced")  # a traced step's counters read


class _FakeCapture:
    """Stands in for a capture: its replay runs the step's segments
    eagerly from the inputs the real one would copy in."""

    made = []

    def __init__(self, seg, x):
        self.seg, self.x = seg, x
        _FakeCapture.made.append(self)

    def run(self, flat):
        return self.seg.eager(G.rebuild(self.x, flat))


def test_policy_eager_then_capture_then_replay_and_a_new_key_after_a_new_leaf(tmp_path,
                                                                               monkeypatch):
    monkeypatch.setattr(G, "_Captured", _FakeCapture)
    _FakeCapture.made = []
    run, step, state, _ = _guided(tmp_path)
    _on_the_card(monkeypatch)
    kinds = []
    for _ in range(3):
        before = _kinds(step)
        run()
        kinds.append(tuple(b - a for a, b in zip(before, _kinds(step))))
    assert kinds == [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    assert len(_FakeCapture.made) == 1
    # A reallocated leaf is a new key: eager once, then captured again, and
    # the old capture is dropped (one held).
    state.params.occ = torch.nn.Parameter(state.params.occ.detach() * 0.5)
    for _ in range(3):
        before = _kinds(step)
        run()
        kinds.append(tuple(b - a for a, b in zip(before, _kinds(step))))
    assert kinds[3:] == [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    assert len(_FakeCapture.made) == 2
    # The capture replays what it was handed, the step inputs flattened.
    x = {"a": torch.ones(2), "b": {"c": torch.zeros(3)}}
    assert G.structure(x) == G.structure(pytree.tree_map(torch.clone, x))
    assert G.structure(x) != G.structure({"a": torch.ones(3), "b": {"c": torch.zeros(3)}})


def test_a_step_counts_its_renders_and_a_view_with_autograd_counts_one(tmp_path, monkeypatch):
    """The views' policy drops a capture unused over ``idle`` views rendered
    with autograd on; an eager step counts each of its renders (4 gen views,
    the GT pass and the normal pass), a view with autograd on counts one,
    and a view without counts none."""
    from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
    from soar_tpu_torch.train.trainer import make_gt_batch

    monkeypatch.setattr(G, "VIEWS", G.Policy())
    run, _, _, _ = _guided(tmp_path)
    run()
    assert G.VIEWS.grad_views == NV + 2
    ds, params, model = _scene("cpu")
    cam = make_gt_batch(ds, model, 0, device="cpu")["gt_cam"]
    for grad, count in ((True, NV + 3), (False, NV + 3)):
        with torch.set_grad_enabled(grad):
            render_view(params, model, cam, ds.image_size, torch.ones(3), 0, RenderSettings())
        assert G.VIEWS.grad_views == count


def test_graphs_imports_nothing_from_avatar_train_or_guidance():
    """The graphs module sits in the render layer: it imports torch, the
    spans and the composite's wrappers, and nothing above them."""
    path = G.__file__
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mod = importlib.util.resolve_name("." * node.level + (node.module or ""),
                                              "soar_tpu_torch.render")
            names += [f"{mod}.{a.name}" for a in node.names]
    ours = sorted(n for n in names if n.startswith("soar_tpu_torch"))
    assert ours == ["soar_tpu_torch.core.spans", "soar_tpu_torch.render.block_composite"], ours
    assert not [n for n in names if any(p in n.split(".") for p in ("avatar", "train",
                                                                    "guidance"))]


# ------------------------------------------------------ the per-step scalars


@pytest.mark.parametrize("stage", [P.StageConfig(), P.stage1_config()], ids=["stage0", "stage1"])
def test_step_scalars_equal_the_hosts_values_to_the_bit(stage):
    """Steps 0-2000 of both stages' configs: each weight as ``scheduled``
    gives it, the normal-consistency weight, ``after_sds``, and a timestep
    drawn from the fed window equal to the one drawn from the host's."""
    from soar_tpu_torch.avatar.optim import AvatarOptimizer

    w = stage.loss
    gcfg = GuidanceConfig(min_step_percent=stage.min_step_percent,
                          max_step_percent=stage.max_step_percent)
    u = torch.tensor([0.0, 1e-7, 0.25, 0.5, 0.73, 0.999, 1.0 - 2**-24])
    weights = ["recon", "mask", "normal_F", "normal_B", "normal_mask", "vgg", "occ", "curv",
               "scales", "delta", "sds"]
    for step in range(0, 2001):
        got = dict(zip(STEP_SCALARS, step_scalars(w, stage, step,
                                                  lambda s: timestep_window(gcfg, s))))
        for k in weights:
            assert got[k] == np.float32(P.scheduled(getattr(w, k), step)), (step, k)
        nc = P.scheduled(w.normal_consistency, step) + 0.1 * min(2.0 * step / 2000.0, 1.0)
        assert got["normal_consistency"] == np.float32(nc)
        assert got["after_sds"] == np.float32(step > stage.sds_start)
        window = (torch.tensor(got["min_step"]), torch.tensor(got["span"]))
        for ui in u:
            assert torch.equal(sample_timestep(gcfg, step, ui, window),
                               sample_timestep(gcfg, step, ui)), (step, float(ui))
    # Adam stays eager: the xyz learning rate it takes is the host's float.
    opt = types.SimpleNamespace(
        groups={}, count=0, xyz_schedule=AvatarOptimizer.__init__.__globals__[
            "expon_lr_schedule"](1.6e-4, 1.6e-5, lr_delay_mult=0.01, max_steps=1000),
        adam=types.SimpleNamespace(param_groups=[{"name": "xyz", "lr": 0.0}],
                                   step=lambda: None))
    for count in range(1, 2002):
        AvatarOptimizer.step(opt)
        assert opt.adam.param_groups[0]["lr"] == opt.xyz_schedule(count - 1)


def test_step_scalars_without_a_guidance_window_are_zero():
    got = dict(zip(STEP_SCALARS, step_scalars(P.LossWeights(), P.StageConfig(), 7)))
    assert got["min_step"] == 0.0 and got["span"] == 0.0 and got["after_sds"] == 0.0


# --------------------------------------------------------- the SSIM window


def test_ssim_window_constant_equals_the_literal_and_ssim_makes_no_tensor_from_python(
        monkeypatch):
    want = torch.from_numpy(L._gaussian_window(11, 1.5))
    got = L.constant(L._window_values(11, 1.5), torch.float32, "cpu")
    assert got.dtype == torch.float32 and torch.equal(got, want)
    g = torch.Generator().manual_seed(0)
    a, b = torch.rand(2, 24, 24, 3, generator=g).unbind(0)
    first = L.ssim(a, b)

    def refuse(*args, **kwargs):
        raise AssertionError("ssim made a tensor from Python data")

    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, refuse)
    assert torch.equal(L.ssim(a, b), first)


# --------------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _card_step(tmp_path, **kw):
    return _guided(tmp_path, device="cuda", size=128, gen=64, **kw)


def _leaves_and_moments(state):
    """Every optimised leaf with its Adam state."""
    return [(p, state.opt.adam.state.get(p, {})) for ps in state.opt.groups.values() for p in ps]


def _copy_state(dst, src):
    """``src``'s leaves and Adam state into ``dst``'s, in place."""
    with torch.no_grad():
        for (pd, sd), (ps, ss) in zip(_leaves_and_moments(dst), _leaves_and_moments(src)):
            pd.copy_(ps)
            for k, v in ss.items():
                sd[k].copy_(v)


@pytest.mark.cuda
def test_replayed_steps_equal_the_eager_path(tmp_path):
    """Five steps, one side eager throughout (a no-op hook on its LPIPS
    keeps it off the graphs), the other eager, captured, then replayed;
    before each step the eager side takes the graphed side's leaves and
    Adam state.  Every metric is equal to the bit (the forward is
    deterministic).  The gradients are not: the gathers' backward adds with
    atomics, so two eager steps from one state already differ in the last
    bits.  Adam's first moments, which both sides update from the same
    state, are held to the benchmark's program limits for the first
    gradients, and the parameters' changes to those for the changes
    (``benchmark/limits/soar_train_guided.json``: the median leaf's
    relative gap ``grad_gap`` 3e-3 and ``change_gap`` 6e-2, the worst
    leaf's ``grad_worst`` 0.12 and ``change_worst`` 0.25)."""
    _cuda()
    run_e, step_e, state_e, nets_e = _card_step(tmp_path)
    run_g, step_g, state_g, _ = _card_step(tmp_path)
    nets_e.lpips.register_forward_hook(lambda *a: None)

    def gaps(pairs):
        norms = [float(torch.linalg.norm(a)) for a, _ in pairs]
        med = float(np.median([n for n in norms if n > 0]))
        out = [float(torch.linalg.norm(b - a)) / max(n, med)
               for (a, b), n in zip(pairs, norms) if n >= 1e-3 * med]
        return float(np.median(out)), max(out)

    for i in range(5):
        _copy_state(state_e, state_g)
        start = [p.detach().clone() for p, _ in _leaves_and_moments(state_g)]
        m_e, m_g = run_e(), run_g()
        assert set(m_e) == set(m_g)
        for k in m_e:
            assert torch.equal(m_e[k], m_g[k]), (i, k, float(m_e[k]), float(m_g[k]))
        after = list(zip(_leaves_and_moments(state_e), _leaves_and_moments(state_g)))
        med, worst = gaps([(se["exp_avg"], sg["exp_avg"]) for (_, se), (_, sg) in after])
        assert med <= 3e-3 and worst <= 0.12, (i, med, worst)
        med, worst = gaps([(pe.detach() - p0, pg.detach() - p0)
                           for ((pe, _), (pg, _)), p0 in zip(after, start)])
        assert med <= 6e-2 and worst <= 0.25, (i, med, worst)
    # The hooked side never took the graph path: its steps are not counted.
    assert _kinds(step_e) == (0, 0, 0) and _kinds(step_g) == (1, 1, 3)
    assert float(m_g["loss_sds"]) > 0.0


@pytest.mark.cuda
def test_each_step_launches_13_forward_and_8_backward_composites_through_the_wrappers(
        tmp_path):
    _cuda()
    from soar_tpu_torch.render import block_composite as bc

    run, step, _, _ = _card_step(tmp_path)
    fwd, bwd = bc._launch_fwd, bc._launch_bwd
    seen = {"fwd": 0, "bwd": 0}

    def wrapped_fwd(*a):
        seen["fwd"] += 1
        return fwd(*a)

    def wrapped_bwd(*a):
        seen["bwd"] += 1
        return bwd(*a)

    bc._launch_fwd, bc._launch_bwd = wrapped_fwd, wrapped_bwd
    try:
        per_step = []
        for _ in range(5):
            before = dict(seen)
            run()
            per_step.append((seen["fwd"] - before["fwd"], seen["bwd"] - before["bwd"]))
    finally:
        bc._launch_fwd, bc._launch_bwd = fwd, bwd
    assert per_step == [(13, 8)] * 5
    assert _kinds(step) == (1, 1, 3)


@pytest.mark.cuda
def test_a_replayed_step_makes_no_host_sync(tmp_path):
    _cuda()
    run, step, _, _ = _card_step(tmp_path)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = run()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert _kinds(step) == (1, 1, 2)
    assert metrics["loss"].is_cuda


@pytest.mark.cuda
def test_capture_and_replay_stay_within_one_percent_of_the_eager_steps_memory(tmp_path):
    _cuda()
    run, step, _, _ = _card_step(tmp_path)
    peaks = []
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    eager, capture, *replays = peaks
    assert _kinds(step) == (1, 1, 2)
    assert capture <= 1.01 * eager and max(replays) <= 1.01 * eager, peaks


@pytest.mark.cuda
def test_a_live_graph_of_an_earlier_step_does_not_break_the_capture(tmp_path):
    """A loss kept after its backward keeps the parameters' gradient
    accumulators alive, made on the default stream; the capture reads the
    parameters through aliases and so never waits on that stream."""
    _cuda()
    run, step, state, nets = _card_step(tmp_path)
    loss, _, _ = step.loss_fn(state.params, state.bg_params, *nets.inputs(), state.step)
    loss.backward()
    state.opt.zero_grad()
    metrics = [run() for _ in range(3)]
    assert _kinds(step) == (1, 1, 1)
    assert all(torch.isfinite(m["loss"]) for m in metrics)
    assert loss.grad_fn is not None


@pytest.mark.cuda
def test_counters_read_the_eager_step_one_capture_and_the_replays_and_traced_steps_eager(
        tmp_path):
    _cuda()
    run, step, _, _ = _card_step(tmp_path)
    n = 6
    for _ in range(n):
        run()
    assert _kinds(step) == (1, 1, n - 2)
    with spans.tracing():
        run()
        ctr = spans.counters()
    assert _kinds(step) == (1, 1, n - 2)  # traced: the plain eager path, uncounted
    assert ctr["raster.keys"]["soar.raster.sort"] > 0  # its spans and counters read
    run()
    assert _kinds(step) == (1, 1, n - 1)
