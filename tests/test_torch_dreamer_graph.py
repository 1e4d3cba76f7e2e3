"""The GaussianDreamer loss step replayed from CUDA graphs
(``soar_tpu_torch.render.graphs``), on ``tests/torch_dreamer_helpers.py``'s
scene.

On the CPU: which steps take the graph path, the capture policy across a
densifying ``maintain`` and an annealed timestep window (a fake capture
that runs the step's segments eagerly from the inputs the real one copies
in: their losses and gradients equal the eager step's to the bit), the
step scalars the graphs read against the host's values, and ``maintain``
keeping the skinning weights' memory and the step's key.  The test marked ``cuda`` runs on the card (this file
imports no JAX):

    python -m pytest tests/test_torch_dreamer_graph.py --noconftest -q

It runs steps 98 to 101 across the densifying ``maintain`` at 100, one
side replayed and one eager, from one state before each step: the losses
equal to the bit, the gradients, changes and alive mask within the
benchmark's program limits (the gathers' backward adds with atomics), one
capture, and every composite launched through the wrappers.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import torch_dreamer_helpers as H
from test_torch_train_graph import _on_the_card
from soar_tpu_torch.avatar.renderer import avatar_key
from soar_tpu_torch.core import spans
from soar_tpu_torch.guidance.sds import GuidanceConfig, sample_timestep, timestep_window
from soar_tpu_torch.render import graphs as G
from soar_tpu_torch.render.tiled import composite_passes
from soar_tpu_torch.train import config as P
from soar_tpu_torch.train.systems import DREAMER_SCALARS, DREAMER_WEIGHTS, dreamer_scalars

STEPS = (98, 99, 100, 101)  # 100: densify_from, its maintain densifies
EXTENT = 3.0  # surfels on both sides of the clone/split scale
LIMITS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmark", "limits", "dreamer_train.json")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kinds(step):
    return step.eager, step.captures, step.replays


def _scene(device="cpu", steps=STEPS, **cfg):
    """The port's scene (``cfg`` to its ``DreamerConfig``) with a threshold
    that every seen surfel passes and an extent that splits some, and the
    draws of ``steps`` with the split's normals."""
    s = H.with_threshold(H.build("port", device, **cfg), 0.0, extent=EXTENT)
    draws, noise = H.draws(len(steps), s.params.xyz.shape[0], s.guidance.latent_size,
                           device=device)
    return s, draws, noise


def _step(s, draws, step):
    s.params, s.dstate, m = s.loss_step(s.params, s.dstate, s.pw, draws, step)
    return m


def _keep(s, step, noise):
    s.params, s.dstate, s.pw = s.maintain(s.params, s.dstate, s.pw, step, noise=noise)


# ------------------------------------------------------------ the path choice


@pytest.mark.parametrize("case", ["plain", "cpu", "traced", "hooked_unet", "hooked_vae",
                                  "autocast", "plain_composite"])
def test_the_step_takes_the_graph_path_only_when_eligible(case, monkeypatch):
    """With the device check stood in for (the card's steps), a plain step
    takes the graph path; a CPU step, a traced step, a step with a hook on
    the UNet or the VAE, one under the card's autocast and one with the
    plain composite each run eagerly, uncounted."""
    graphed = []

    def fake_run(policy, key, seg, x, counts):
        graphed.append(key)
        return seg.eager(x)

    monkeypatch.setattr(G, "run", fake_run)
    s, draws, _ = _scene()
    if case != "cpu":
        _on_the_card(monkeypatch)
    if case == "autocast":  # the card's autocast, which a CPU build cannot enter
        real = torch.is_autocast_enabled
        monkeypatch.setattr(torch, "is_autocast_enabled",
                            lambda *a: True if a == ("cuda",) else real(*a))
    if case.startswith("hooked"):
        net = s.guidance.unet if case == "hooked_unet" else s.guidance.vae
        net.register_forward_hook(lambda *a: None)
    if case == "plain_composite":
        cfg = dataclasses.replace(s.cfg, raster=dataclasses.replace(s.cfg.raster,
                                                                    composite="plain"))
        s.loss_step, _ = s.m.systems.make_gaussiandreamer_step(s.model, cfg, s.opt, s.guidance)
    with spans.tracing(case == "traced"):
        m = _step(s, draws[0], STEPS[0])
        spans.counters()  # read (and so reset) here: none left for a later test
    assert np.isfinite(float(m["loss"])) and set(m) == {"loss", "loss_sds"}
    assert len(graphed) == (case == "plain"), case
    assert _kinds(s.loss_step) == (0, 0, 0)


class _FakeCapture:
    """Stands in for a capture: its replay runs the step's segments eagerly
    from the inputs the real one would copy in (graph A, the composites,
    graph B, the backward), as :class:`graphs._Captured` splits them."""

    made = []
    raster = None  # the step's RasterConfig

    def __init__(self, seg, x):
        self.seg, self.x = seg, x
        _FakeCapture.made.append(self)

    def run(self, flat):
        xs = G.rebuild(self.x, flat)
        mid, passes, regs = self.seg.front(xs)
        results = [composite_passes(p, self.raster) for p in passes]
        loss, out = self.seg.back(xs, mid, results, regs)
        loss.backward()
        return {k: v.detach() for k, v in out.items()}


def test_eager_capture_replay_across_a_densify_with_the_eager_losses(monkeypatch):
    """Steps 98-101 with a densifying ``maintain`` after 100, then step 299:
    eager, captured, then replayed, one capture made; each step's losses
    equal to the bit those of an eager scene run alongside from the same
    state and draws, and so do its gradients (the CPU's composite adds in
    order).  Two weights are scheduled and the timestep window anneals
    (706 timesteps wide at 99, 656 at 299), so a capture that kept a
    step's numbers would differ."""
    monkeypatch.setattr(G, "_Captured", _FakeCapture)
    _FakeCapture.made = []
    steps = STEPS + (299,)
    loss = P.LossWeights(sds=(0, 0.1, 0.05, 1000), position=1.0, opacity=(0, 1e-3, 3e-3, 300),
                         scales=1e-3, tv=0.0)
    g, draws, noise = _scene(steps=steps, loss=loss)
    e, _, _ = _scene(steps=steps, loss=loss)
    _FakeCapture.raster = g.cfg.raster
    _on_the_card(monkeypatch)
    kinds = []
    for d, step in zip(draws, steps):
        before = _kinds(g.loss_step)
        m_g = _step(g, d, step)
        kinds.append(tuple(b - a for a, b in zip(before, _kinds(g.loss_step))))
        with spans.tracing():  # traced: the eager path
            m_e = _step(e, d, step)
            spans.counters()
        for k in ("loss", "loss_sds"):
            assert torch.equal(m_g[k], m_e[k]), (step, k, float(m_g[k]), float(m_e[k]))
        for k, p in H.leaves(g.opt).items():
            q = H.leaves(e.opt)[k]
            assert (p.grad is None) == (q.grad is None) and (
                p.grad is None or torch.equal(p.grad, q.grad)), (step, k)
        alive = g.dstate.alive.sum()
        _keep(g, step, noise)
        _keep(e, step, noise)
        assert torch.equal(g.dstate.alive, e.dstate.alive)
        if step == STEPS[2]:
            assert int(g.dstate.alive.sum()) > int(alive)  # densified
    assert kinds == [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 1), (0, 0, 1)]
    assert len(_FakeCapture.made) == 1


# ------------------------------------------------------ the per-step scalars


@pytest.mark.parametrize("weights", ["published", "scheduled"])
def test_step_scalars_equal_the_hosts_values_to_the_bit(weights):
    """Steps 0-2000: each weight as ``scheduled`` gives it and a timestep
    drawn from the fed window equal to the one drawn from the host's."""
    w = P.LossWeights(sds=0.1, position=1.0, opacity=1e-3, scales=1e-3, tv=0.0)
    if weights == "scheduled":
        w = P.LossWeights(sds=(0, 0.1, 0.01, 1000), position=(100, 1.0, 0.3, 700),
                          opacity=1e-3, scales=(0, 1e-3, 3e-3, 2000), tv=(0, 0.0, 0.5, 300))
    stage = P.StageConfig()
    gcfg = GuidanceConfig(min_step_percent=stage.min_step_percent,
                          max_step_percent=stage.max_step_percent)
    u = torch.tensor([0.0, 1e-7, 0.25, 0.5, 0.73, 0.999, 1.0 - 2**-24])
    for step in range(0, 2001):
        got = dict(zip(DREAMER_SCALARS, dreamer_scalars(w, step,
                                                        lambda s: timestep_window(gcfg, s))))
        for k in DREAMER_WEIGHTS:
            assert got[k] == np.float32(P.scheduled(getattr(w, k), step)), (step, k)
        assert (got["min_step"], got["span"]) == timestep_window(gcfg, step)
        window = (torch.tensor(got["min_step"]), torch.tensor(got["span"]))
        for ui in u:
            assert torch.equal(sample_timestep(gcfg, step, ui, window),
                               sample_timestep(gcfg, step, ui)), (step, float(ui))
    got = dreamer_scalars(w, 7)
    assert got[-2] == 0.0 and got[-1] == 0.0  # no window without a guidance's


def test_the_graphs_read_the_hosts_scalars_at_the_cells_steps(monkeypatch):
    """The device vector a step hands the graphs at steps 98, 100, 199 and
    299 (the window anneals over them): the host's weights and window."""
    seen = []

    def fake_run(policy, key, seg, x, counts):
        seen.append(x["sc"].clone())
        return seg.eager(x)

    monkeypatch.setattr(G, "run", fake_run)
    s, draws, _ = _scene()
    _on_the_card(monkeypatch)
    steps = (98, 100, 199, 299)
    for step in steps:
        _step(s, draws[0], step)
    w, window = s.cfg.loss, s.guidance.timestep_window
    assert window(steps[0]) != window(steps[2]) != window(steps[3])  # it anneals
    for step, sc in zip(steps, seen):
        got = dict(zip(DREAMER_SCALARS, sc.tolist()))
        assert sc.dtype == torch.float32
        for k in DREAMER_WEIGHTS:
            assert got[k] == np.float32(P.scheduled(getattr(w, k), step)), (step, k)
        assert (got["min_step"], got["span"]) == window(step), step


# --------------------------------------------------------------- maintain


def test_a_densify_keeps_the_skin_weights_memory_and_the_steps_key(monkeypatch):
    """A densifying ``maintain`` writes fresh ``knn_idw_weights`` into the
    weights' own tensor (equal to the bit), keeps every address the step's
    key reads, and so the key: the steps before and after it key alike."""
    keys = []

    def fake_run(policy, key, seg, x, counts):
        keys.append(key)
        return seg.eager(x)

    monkeypatch.setattr(G, "run", fake_run)
    s, draws, noise = _scene()
    _on_the_card(monkeypatch)
    pw, ptr = s.pw, s.pw.data_ptr()
    model_key = avatar_key(s.params, s.model)
    _step(s, draws[0], STEPS[2])
    alive = int(s.dstate.alive.sum())
    _keep(s, STEPS[2], noise)
    assert int(s.dstate.alive.sum()) > alive  # densified
    assert s.pw is pw and s.pw.data_ptr() == ptr
    fresh = s.m.skinning.knn_idw_weights(s.params.xyz, s.model.skin.cano_vertices,
                                         s.model.body.lbs_weights)
    assert torch.equal(s.pw, fresh)
    assert avatar_key(s.params, s.model) == model_key
    _step(s, draws[1], STEPS[3])
    assert len(keys) == 2 and keys[0] == keys[1]


# --------------------------------------------------------------- on the card


def _leaves_and_moments(s):
    return [(p, s.opt.adam.state.get(p, {})) for p in H.leaves(s.opt).values()]


def _copy_state(dst, src):
    """``src``'s leaves, Adam state, densify state and skin weights into
    ``dst``'s."""
    with torch.no_grad():
        for (pd, sd), (ps, ss) in zip(_leaves_and_moments(dst), _leaves_and_moments(src)):
            pd.copy_(ps)
            for k, v in ss.items():
                sd[k].copy_(v)
        dst.pw.copy_(src.pw)
    dst.opt.count = src.opt.count
    dst.dstate = type(src.dstate)(*(t.clone() for t in src.dstate))


def _norm_gaps(got, want):
    """``benchmark/runners/dreamer_step.Cell.gaps``' per-leaf gaps of two
    sets of norms: over the leaves that move (at least a thousandth of the
    median nonzero norm), |got - want| / max(want, that median); returns
    (median, worst)."""
    nz = [v for v in want.values() if v > 0.0]
    med = float(np.median(nz))
    moving = [k for k, v in want.items() if v > 0.0 and v >= 1e-3 * med]
    gaps = [abs(got[k] - want[k]) / max(want[k], med) for k in moving]
    return float(np.median(gaps)), max(gaps)


@pytest.mark.cuda
def test_replayed_steps_across_a_densify_hold_to_the_eager_ones():
    """Steps 98-101 and the densifying ``maintain`` at 100, one side
    replayed (eager, captured, then replayed), the other eager throughout
    (a no-op hook on its VAE keeps it off the graphs); before each step the
    eager side takes the replayed side's state.  The losses are equal to
    the bit (the forward is deterministic); each step's gradient norms and
    changes per leaf hold to ``benchmark/limits/dreamer_train.json``'s
    ``grad_gap`` / ``grad_worst`` and ``change_gap`` / ``change_worst``,
    and the alive mask after step 100's ``maintain`` to its ``alive_gap``.
    One capture is made, kept across the densify, and every step launches
    its 8 forward and 4 backward composites through the wrappers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from soar_tpu_torch.render import block_composite as bc

    with open(LIMITS) as f:
        lim = json.load(f)
    g, draws, noise = _scene("cuda")
    e, _, _ = _scene("cuda")
    e.guidance.vae.register_forward_hook(lambda *a: None)
    fwd, bwd = bc._launch_fwd, bc._launch_bwd
    seen = {"fwd": 0, "bwd": 0}

    def counted(kind, launch):
        def call(*a):
            seen[kind] += 1
            return launch(*a)
        return call

    bc._launch_fwd, bc._launch_bwd = counted("fwd", fwd), counted("bwd", bwd)
    launches = []
    try:
        for d, step in zip(draws, STEPS):
            _copy_state(e, g)
            start = {k: p.detach().clone() for k, p in H.leaves(g.opt).items()}
            m_e = _step(e, d, step)
            before = dict(seen)
            m_g = _step(g, d, step)
            launches.append((seen["fwd"] - before["fwd"], seen["bwd"] - before["bwd"]))
            for k in ("loss", "loss_sds"):
                assert torch.equal(m_e[k], m_g[k]), (step, k, float(m_e[k]), float(m_g[k]))

            def norms(s, of):
                return {k: float(torch.linalg.norm(of(k, p).float()))
                        for k, p in H.leaves(s.opt).items()}

            grad = _norm_gaps(norms(g, lambda k, p: p.grad), norms(e, lambda k, p: p.grad))
            assert grad[0] <= lim["grad_gap"] and grad[1] <= lim["grad_worst"], (step, grad)
            change = _norm_gaps(norms(g, lambda k, p: p.detach() - start[k]),
                                norms(e, lambda k, p: p.detach() - start[k]))
            assert change[0] <= lim["change_gap"] and change[1] <= lim["change_worst"], (
                step, change)
            if step == STEPS[2]:
                threshold, _ = H.gap_threshold(g)
                for s in (g, e):
                    H.with_threshold(s, threshold, extent=EXTENT)
                alive = int(g.dstate.alive.sum())
            _keep(g, step, noise)
            _keep(e, step, noise)
            if step == STEPS[2]:
                assert int(g.dstate.alive.sum()) > alive  # densified
                share = float((g.dstate.alive != e.dstate.alive).float().mean())
                assert share <= lim["alive_gap"], share
    finally:
        bc._launch_fwd, bc._launch_bwd = fwd, bwd
    assert launches == [(8, 4)] * len(STEPS)
    assert _kinds(g.loss_step) == (1, 1, len(STEPS) - 2)
    assert _kinds(e.loss_step) == (0, 0, 0)
    assert float(m_g["loss_sds"]) > 0.0
