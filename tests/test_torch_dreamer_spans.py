"""The GaussianDreamer step's spans and counters on the CPU
(``tests/torch_dreamer_helpers.py``'s scene): one traced loss step is one
``step`` unit holding its views' spans and ``soar.guidance``,
``soar.losses``, ``soar.backward`` and ``soar.optim``; a densifying
``maintain`` is one ``soar.densify`` whose ``densify.*`` counters equal the
alive mask's change; with tracing off the step and ``maintain`` dispatch
the same aten ops as with the span calls patched out.
``test_a_step_and_its_draws_sync_nothing_on_the_card`` carries the
``cuda`` marker and runs on the card (``python -m pytest
tests/test_torch_dreamer_spans.py --noconftest -q``: this file imports no
JAX)."""

import contextlib
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

import torch_dreamer_helpers as H
from soar_tpu_torch.core import spans

STEP = 100  # densify_from: the step's maintain densifies


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene(device="cpu"):
    """The port's scene with a threshold that every seen surfel passes and
    an extent that splits some, and one step's draws and split normals."""
    s = H.with_threshold(H.build("port", device), 0.0, extent=3.0)
    draws, noise = H.draws(1, s.params.xyz.shape[0], s.guidance.latent_size, device=device)
    return s, draws[0], noise


def _unit(s, draws, noise):
    s.params, s.dstate, m = s.loss_step(s.params, s.dstate, s.pw, draws, STEP)
    s.params, s.dstate, s.pw = s.maintain(s.params, s.dstate, s.pw, STEP, noise=noise)
    return m


def _spans(prof):
    """(name, parent span name) of every ``soar.*`` range."""
    out = []
    for e in prof.events():
        if e.name.startswith("soar."):
            p = e.cpu_parent
            while p is not None and not p.name.startswith("soar."):
                p = p.cpu_parent
            out.append((e.name, None if p is None else p.name))
    return out


def test_a_step_is_one_unit_and_maintain_one_densify():
    s, draws, noise = _scene()
    before = int(s.dstate.alive.sum())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.tracing():
            _unit(s, draws, noise)
            units = dict(spans._S.units)
            counts = spans.counters()
    assert units == {"step": 1}  # the views nest in the step: no view unit
    got = _spans(prof)
    calls = Counter(name for name, _ in got)
    nv = s.cfg.n_views
    assert calls["soar.step"] == 1 and calls["soar.densify"] == 1
    assert calls["soar.render"] == nv and calls["soar.field"] == nv
    roots = [name for name, parent in got if parent is None]
    assert sorted(roots) == ["soar.densify", "soar.step"]
    for name in ("soar.render", "soar.guidance", "soar.losses", "soar.backward",
                 "soar.optim"):
        assert {parent for n, parent in got if n == name} == {"soar.step"}, name
    after = int(s.dstate.alive.sum())
    total = {k: sum(v.values()) for k, v in counts.items()}
    assert set(counts["densify.cloned"]) == {"soar.densify"}
    assert total["densify.cloned"] > 0 and total["densify.split"] > 0
    assert total["densify.cloned"] + total["densify.split"] == after - before
    assert "densify.pruned" not in total  # no prune before prune_from
    assert total["densify.alive"] == after


def test_a_prune_counts_what_it_took():
    s, draws, noise = _scene()
    H.with_threshold(s, 0.0, extent=3.0, prune_from=STEP, prune_interval=STEP)
    before = int(s.dstate.alive.sum())
    with spans.tracing():
        _unit(s, draws, noise)
        counts = spans.counters()
    after = int(s.dstate.alive.sum())
    total = {k: sum(v.values()) for k, v in counts.items()}
    assert total["densify.pruned"] > 0
    assert (total["densify.cloned"] + total["densify.split"] - total["densify.pruned"]
            == after - before)
    assert total["densify.alive"] == after


def test_tracing_off_dispatches_what_the_code_without_spans_does(monkeypatch):
    def no_count(*args, **kwargs):
        raise AssertionError("a counter's argument was computed with tracing off")

    monkeypatch.setattr(spans, "count", no_count)
    s, draws, noise = _scene()
    with _Ops() as traced_off:
        m = _unit(s, draws, noise)
    bare, draws, noise = _scene()
    monkeypatch.setattr(spans, "span", lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(spans, "on", lambda: False)
    _, bare.maintain = bare.m.systems.make_gaussiandreamer_step(bare.model, bare.cfg,
                                                                bare.opt, bare.guidance)
    bare.loss_step = bare.loss_step.__wrapped__  # the step without its root span
    with _Ops() as patched:
        m_bare = _unit(bare, draws, noise)
    assert traced_off.names == patched.names
    assert torch.equal(m["loss"], m_bare["loss"])
    assert torch.equal(s.dstate.alive, bare.dstate.alive)


@pytest.mark.cuda
def test_a_step_and_its_draws_sync_nothing_on_the_card():
    """A dreamer unit on CUDA, its draws included: no blocking copy or read
    anywhere (the cameras' literals are device constants)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    s, draws, noise = _scene("cuda")
    _unit(s, draws, noise)  # the constants are made once, on the first call
    with spans.tracing():
        draws, noise = H.draws(1, s.params.xyz.shape[0], s.guidance.latent_size,
                               device="cuda")
        _unit(s, draws[0], noise)
        counts = spans.counters()
    assert not counts.get("host_syncs"), counts.get("host_syncs")
    assert set(counts["densify.alive"]) == {"soar.densify"}
