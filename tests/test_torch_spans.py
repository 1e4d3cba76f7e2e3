"""The port's spans and counters (``soar_tpu_torch.core.spans``) on the
CPU: nothing dispatched with tracing off, profiler ranges with their parent
and unit id with tracing on, device counters read once, and the guided
training step and a turntable view emitting their layers' spans without a
change to a bit of their results.  ``test_item_counts_one_sync_against_its_span``
carries the ``cuda`` marker and runs on the card (``python -m pytest
tests/test_torch_spans.py --noconftest -q``: this file imports no JAX).
"""

import dataclasses
import pickle
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from soar_tpu_torch.core import spans


class _Ops(TorchDispatchMode):
    """The aten ops dispatched inside the block, by name."""

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


def _span_events(prof):
    return [e for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("soar.")]


def test_tracing_off_dispatches_nothing_and_shares_one_context():
    x = torch.ones(4)

    @spans.spanned("soar.field")
    def f(t):
        return t * 2.0

    assert not spans.on()
    with _Ops() as rec:
        with spans.span("soar.step", unit="step"):
            with spans.span("soar.field"):
                if spans.on():
                    spans.count("raster.keys_in_tiles", x.sum())
        y = f(x)
    assert rec.names == ["aten.mul.Tensor"]  # the function's own op alone
    assert torch.equal(y, x * 2.0)
    assert spans.span("soar.a") is spans.span("soar.b", unit="view")
    assert spans.counters() == {}


def test_spans_are_ranges_with_their_parent_and_unit():
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with spans.tracing():
            for _ in range(2):
                with spans.span("soar.step", unit="step"):
                    with spans.span("soar.field"):
                        torch.ones(8).mul(3.0)
                    with spans.span("soar.render", unit="view"):  # inside a step: no unit
                        torch.ones(8).add(1.0)
            with spans.span("soar.render", unit="view"):  # a view of its own
                torch.ones(8).sub(1.0)
    assert not spans.on()
    evs = sorted(_span_events(prof), key=lambda e: e.time_range.start)
    assert [e.name for e in evs] == ["soar.step", "soar.field", "soar.render"] * 2 + [
        "soar.render"]
    steps = [e for e in evs if e.name == "soar.step"]
    ids = [e.kwinputs["unit"] for e in steps]
    assert ids == ["step 0", "step 1"]  # numbered from 0 each time tracing turns on
    for e in evs[:6]:
        root = e if e.name == "soar.step" else e.cpu_parent
        assert root.name == "soar.step"
        assert e.kwinputs["unit"] == root.kwinputs["unit"]
    assert evs[-1].cpu_parent is None and evs[-1].kwinputs["unit"] == "view 0"
    # Every op runs inside the range that encloses it.
    ops = [e for e in prof.events() if e.name in ("aten::mul", "aten::add", "aten::sub")]
    assert {e.name: e.cpu_parent.name for e in ops} == {
        "aten::mul": "soar.field", "aten::add": "soar.render", "aten::sub": "soar.render"}
    for e in ops:
        p = e.cpu_parent.time_range
        assert p.start <= e.time_range.start and e.time_range.end <= p.end


def test_device_counters_are_read_only_at_counters():
    with spans.tracing():
        with _Ops() as rec:
            with spans.span("soar.raster.sort"):
                for k in range(3):
                    spans.count("raster.keys_in_tiles", torch.tensor(k + 1, dtype=torch.int32))
                    spans.count("raster.keys", 10)
            spans.count("raster.keys", 5)
        assert not any("_local_scalar_dense" in n or "item" in n for n in rec.names)
        # Synchronising-operation warnings count against the innermost span.
        with spans.span("soar.render"), spans.span("soar.field"):
            warnings.warn(spans.SYNC_MESSAGE)
            warnings.warn(spans.SYNC_MESSAGE)
        warnings.warn(spans.SYNC_MESSAGE)
        got = spans.counters()
    assert got == {"raster.keys_in_tiles": {"soar.raster.sort": 6},
                   "raster.keys": {"soar.raster.sort": 30, spans.OUTSIDE: 5},
                   "host_syncs": {"soar.field": 2, spans.OUTSIDE: 1}}
    assert spans.counters() == {}


def test_other_warnings_pass_through_tracing():
    seen = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda m, *a, **k: seen.append(str(m))
        with spans.tracing():
            warnings.warn("something else")
    assert seen == ["something else"]


# ------------------------------------------------------- the program's paths


def _scene(frames=3, size=48):
    """The synthetic sequence with normal maps (its renders stand in for
    them) and its avatar, hash field included."""
    from soar_tpu_torch.data.dataset import make_synthetic_sequence

    ds, (params, model) = make_synthetic_sequence(num_frames=frames, image_size=(size, size),
                                                  device="cpu")
    ds = dataclasses.replace(ds, normal_F=ds.images.copy(), normal_B=ds.images[..., ::-1].copy(),
                             normal_mask=ds.masks.copy())
    return ds, params, model


def _guided_step(tmp_path, nv=4):
    """A stage-1 ImageDream step at tiny shapes, with LPIPS on the normal
    terms, as the benchmark's training cell builds it; returns (run, state)
    with ``run()`` drawing and taking one step."""
    from soar_tpu_torch.guidance.build import build_guidance
    from soar_tpu_torch.render.types import RasterConfig
    from soar_tpu_torch.train import config as P
    from soar_tpu_torch.train.lpips import make_lpips_fn, mock_lpips_variables
    from soar_tpu_torch.train.trainer import (
        init_train_state,
        make_gt_batch_stack,
        make_train_step,
        sample_step_draws,
    )

    ds, params, model = _scene()
    path = tmp_path / "lpips.pkl"
    if not path.exists():
        with open(path, "wb") as f:
            pickle.dump(mock_lpips_variables(0), f)
    lpips_fn = make_lpips_fn(str(path), dtype=torch.float32, device="cpu")
    stage = P.stage1_config()
    tcfg = P.TrainConfig(n_views=nv)
    g = build_guidance("imagedream", stage, generator=torch.Generator().manual_seed(0),
                       mock=True, tiny=True, image_size=32, n_view=nv, device="cpu")
    with torch.no_grad():
        ip = torch.stack([g.embed_ref(np.asarray(r, np.float32)) for r in ds.images_crop])
    state, opt = init_train_state(params, tcfg, seed=0, stage=stage)
    state.step = 1
    stacked, select, pos_of = make_gt_batch_stack(ds, model, ds.train_idx, ip_table=ip,
                                                  device="cpu")
    step = make_train_step(model, tcfg, stage, opt, gen_size=(32, 32), gt_size=ds.image_size,
                           normal_size=(48, 48), raster=RasterConfig(max_per_tile=32),
                           use_explicit=False, has_normals=True, has_normal_B=True,
                           guidance_fn=g, lpips_fn=lpips_fn)
    gen = torch.Generator().manual_seed(1)
    frame = ds.train_idx[0]

    def run():
        draws = sample_step_draws(gen, tcfg, latent_size=g.latent_size)
        return step(state, select(stacked, pos_of[frame]), draws)

    return run, state


def _leaves(state):
    return [p.detach().clone() for ps in state.opt.groups.values() for p in ps]


def test_guided_step_emits_its_spans_and_keeps_every_bit(tmp_path):
    run_off, state_off = _guided_step(tmp_path)
    run_on, state_on = _guided_step(tmp_path)
    _, m_off = run_off()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.tracing():
            _, m_on = run_on()
            counts = spans.counters()
    calls = Counter(e.name for e in _span_events(prof))
    assert dict(calls) == {
        "soar.step": 1, "soar.draws": 1, "soar.batch": 1, "soar.field": 1, "soar.render": 6,
        "soar.pose": 6, "soar.pose.lbs": 6, "soar.pose.skin": 6, "soar.raster.preprocess": 6,
        "soar.raster.sort": 6,
        "soar.raster.gather": 6, "soar.composite": 13, "soar.losses": 1, "soar.lpips": 2,
        "soar.guidance": 1, "soar.backward": 1, "soar.optim": 1}
    # A sort's keys; those in tiles and the canaries, as the step reports them.
    keys = sum(counts["raster.keys"].values())
    in_tiles = sum(counts["raster.keys_in_tiles"].values())
    assert set(counts["raster.keys"]) == {"soar.raster.sort"}
    assert 0 < in_tiles < keys
    assert sum(counts["raster.dropped"].values()) == int(m_on["raster_dropped"])
    assert sum(counts["raster.capped"].values()) == int(m_on["raster_capped"])
    assert torch.equal(m_on["loss"], m_off["loss"])
    for a, b in zip(_leaves(state_on), _leaves(state_off)):
        assert torch.equal(a, b)


def test_view_is_a_unit_with_its_spans():
    from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
    from soar_tpu_torch.cli.render_rot import gt_camera

    ds, params, model = _scene(frames=2)
    cam = gt_camera(ds, 0, "cpu")

    def view():
        with torch.no_grad():
            return render_view(params, model, cam, ds.image_size, torch.ones(3), 0,
                               RenderSettings(use_explicit=False))

    off = view()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        with spans.tracing():
            on = view()
            counts = spans.counters()
    evs = _span_events(prof)
    assert Counter(e.name for e in evs) == {
        "soar.render": 1, "soar.pose": 1, "soar.pose.lbs": 1, "soar.pose.skin": 1,
        "soar.field": 1, "soar.raster.preprocess": 1, "soar.raster.sort": 1,
        "soar.raster.gather": 1, "soar.composite": 2}
    unit = next(e for e in evs if e.name == "soar.render").kwinputs["unit"]
    assert unit == "view 0" and all(e.kwinputs["unit"] == unit for e in evs)
    assert set(counts) == {"raster.keys", "raster.keys_in_tiles", "raster.dropped",
                           "raster.capped"}
    for k in ("render", "normal", "occ", "mask"):
        assert torch.equal(on[k], off[k])


@pytest.mark.cuda
def test_item_counts_one_sync_against_its_span():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.ones(16, device="cuda")
    with spans.tracing():
        with spans.span("soar.step", unit="step"):
            with spans.span("soar.field"):
                x.sum().item()
            x.mul(2.0)
        got = spans.counters()
    assert torch.cuda.get_sync_debug_mode() == 0
    assert got == {"host_syncs": {"soar.field": 1}}
