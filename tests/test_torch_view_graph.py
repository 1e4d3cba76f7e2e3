"""A view replayed from CUDA graphs (``soar_tpu_torch.render.graphs``) and
the literals hoisted out of ``render_view`` so that it can be captured.

On the CPU: which views and steps take the graph path, the capture policy,
the keys, and the hoisted constants equal to the literals they replace.
The tests marked ``cuda`` run on the card (this file imports no JAX):

    python -m pytest tests/test_torch_view_graph.py --noconftest -q

They hold replayed views against the eager path to the bit, and check
ownership of the outputs, in-place updates, recapture, the composite
launches, host syncs and the counters.
"""

import math
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from soar_tpu_torch.avatar import renderer as R
from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
from soar_tpu_torch.core import spans
from soar_tpu_torch.core.camera import Camera
from soar_tpu_torch.core.constants import constant
from soar_tpu_torch.field import hashgrid
from soar_tpu_torch.render import graphs as G
from soar_tpu_torch.render.tilegrid import quantize_depth
from soar_tpu_torch.render.types import RasterConfig
from soar_tpu_torch.train import trainer

SETTINGS = {
    "turntable": RenderSettings(use_explicit=False),
    "lite": RenderSettings(use_explicit=False, lite=True),
    "both_faces": RenderSettings(use_explicit=False, both_faces=True),
    "gen_view": RenderSettings(use_explicit=True, gen_view=True),
}
LAUNCHES = {"turntable": 2, "lite": 1, "both_faces": 3, "gen_view": 2}


class _Ops(TorchDispatchMode):
    """The aten ops dispatched inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def _same(a, b) -> bool:
    """Equal to the bit (the back face's ``visible`` is None on both paths)."""
    return a is None and b is None or torch.equal(a, b)


def _scene(device, size=48, subdiv=1, frames=2, gen_view=False):
    """The procedural body's avatar (field included) and a camera that
    frames it (the body at z = -1.8, or a gen view's body at the origin):
    ``(params, model, camera, (H, W))``."""
    from soar_tpu_torch.avatar.state import init_avatar
    from soar_tpu_torch.body.model import make_test_body
    from soar_tpu_torch.core.camera import camera_from_c2w
    from soar_tpu_torch.field.attribute_field import AttributeFieldConfig
    from soar_tpu_torch.field.hashgrid import HashGridConfig

    rng = np.random.RandomState(0)
    body = make_test_body(num_joints=4, segments_per_bone=3, ring=8, device=device)
    sp = {
        "betas": np.zeros((1, body.num_betas), np.float32),
        "body_pose": (rng.randn(frames, 9) * 0.08).astype(np.float32),
        "global_orient": (rng.randn(frames, 3) * 0.05).astype(np.float32),
        "transl": np.tile([[0.0, 0.2, -1.8]], (frames, 1)).astype(np.float32),
    }
    field_cfg = AttributeFieldConfig(
        grid=HashGridConfig(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=12),
        hidden_dim=16)
    params, model = init_avatar(body, sp, num_subdiv=subdiv, field_cfg=field_cfg,
                                distill_steps=0, device=device)
    fov = 2 * math.atan(1 / 2.4)
    c2w = torch.eye(4, device=device)
    c2w[2, 3] = 2.5 if gen_view else 0.0
    cam = camera_from_c2w(c2w, fov, fov)
    return params, model, cam, (size, size)


# ------------------------------------------------------------ the path choice


def _inputs(device="cpu"):
    cam = Camera(*(torch.full((2,), float(i), device=device) for i in range(6)))
    fp = {"betas": torch.zeros(1, 4, device=device), "transl": torch.ones(1, 3, device=device)}
    return fp, cam, torch.ones(3, device=device), None


class _OnCuda0(torch.Tensor):
    """A CPU tensor that reports cuda:0 as its device."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _on_cuda0(tree):
    """``tree`` with its tensors stood in for by ones on cuda:0."""
    return G.rebuild(tree, [t.as_subclass(_OnCuda0) for t in G.leaves(tree)])


VIEW_CASES = ["cpu", "grad", "rows", "plain", "autocast", "capturing", "traced",
              "input_elsewhere", "other_device", "all_hold"]
STEP_CASES = ["cpu", "no_grad", "autocast", "capturing", "traced", "input_elsewhere",
              "other_device", "all_hold"]


def _view_graphed(case):
    """A view's choice: autograd off, the composite kernel and no rows,
    beside the shared conditions."""
    dev = torch.device("cpu") if case == "cpu" else torch.device("cuda", 0)
    params = types.SimpleNamespace(xyz=types.SimpleNamespace(device=dev))
    raster = RasterConfig(composite="plain") if case == "plain" else RasterConfig()
    inputs = _inputs() if case in ("cpu", "input_elsewhere") else _on_cuda0(_inputs())
    with torch.set_grad_enabled(case == "grad"):
        return R._graphed(params, inputs, RenderSettings(raster=raster),
                          object() if case == "rows" else None)


def _step_graphed(case):
    """A step's choice: autograd on, beside the shared conditions."""
    dev = torch.device("cpu") if case == "cpu" else torch.device("cuda", 0)
    x = {"batch": {"gt_rgb": torch.zeros(2)}, "sc": torch.zeros(3)}
    if case not in ("cpu", "input_elsewhere"):
        x = _on_cuda0(x)
    with torch.set_grad_enabled(case != "no_grad"):
        return trainer._graphed(dev, x)


@pytest.mark.parametrize("caller,case", [("view", c) for c in VIEW_CASES]
                         + [("step", c) for c in STEP_CASES])
def test_eligible_only_on_the_card_with_tracing_off_and_each_callers_autograd(caller, case,
                                                                              monkeypatch):
    """The shared conditions (:func:`graphs.eligible`: the current CUDA
    device with every input on it, autocast, tracing and capture off) and
    each caller's own: a view without autograd, with the composite kernel
    and no rows; a step with autograd."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: case == "capturing")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1 if case == "other_device" else 0)
    autocast = torch.is_autocast_enabled("cuda")
    torch.set_autocast_enabled("cuda", case == "autocast")
    try:
        with spans.tracing(case == "traced"):
            got = (_view_graphed if caller == "view" else _step_graphed)(case)
    finally:
        torch.set_autocast_enabled("cuda", autocast)
    assert got == (case == "all_hold")


@pytest.mark.parametrize("grad", [False, True])
def test_cpu_views_run_eagerly(grad, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU view took the graph path")

    monkeypatch.setattr(G, "run", refuse)
    params, model, cam, size = _scene("cpu")
    with torch.set_grad_enabled(grad):
        out = render_view(params, model, cam, size, torch.ones(3), 0, SETTINGS["turntable"])
    assert out["render"].shape == size + (3,) and out["render"].requires_grad == grad


def test_policy_captures_a_key_on_its_second_call():
    pol = G.Policy()
    assert pol.lookup("a") == (None, "eager")
    assert pol.lookup("a") == (None, "capture")
    made = object()
    pol.hold("a", made)
    assert pol.lookup("a") == (made, "replay")
    assert pol.lookup("b") == (None, "eager")  # a one-off never captures
    assert list(pol.graphs) == ["a"]


def test_policy_holds_two_captures_least_recently_used_first_out():
    pol = G.Policy(held=2)
    for n, key in enumerate("abc"):
        pol.lookup(key)
        assert pol.lookup(key)[1] == "capture"
        pol.hold(key, n)
    assert list(pol.graphs) == ["b", "c"]  # "a" dropped first
    pol.lookup("b")  # b used: c is now the oldest
    assert pol.lookup("a") == (None, "capture")  # a seen before: captured again at once
    pol.hold("a", 3)
    assert list(pol.graphs) == ["b", "a"] and pol.graphs["a"] == 3


def test_policy_remembers_a_bounded_number_of_one_offs():
    pol = G.Policy(held=2, remembered=3)
    for key in range(5):
        pol.lookup(key)
    assert list(pol.seen) == [2, 3, 4]
    assert pol.lookup(0)[1] == "eager"  # forgotten: eager again
    assert pol.lookup(4)[1] == "capture"


def test_policy_drops_a_capture_unused_over_idle_grad_views():
    """A training process's validation view is dropped after ``idle``
    training views without it; a view replayed in every step is kept."""
    pol = G.Policy(idle=4)
    for key in ("val", "sds"):
        pol.lookup(key), pol.lookup(key)
        pol.hold(key, key)
    for step in range(10):
        assert pol.lookup("sds") == ("sds", "replay")  # split SDS: no grad, every step
        for _ in range(3):  # the step's views with autograd on
            pol.grad_view()
        assert ("val" in pol.graphs) == (step == 0)
    assert list(pol.graphs) == ["sds"]
    assert pol.lookup("val") == (None, "capture")  # the next validation captures again


def test_inputs_flatten_and_key_by_address_only_where_held():
    params, model, _, _ = _scene("cpu")
    inputs = _inputs()
    leaves = G.leaves(inputs)
    assert len(leaves) == 9
    back = G.rebuild(inputs, [t.clone() for t in leaves])
    assert isinstance(back[1], Camera) and back[3] is None
    assert all(torch.equal(a, b) and a is not b for a, b in zip(leaves, G.leaves(back)))
    attrs = {"colors": torch.zeros(5, 3)}
    with_attrs = inputs[:3] + (attrs,)
    assert G.rebuild(with_attrs, G.leaves(with_attrs))[3] == attrs

    def key(inputs):
        """What a view's capture is keyed by (:func:`graphs.run`)."""
        return (((48, 48), RenderSettings(), R.avatar_key(params, model)), G.structure(inputs),
                G.tf32_key())

    # Copied inputs key by shape and dtype, not by address or value ...
    assert key(inputs) == key(_inputs()) == key(back)
    assert key(inputs) != key(with_attrs)
    # ... what is read in place by address: a replaced tensor is a new key.
    before = key(inputs)
    params.occ = torch.nn.Parameter(params.occ.detach() * 0.5)
    assert key(inputs) != before
    before = key(inputs)
    model.skin.point_weights.mul_(1.0)  # in place: the same key
    assert key(inputs) == before


# ---------------------------------------------------------- hoisted literals


@pytest.mark.parametrize("values,dtype", [
    (hashgrid.HashGridConfig().resolutions(), torch.float32),
    (hashgrid._CORNERS, torch.int64),
    (R._PERMUTE_T, torch.float32),
    (R._FLIP, torch.get_default_dtype()),
    ((0.0, 0.0, 0.0, 1.0), torch.float32),
    ((0.0, 0.3, 0.0), torch.get_default_dtype()),
    ((-1, 0, 1, 1), torch.int64),
])
def test_constant_equals_the_literal_and_is_made_once(values, dtype):
    got = constant(values, dtype, "cpu")
    want = torch.tensor(values, dtype=dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert constant(values, dtype, torch.device("cpu")) is got
    with torch.inference_mode():
        fresh = constant(values + values[:1], dtype, "cpu")
    assert not fresh.is_inference()


def test_quantize_depth_keeps_the_tensor_infinity_form():
    g = torch.Generator().manual_seed(3)
    depth = torch.randn(257, generator=g) * 4.0
    depth[::17] = float("nan")
    valid = torch.rand(257, generator=g) > 0.3
    for db in (8, 20, 26):
        inf = torch.tensor(float("inf"))
        dmin = torch.min(torch.where(valid, depth, inf))
        dmax = torch.max(torch.where(valid, depth, -inf))
        span = torch.clamp_min(dmax - dmin, 1e-8)
        q = torch.clamp_min((depth - dmin) / span * (2.0**db - 1.0), 0.0)
        q = torch.nan_to_num(q, nan=0.0).clamp_max(2.0**32 - 1.0)
        want = torch.clamp_max(q.to(torch.int64), 2**db - 1)
        assert torch.equal(quantize_depth(depth, valid, db), want)


@pytest.mark.parametrize("name", list(SETTINGS))
def test_render_view_makes_no_tensor_from_python_data(name):
    """Once the constants exist, a view turns no Python literal into a
    tensor (``lift_fresh``: what is a blocking host copy on CUDA), and its
    outputs stay the same to the bit."""
    params, model, cam, size = _scene("cpu")
    st = SETTINGS[name]
    ov = {"global_orient": torch.full((1, 3), 0.1)}
    with torch.no_grad():
        first = render_view(params, model, cam, size, torch.ones(3), 1, st, smpl_override=ov)
        with _Ops() as rec:
            second = render_view(params, model, cam, size, torch.ones(3), 1, st, smpl_override=ov)
    assert "aten.lift_fresh.default" not in rec.names
    pairs = zip(first, second) if st.both_faces else [(first, second)]
    for a, b in pairs:
        assert set(a) == set(b) and all(_same(a[k], b[k]) for k in a)


# --------------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture
def fresh_policy(monkeypatch):
    monkeypatch.setattr(G, "VIEWS", G.Policy())


def _turn(i, n=36):
    from soar_tpu_torch.core.transforms import rotmat_to_rotvec

    a = 2.0 * math.pi * i / n
    c, s = math.cos(a), math.sin(a)
    Ry = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], device="cuda")
    return {"global_orient": rotmat_to_rotvec(Ry)}


def _outs(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SETTINGS))
def test_replayed_views_equal_the_eager_path_to_the_bit(name, fresh_policy):
    _cuda()
    st = SETTINGS[name]
    params, model, cam, size = _scene("cuda", size=128, subdiv=3, gen_view=st.gen_view)
    assert params.xyz.shape[0] > 3000
    bg = torch.ones(3, device="cuda")
    replays = render_view.replays
    for i in range(36):
        with torch.no_grad():
            got = render_view(params, model, cam, size, bg, 0, st, smpl_override=_turn(i))
        with torch.enable_grad():
            want = render_view(params, model, cam, size, bg, 0, st, smpl_override=_turn(i))
        for g, w in zip(_outs(got), _outs(want)):
            assert set(g) == set(w)
            for k in g:
                assert _same(g[k], w[k] if w[k] is None else w[k].detach()), (name, i, k)
    assert render_view.replays - replays == 34  # the first call eager, the second captured
    assert float(_outs(got)[0]["mask"].sum()) > 100  # the body is in view


@pytest.mark.cuda
def test_outputs_are_the_callers_own(fresh_policy):
    _cuda()
    params, model, cam, size = _scene("cuda", size=128, subdiv=3)
    bg = torch.ones(3, device="cuda")
    with torch.no_grad():
        views = [render_view(params, model, cam, size, bg, 0, SETTINGS["turntable"],
                             smpl_override=_turn(i)) for i in range(4)]
        again = render_view(params, model, cam, size, bg, 0, SETTINGS["turntable"],
                            smpl_override=_turn(2))
    a, b = views[2], views[3]  # two successive replays
    for k in a:
        assert a[k].data_ptr() != b[k].data_ptr()
        assert torch.equal(a[k], again[k])  # not overwritten by the later replay
    assert not torch.equal(a["render"], b["render"])


@pytest.mark.cuda
def test_in_place_update_shows_and_a_replaced_tensor_recaptures(fresh_policy):
    _cuda()
    params, model, cam, size = _scene("cuda", size=128, subdiv=3)
    bg = torch.ones(3, device="cuda")
    st = SETTINGS["turntable"]

    def view(grad=False):
        with torch.set_grad_enabled(grad):
            out = render_view(params, model, cam, size, bg, 0, st, smpl_override=_turn(5))
        return {k: v.detach() for k, v in out.items()}

    view(), view()
    before = view()
    with torch.no_grad():
        params.field.mlp_shs[-1].bias.add_(0.5)  # what an optimizer step does
    n = (render_view.eager, render_view.captures, render_view.replays)
    after = view()
    assert (render_view.eager, render_view.captures, render_view.replays) == (n[0], n[1], n[2] + 1)
    assert not torch.equal(before["render"], after["render"])
    assert all(torch.equal(after[k], v) for k, v in view(grad=True).items())

    params.occ = torch.nn.Parameter(params.occ.detach() * 0.5)  # a new tensor
    view(), view()
    assert (render_view.eager, render_view.captures) == (n[0] + 1, n[1] + 1)
    assert all(torch.equal(view()[k], v) for k, v in view(grad=True).items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SETTINGS))
def test_each_replay_launches_its_composites_through_the_wrapper(name, fresh_policy):
    """Every call of a key, from its first (eager) through its capture to
    its replays, launches each composite once, through the wrapper."""
    _cuda()
    from soar_tpu_torch.render import block_composite as bc

    params, model, cam, size = _scene("cuda", size=128, subdiv=3,
                                      gen_view=SETTINGS[name].gen_view)
    bg = torch.ones(3, device="cuda")
    seen = []
    launch = bc._launch_fwd

    def wrapped(feat, pixf, *rest):
        seen.append(feat.shape)
        return launch(feat, pixf, *rest)

    kinds = []
    with torch.no_grad():
        before = bc.composite_block.launches
        bc._launch_fwd = wrapped
        try:
            for i in range(5):
                n = (render_view.eager, render_view.captures, render_view.replays)
                render_view(params, model, cam, size, bg, 0, SETTINGS[name],
                            smpl_override=_turn(i))
                kinds.append(tuple(b - a for a, b in zip(n, (
                    render_view.eager, render_view.captures, render_view.replays))))
                assert len(seen) == (i + 1) * LAUNCHES[name], (name, i)
        finally:
            bc._launch_fwd = launch
    assert kinds == [(1, 0, 0), (0, 1, 0)] + [(0, 0, 1)] * 3
    assert bc.composite_block.launches - before == 5 * LAUNCHES[name]


@pytest.mark.cuda
def test_a_replayed_view_makes_no_host_sync(fresh_policy):
    _cuda()
    params, model, cam, size = _scene("cuda", size=128, subdiv=3)
    bg = torch.ones(3, device="cuda")
    ovs = [_turn(i) for i in range(3)]
    with torch.no_grad():
        render_view(params, model, cam, size, bg, 0, SETTINGS["turntable"], smpl_override=ovs[0])
        render_view(params, model, cam, size, bg, 0, SETTINGS["turntable"], smpl_override=ovs[1])
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = render_view(params, model, cam, size, bg, 0, SETTINGS["turntable"],
                              smpl_override=ovs[2])
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    assert out["render"].is_cuda


@pytest.mark.cuda
def test_counters_read_the_warm_up_one_capture_and_the_replays(fresh_policy):
    _cuda()
    params, model, cam, size = _scene("cuda", size=128, subdiv=3)
    bg = torch.ones(3, device="cuda")
    n = 6
    before = (render_view.eager, render_view.captures, render_view.replays)
    with torch.no_grad():
        for i in range(n + 1):
            render_view(params, model, cam, size, bg, 0, SETTINGS["turntable"],
                        smpl_override=_turn(i))
    after = (render_view.eager, render_view.captures, render_view.replays)
    assert tuple(b - a for a, b in zip(before, after)) == (1, 1, n - 1)


@pytest.mark.cuda
def test_a_traced_view_runs_eagerly_with_its_spans(fresh_policy):
    """With tracing on, a view whose key is held runs eagerly: its spans
    and counters read as in any other view, and no host sync is added."""
    _cuda()
    params, model, cam, size = _scene("cuda", size=128, subdiv=3)
    bg = torch.ones(3, device="cuda")
    st = SETTINGS["turntable"]
    ov = _turn(3)
    with torch.no_grad():
        for i in range(3):
            want = render_view(params, model, cam, size, bg, 0, st, smpl_override=ov)
        assert len(G.VIEWS.graphs) == 1
        before = (render_view.eager, render_view.captures, render_view.replays)
        with spans.tracing():
            got = [render_view(params, model, cam, size, bg, 0, st, smpl_override=ov)
                   for _ in range(3)]
            ctr = spans.counters()
    assert (render_view.eager, render_view.captures, render_view.replays) == before
    assert ctr["raster.keys"]["soar.raster.sort"] > 0
    assert not ctr.get("host_syncs")
    for g in got:
        assert all(_same(g[k], want[k]) for k in want)


def _hash_counts():
    """The hash kernel's forward and backward launches and the plain calls."""
    e = hashgrid.hash_encode
    return e.kernel, e.kernel_bwd, e.eager


@pytest.mark.cuda
def test_a_views_field_query_launches_the_hash_kernel_at_eager_and_capture_calls(fresh_policy):
    """The view's two hash encodes (the shared features and the quats') run
    the kernel's forward, never the plain version; a replay adds no count,
    since the counters move where Python runs, and makes no host sync."""
    _cuda()
    params, model, cam, size = _scene("cuda", size=128, subdiv=3)
    bg = torch.ones(3, device="cuda")
    ovs = [_turn(i) for i in range(4)]
    deltas = []
    with torch.no_grad():
        for i in range(4):
            before = _hash_counts()
            mode = torch.cuda.get_sync_debug_mode()
            if i == 3:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
            try:
                render_view(params, model, cam, size, bg, 0, SETTINGS["turntable"],
                            smpl_override=ovs[i])
            finally:
                torch.cuda.set_sync_debug_mode(mode)
            deltas.append(tuple(a - b for a, b in zip(_hash_counts(), before)))
    assert deltas == [(2, 0, 0), (2, 0, 0), (0, 0, 0), (0, 0, 0)]
