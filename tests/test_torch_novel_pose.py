"""The avatar on an SMPL-X-sized body, reposed per request (the benchmark's
``soar_novel_pose`` cell, ``benchmark/runners/novel_pose.py``).

On the CPU: the body the benchmark writes in SMPL-X's ``.npz`` layout
(``benchmark/smplx_body.py``) has SMPL-X's tree and, at its published
layout, SMPL-X's vertex and face counts within 1%; the program reads it
through ``cli.common.load_body_model`` into the same arrays the reference's
own reader gives; and a reposed view at 64x64 (the small layout, about 2k
surfels, 4 frames of the cycle) from the program equals the reference's:
no covered pixel off by more than one level of 255 in any of the four
images, the turntable's rule (both sides compute in float32 on the CPU with
the plain composite, so they agree to the level).

The tests marked ``cuda`` run on the card (this file imports no JAX)::

    python -m pytest tests/test_torch_novel_pose.py --noconftest -q

They render the cell's own configuration over its 20-frame pose cycle
twice: one capture for the whole cycle, every later view a replay bit-equal
to the eager view of the same frame, two forward composite launches a view,
the field's two hash encodes on the kernel at the eager and capture calls
and none at a replay, and no host sync in a replayed view.
"""

import copy

import numpy as np
import pytest
import torch

from benchmark import harness, smplx_body
from benchmark.runners import novel_pose as N

SEED = 20261024
SMALL_FRAMES = (0, 3, 11, 19)


def _spec():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, mix, limits = harness.cell_spec(bench, "soar_novel_pose")
    return cfg, mix, limits


def small_config():
    """The cell's configuration at CPU size: the small tube layout
    subdivided once, a 4-level field, 64x64 images."""
    cfg, _, _ = _spec()
    cfg = copy.deepcopy(cfg)
    V, F = smplx_body.counts(smplx_body.SMALL_TUBES)
    cfg["body"].update(layout="small", vertices=V, faces=F, num_subdiv=1)
    cfg["surfels"] = 4 * V - 6 * len(smplx_body.SMALL_TUBES)  # one new vertex per edge
    cfg["field"].update(num_levels=4, max_res=128, log2_hashmap_size=10, hidden_dim=16)
    cfg["capture"].update(size=64, focal=75.0)
    return cfg


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_published_layout_has_smplx_counts_and_tree():
    V, F = smplx_body.counts()
    assert abs(V - smplx_body.SMPLX_VERTS) <= 0.01 * smplx_body.SMPLX_VERTS
    assert abs(F - smplx_body.SMPLX_FACES) <= 0.01 * smplx_body.SMPLX_FACES
    hands = smplx_body.hand_vertices() / V
    assert abs(hands - smplx_body.HANDS_SHARE) < 0.01, hands
    a = smplx_body.arrays(SEED)
    assert a["v_template"].shape == (V, 3) and a["f"].shape == (F, 3)
    assert a["shapedirs"].shape == (V, 3, 400) and a["posedirs"].shape == (V, 3, 486)
    assert a["kintree_table"][0, 0] == 4294967295
    assert tuple(a["kintree_table"][0, 1:]) == smplx_body.PARENTS[1:]
    np.testing.assert_allclose(a["weights"].sum(1), 1.0, atol=1e-6)
    np.testing.assert_allclose(a["J_regressor"].sum(1), 1.0, atol=1e-5)
    # Every joint moves vertices, and stands at its rest position.
    assert (a["weights"] > 0).any(0).all()
    np.testing.assert_allclose(a["J_regressor"] @ a["v_template"], smplx_body.rest_joints(),
                               atol=1e-5)
    # The expression directions touch the face alone.
    face = (a["weights"][:, list(smplx_body.FACE_JOINTS)].sum(1) > 0)
    assert not a["shapedirs"][~face, :, 300:].any() and a["shapedirs"][face, :, 300:].any()
    # The same seed writes the same body; the surfel count the cell states.
    assert all(np.array_equal(v, smplx_body.arrays(SEED)[k]) for k, v in a.items())
    cfg, _, _ = _spec()
    assert cfg["surfels"] == 16 * V - 30 * len(smplx_body.TUBES)
    assert (cfg["body"]["vertices"], cfg["body"]["faces"]) == (V, F)


def test_the_program_and_the_reference_read_the_same_body(tmp_path):
    from benchmark.reference.body.smplx_file import load_smplx_npz
    from soar_tpu_torch.cli.common import load_body_model

    path = smplx_body.write(SEED, smplx_body.SMALL_TUBES, str(tmp_path))
    prog = load_body_model(path, device="cpu")
    ref = load_smplx_npz(path, 10, 10, device="cpu")
    assert prog.parents == ref.parents == smplx_body.PARENTS
    for k in ("v_template", "shapedirs", "posedirs", "J_regressor", "lbs_weights", "faces",
              "pose_mean"):
        assert torch.equal(getattr(prog, k), getattr(ref, k)), k
    assert prog.shapedirs.shape[-1] == 20 and prog.posedirs.shape[0] == 486
    assert bool(prog.pose_mean[75:].any()) and not bool(prog.pose_mean[:75].any())


def test_a_reposed_view_equals_the_references():
    cfg, mix, limits = _spec()
    cell = N.Cell(small_config(), mix, SEED, torch.device("cpu"))
    try:
        assert cell.params.xyz.shape[0] < 2500
        got = {}
        for i in range(max(SMALL_FRAMES) + 1):
            imgs = cell.unit_call(keep=False)
            if i in SMALL_FRAMES:
                got[i] = imgs
    finally:
        cell.free()
    want = cell.reference_views(SMALL_FRAMES)
    readings = cell.readings(got, want, SMALL_FRAMES)
    assert readings == {k: 0.0 for k in limits}, readings
    assert all(float((got[i][3][..., 0] > 0).mean()) > 0.02 for i in SMALL_FRAMES)
    # The frames differ: each is its own pose.
    assert not np.array_equal(got[0][0], got[3][0])


# --------------------------------------------------------------- on the card


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture(scope="module")
def card_cell():
    """The cell's own configuration on the card (167,014 surfels, 512x512),
    set up and not warmed."""
    _cuda()
    cfg, mix, _ = _spec()
    cell = N.Cell(cfg, mix, SEED, torch.device("cuda"))
    yield cell
    cell.free()


@pytest.fixture
def fresh_policy(monkeypatch):
    from soar_tpu_torch.render import graphs as G

    monkeypatch.setattr(G, "VIEWS", G.Policy())


def _kinds():
    from soar_tpu_torch.avatar.renderer import render_view

    return render_view.eager, render_view.captures, render_view.replays


def _view(cell, i, grad=False):
    with torch.set_grad_enabled(grad):
        out = cell._render(i)
    return {k: out[k].detach() for k in ("render", "normal", "occ", "mask", "depth")}


@pytest.mark.cuda
def test_the_pose_cycle_captures_once_and_replays_bit_equal_to_eager(card_cell, fresh_policy):
    """Two passes over the 20 frames: the first view eager, the second
    captured, the other 38 replayed; each equal to the bit to the same
    frame's eager view (rendered with autograd on, which runs eagerly)."""
    before = _kinds()
    n = card_cell.n_views
    for i in list(range(n)) * 2:
        got = _view(card_cell, i)
        want = _view(card_cell, i, grad=True)
        for k in got:
            assert torch.equal(got[k], want[k]), (i, k)
    after = _kinds()
    # The eager views above ran with autograd on and do not count.
    assert (after[1] - before[1], after[2] - before[2]) == (1, 2 * n - 2)
    assert float((got["mask"] > 0.5).float().mean()) > 0.005  # the body is in view


@pytest.mark.cuda
def test_a_reposed_view_launches_two_composites_and_the_hash_kernel(card_cell, fresh_policy):
    from soar_tpu_torch.field import hashgrid
    from soar_tpu_torch.render import block_composite as bc

    def counts():
        return (bc.composite_block.launches, hashgrid.hash_encode.kernel,
                hashgrid.hash_encode.eager)

    deltas = []
    with torch.no_grad():
        for i in range(5):
            before = counts()
            card_cell._render(i)
            deltas.append(tuple(b - a for a, b in zip(before, counts())))
    assert deltas == [(2, 2, 0), (2, 2, 0), (2, 0, 0), (2, 0, 0), (2, 0, 0)]


@pytest.mark.cuda
def test_a_replayed_reposed_view_makes_no_host_sync(card_cell, fresh_policy):
    with torch.no_grad():
        for i in range(3):
            card_cell._render(i)
        torch.cuda.synchronize()
        kinds = _kinds()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(3, 6):
                out = card_cell._render(i)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    assert _kinds()[2] - kinds[2] == 3 and out["render"].is_cuda
