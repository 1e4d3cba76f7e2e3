"""SOAR's stage-0 training step before its guidance starts (steps up to
``sds_start``), as ``cli.train --stage 0 --guidance imagedream`` builds it:
``StageConfig()``, LPIPS on the normal terms, the tiny ImageDream guidance
held and never called.

On the CPU the program's step (``soar_tpu_torch``) runs against the
benchmark's plain reference (``benchmark/reference/train/trainer.py``) from
the same seeded scene (the benchmark's inputs at a 4-joint body subdivided
once, a 4-level field, 3 frames of 48x48) and the same draws, at steps 1-3
and at ``sds_start`` itself.  Tolerances, each with its reason (the
reference's step under bf16 autocast, a precision below, fails both;
``test_the_control_fails``):

- losses: 1e-6 relative; the same float32 arithmetic on both sides (on the
  CPU the program composites with the plain PyTorch composite, LPIPS runs
  in float32 on both), summed in another order at most;
- gradients, per leaf, relative L2: 1e-4; the same float32 products through
  the renderer, LPIPS and the composite's autograd, which another CPU's
  kernels sum in another order, and at ``sds_start`` three Adam steps carry
  that into the state (step 500's hash-table gradient read 1.6e-5 on one
  host's CPU, 1.3e-6 on another's; the control's least per-leaf gap is 0.14).

The tests marked ``cuda`` run on the card (this file imports no JAX)::

    python -m pytest tests/test_torch_warm_step.py --noconftest -q

They hold the stage-0 step replayed from CUDA graphs
(``soar_tpu_torch.render.graphs``) against the eager path over steps 497
to 500 and the wrap back to step 1: one capture, every metric equal to the
bit, the gradients within the benchmark's program limits, 13 forward and 8
backward composite launches a step, no host sync in a replayed step, and
the field's hash encodes on the hash kernel at the eager and capture calls.
"""

import os
import types

import numpy as np
import pytest
import torch

from benchmark import cell as BC
from benchmark import scene

SMALL = {
    "body": {"num_joints": 4, "segments_per_bone": 3, "ring": 8, "num_betas": 4,
             "num_subdiv": 1},
    "field": {"num_levels": 4, "features_per_level": 2, "min_res": 16, "max_res": 128,
              "log2_hashmap_size": 10, "hidden_dim": 16, "num_layers": 2},
    "capture": {"frames": 3, "size": 48, "focal": 56.0, "transl": [0.0, 0.9, -2.8],
                "pose_std": 0.05, "gt_images": True},
}
SEED = 20261022
NV = 4
STEPS = (1, 2, 3, 500)  # 500: sds_start, the last step without guidance
LOSS_RTOL, GRAD_RTOL = 1e-6, 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _modules(side: str):
    if side == "port":
        from soar_tpu_torch.guidance import build
        from soar_tpu_torch.render import types as rtypes
        from soar_tpu_torch.train import config, trainer

        return types.SimpleNamespace(build=build, rtypes=rtypes, config=config,
                                     trainer=trainer, avatar=BC.program_avatar)
    from benchmark.reference.guidance import build
    from benchmark.reference.render import types as rtypes
    from benchmark.reference.train import config, trainer

    return types.SimpleNamespace(build=build, rtypes=rtypes, config=config, trainer=trainer,
                                 avatar=BC.reference_avatar)


def _lpips(side: str, dtype, device):
    state = scene.lpips_state(SEED, device)
    if side == "port":
        from soar_tpu_torch.train.lpips import make_lpips_fn

        path = scene.write_lpips_pickle(state)
        try:
            return make_lpips_fn(path, dtype=dtype, device=device)
        finally:
            os.remove(path)
    from benchmark.reference.train.lpips import LPIPS

    net = LPIPS(dtype).to(device)
    net.load_state_dict(state)
    net.eval().requires_grad_(False)

    def fn(a, b):
        return net(a[None], b[None])[0]

    fn.net = net
    return fn


def build(side: str, device="cpu", cfg=SMALL, gen=32, normal=48, lpips_dtype=torch.float32):
    """``side``'s ("port" or "reference") stage-0 step on the seeded scene
    with its state at step 1, the GT batch of each frame (with the front
    normal maps' ip tokens, stage 0's reference image), a draw function on
    a seeded generator, and the number of guidance calls so far."""
    m = _modules(side)
    dev = torch.device(device)
    sp, arrays = BC.inputs(cfg, SEED, dev)
    ds, params, model = m.avatar(cfg, SEED, sp, arrays, dev)
    stage = m.config.StageConfig()
    tcfg = m.config.TrainConfig(n_views=NV)
    g = m.build.build_guidance("imagedream", stage, generator=scene.generator(SEED, "unet", dev),
                               text_embeddings=scene.text_embeddings(SEED, 16, dev), tiny=True,
                               image_size=32, n_view=NV, device=dev)
    with torch.no_grad():
        ip = [g.embed_ref(torch.as_tensor(r, device=dev)) for r in ds.normal_F]
    g.release_image_encoder()
    calls = {"n": 0}

    def count(*_):
        calls["n"] += 1

    hooks = [g.unet.register_forward_hook(count), g.vae.register_forward_hook(count)]
    lpips_fn = _lpips(side, lpips_dtype, dev)
    state, opt = m.trainer.init_train_state(params, tcfg, seed=BC.init_seed(SEED), stage=stage)
    state.step = 1
    raster = m.rtypes.RasterConfig(max_per_tile=32)
    step = m.trainer.make_train_step(
        model, tcfg, stage, opt, gen_size=(gen, gen), gt_size=ds.image_size,
        normal_size=(normal, normal), raster=raster, use_explicit=False, has_normals=True,
        has_normal_B=True, guidance_fn=g, lpips_fn=lpips_fn)
    batches = [dict(m.trainer.make_gt_batch(ds, model, f, dev), ref_ip=ip[f])
               for f in range(cfg["capture"]["frames"])]
    gen_draws = torch.Generator(device=dev).manual_seed(SEED + 1)

    def draw():
        return m.trainer.sample_step_draws(gen_draws, tcfg, latent_size=g.latent_size)

    return types.SimpleNamespace(step=step, state=state, opt=opt, batches=batches, draw=draw,
                                 calls=calls, hooks=hooks, guidance=g, lpips=lpips_fn,
                                 stage=stage)


def leaves(opt):
    return {f"{g}.{i}": p for g, ps in opt.groups.items() for i, p in enumerate(ps)}


def _rel(a, b):
    a, b = a.detach().double().ravel(), b.detach().double().ravel()
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-30))


def _run(side: str, autocast: bool = False):
    """Steps 1, 2, 3, then the counter set to ``sds_start`` and one step
    more: each step's loss and metric keys, the gradients of steps 1 and
    500, and the guidance calls."""
    s = build("reference" if side == "control" else side)
    out = {"loss": [], "keys": [], "grad": {}}
    for i, at in enumerate(STEPS):
        s.state.step = at
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
            _, m = s.step(s.state, s.batches[i % len(s.batches)], s.draw())
        out["loss"].append(m["loss"])
        out["keys"].append(set(m))
        if at in (1, s.stage.sds_start):
            out["grad"][at] = {k: p.grad.clone() for k, p in leaves(s.opt).items()
                               if p.grad is not None and bool(p.grad.any())}
    out["calls"] = s.calls["n"]
    out["sds_start"] = s.stage.sds_start
    return out


@pytest.fixture(scope="module")
def runs():
    return _run("port"), _run("reference")


def test_the_reference_draws_as_the_program_does():
    draws = []
    for side in ("port", "reference"):
        m = _modules(side)
        gen = torch.Generator().manual_seed(SEED + 1)
        draws.append([m.trainer.sample_step_draws(gen, m.config.TrainConfig(n_views=NV),
                                                  latent_size=16) for _ in range(3)])
    for a, b in zip(*draws):
        for k in ("c2w", "fovy", "head", "rand_bg"):
            assert torch.equal(a[k], b[k]), k
        assert all(torch.equal(a["sds"][k], b["sds"][k]) for k in ("u", "noise", "vae_eps"))


def test_the_stage_is_the_published_one(runs):
    from soar_tpu_torch.train.config import StageConfig

    stage = StageConfig()
    assert (stage.training_stage, stage.sds_start, float(stage.loss.mask)) == (0, 500, 1.0)
    assert stage.max_step_percent == (0, 0.75, 0.25, 2000)
    assert runs[0]["sds_start"] == runs[1]["sds_start"] == STEPS[-1]


def test_losses_match(runs):
    port, ref = runs
    for at, a, b in zip(STEPS, port["loss"], ref["loss"]):
        assert abs(float(a) - float(b)) <= LOSS_RTOL * abs(float(b)), (at, float(a), float(b))


def test_gradients_match_per_leaf_at_the_first_step_and_at_sds_start(runs):
    port, ref = runs
    for at in (1, STEPS[-1]):
        assert set(port["grad"][at]) == set(ref["grad"][at]) >= {
            "xyz.0", "rotation.0", "occ.0", "field.0", "field_scales.0"}
        for k, want in ref["grad"][at].items():
            assert _rel(port["grad"][at][k], want) <= GRAD_RTOL, (at, k)


def test_neither_step_calls_the_guidance(runs):
    for side in runs:
        assert side["calls"] == 0
        assert all("loss_sds" not in keys for keys in side["keys"])
        assert all("loss_normal_B" in keys for keys in side["keys"])


def test_the_step_after_sds_start_calls_the_guidance():
    """The gate the tests above rely on, seen from its other side: the
    program's step 501 runs the UNet and the VAE and reports an SDS
    loss."""
    s = build("port")
    s.state.step = s.stage.sds_start + 1
    _, m = s.step(s.state, s.batches[0], s.draw())
    assert s.calls["n"] >= 2 and float(m["loss_sds"]) > 0.0


def test_the_control_fails(runs):
    """The reference's step a precision below (under bf16 autocast) misses
    the loss and the gradient tolerances."""
    _, ref = runs
    ctl = _run("control", autocast=True)
    assert max(abs(float(a) - float(b)) / abs(float(b))
               for a, b in zip(ctl["loss"], ref["loss"])) > LOSS_RTOL
    for at in (1, STEPS[-1]):
        assert max(_rel(ctl["grad"][at][k], ref["grad"][at][k])
                   for k in ref["grad"][at]) > GRAD_RTOL


# --------------------------------------------------------------- on the card


CARD = {**SMALL, "capture": {**SMALL["capture"], "size": 128, "focal": 150.0}}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _card_step():
    """The program's stage-0 step on the card, bf16 LPIPS as the benchmark
    runs it, without the guidance's counting hooks (a hook keeps a step off
    the graphs); ``run()`` takes one step on the next frame and draws and
    wraps the counter from ``sds_start`` back to 1."""
    s = build("port", device="cuda", cfg=CARD, gen=64, normal=128, lpips_dtype=torch.bfloat16)
    for h in s.hooks:
        h.remove()
    s.state.step = s.stage.sds_start - 3
    frames = iter(range(10**6))

    def run():
        _, m = s.step(s.state, s.batches[next(frames) % len(s.batches)], s.draw())
        if s.state.step > s.stage.sds_start:
            s.state.step = 1
        return m

    s.run = run
    return s


def _kinds(step):
    return step.eager, step.captures, step.replays


def _leaves_and_moments(state):
    return [(p, state.opt.adam.state.get(p, {})) for ps in state.opt.groups.values() for p in ps]


def _copy_state(dst, src):
    with torch.no_grad():
        for (pd, sd), (ps, ss) in zip(_leaves_and_moments(dst), _leaves_and_moments(src)):
            pd.copy_(ps)
            for k, v in ss.items():
                sd[k].copy_(v)


@pytest.mark.cuda
def test_replayed_stage0_steps_equal_the_eager_path():
    """Steps 497-500 and the wrap to step 1: one side eager throughout (a
    no-op hook on its LPIPS keeps it off the graphs), the other eager once,
    captured once, then replayed; before each step the eager side takes the
    graphed side's leaves and Adam state.  Every metric is equal to the bit;
    Adam's first moments and the parameters' changes are held to the
    benchmark's program limits (``benchmark/limits/soar_train_guided.json``:
    the median leaf's gap 3e-3 and 6e-2, the worst leaf's 0.12 and 0.25),
    since the gathers' backward adds with atomics."""
    _cuda()
    eager, graphed = _card_step(), _card_step()
    eager.lpips.net.register_forward_hook(lambda *a: None)

    def gaps(pairs):
        norms = [float(torch.linalg.norm(a)) for a, _ in pairs]
        med = float(np.median([n for n in norms if n > 0]))
        out = [float(torch.linalg.norm(b - a)) / max(n, med)
               for (a, b), n in zip(pairs, norms) if n >= 1e-3 * med]
        return float(np.median(out)), max(out)

    counters = []
    for i in range(5):
        _copy_state(eager.state, graphed.state)
        counters.append(graphed.state.step)
        start = [p.detach().clone() for p, _ in _leaves_and_moments(graphed.state)]
        m_e, m_g = eager.run(), graphed.run()
        assert set(m_e) == set(m_g) and "loss_sds" not in m_g
        for k in m_e:
            assert torch.equal(m_e[k], m_g[k]), (i, k, float(m_e[k]), float(m_g[k]))
        after = list(zip(_leaves_and_moments(eager.state), _leaves_and_moments(graphed.state)))
        med, worst = gaps([(se["exp_avg"], sg["exp_avg"]) for (_, se), (_, sg) in after])
        assert med <= 3e-3 and worst <= 0.12, (i, med, worst)
        med, worst = gaps([(pe.detach() - p0, pg.detach() - p0)
                           for ((pe, _), (pg, _)), p0 in zip(after, start)])
        assert med <= 6e-2 and worst <= 0.25, (i, med, worst)
    assert counters == [497, 498, 499, 500, 1]
    assert _kinds(eager.step) == (0, 0, 0) and _kinds(graphed.step) == (1, 1, 3)


@pytest.mark.cuda
def test_each_stage0_step_launches_13_forward_and_8_backward_composites():
    _cuda()
    from soar_tpu_torch.render import block_composite as bc

    s = _card_step()
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
            s.run()
            per_step.append((seen["fwd"] - before["fwd"], seen["bwd"] - before["bwd"]))
    finally:
        bc._launch_fwd, bc._launch_bwd = fwd, bwd
    assert per_step == [(13, 8)] * 5
    assert _kinds(s.step) == (1, 1, 3)


@pytest.mark.cuda
def test_a_replayed_stage0_step_makes_no_host_sync():
    _cuda()
    s = _card_step()
    for _ in range(3):
        s.run()
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = s.run()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert _kinds(s.step) == (1, 1, 2)
    assert metrics["loss"].is_cuda and "loss_sds" not in metrics


@pytest.mark.cuda
def test_stage0_steps_encode_the_field_with_the_hash_kernel():
    """The step's field query runs both hash encodes on the kernel at the
    eager and the capture call, and the backward of the one the loss reads
    (the shared features'; the quats' head is not rendered) gives the
    table's gradient; a replay adds no count and makes no host sync."""
    _cuda()
    from soar_tpu_torch.field import hashgrid

    def _hash_counts():
        e = hashgrid.hash_encode
        return e.kernel, e.kernel_bwd, e.eager

    s = _card_step()
    deltas = []
    for i in range(4):
        before = _hash_counts()
        mode = torch.cuda.get_sync_debug_mode()
        if i == 3:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            s.run()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        deltas.append(tuple(a - b for a, b in zip(_hash_counts(), before)))
    assert deltas == [(2, 1, 0), (2, 1, 0), (0, 0, 0), (0, 0, 0)]
    assert _kinds(s.step) == (1, 1, 2)
    grad = s.state.params.field.encoding.grad
    assert grad is not None and float(grad.abs().max()) > 0
    assert torch.equal(grad, grad.to(torch.bfloat16).to(torch.float32))
