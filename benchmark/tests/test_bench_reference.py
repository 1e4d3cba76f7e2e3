"""The reference against the port at small shapes on the CPU: one run of
each cell, its numbers inside the cell's limits (on the CPU both sides run
the same plain composite, so they agree to the bit)."""

from benchmark.tests.small import run_small


def test_guided_step_matches_the_reference(bench):
    r = run_small(bench, "soar_train_guided")
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["checks"]) == {"loss_gap", "sds_gap", "grad_gap", "change_gap", "grad_worst",
                                "change_worst", "ip_gap"}
    assert list(r)[-1] == "checks"
    assert {"inputs", "avatar", "ip_tokens", "checked_steps"} <= set(r["notes"]["setup_stages_s"])
    assert r["notes"]["window_gc"]["collections"] >= 0
    assert set(r["metrics"]) == {"train_step_ms", "peak_mem_gib", "setup_s"}


def test_turntable_view_matches_the_reference(bench):
    r = run_small(bench, "soar_turntable")
    assert r["correct"], r["checks"]
    assert all(c["value"] == 0.0 for c in r["checks"].values())
    assert set(r["metrics"]) == {"view_ms", "view_p95_ms", "peak_mem_gib", "setup_s"}


def test_traced_run_reports_the_per_layer_metrics(bench):
    r = run_small(bench, "soar_turntable", trace=True)
    assert r["correct"]
    assert {"aten_ops.view", "mfu.view", "idle_share.view"} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def test_the_lpips_layout_is_the_reference_modules():
    from benchmark import scene
    from benchmark.reference.train.lpips import LPIPS

    assert scene.lpips_layout() == [(n, tuple(p.shape)) for n, p in LPIPS().named_parameters()]


def flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def test_the_program_and_the_reference_draw_alike():
    """The window's draws come from the program's ``sample_step_draws``; the
    reference's copy, on a generator seeded alike, draws the same."""
    import torch

    from benchmark import scene
    from benchmark.reference.train import config as R_config
    from benchmark.reference.train import trainer as R
    from soar_tpu_torch.train import config as P_config
    from soar_tpu_torch.train import trainer as P

    cpu = torch.device("cpu")
    for seed in (7, 2**31 + 5):
        gp, gr = scene.generator(seed, "feed", cpu), scene.generator(seed, "feed", cpu)
        for _ in range(3):
            a = P.sample_step_draws(gp, P_config.TrainConfig(head_prob=0.4), latent_size=4)
            b = R.sample_step_draws(gr, R_config.TrainConfig(head_prob=0.4), latent_size=4)
            flat_a, flat_b = flat(a), flat(b)
            assert flat_a.keys() == flat_b.keys()
            for k in flat_a:
                assert torch.equal(torch.as_tensor(flat_a[k]), torch.as_tensor(flat_b[k])), k
