"""A run with the timed path broken underneath comes out not correct (one
test a fault the cell can have), and the control, the reference a precision
below the configuration's, fails the limits the program passes."""

import torch

from benchmark import harness
from benchmark.tests.small import CONFIG_OF, run_small, small_config


def test_a_step_that_leaves_the_state_unchanged_is_caught(bench, monkeypatch):
    import soar_tpu_torch.train.trainer as T

    make = T.make_train_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)

        def still(state, batch, draws):
            _, metrics, _ = step.loss_fn(state.params, state.bg_params, batch, draws, state.step)
            return state, {k: v.detach() for k, v in metrics.items()}

        return still

    monkeypatch.setattr(T, "make_train_step", broken)
    r = run_small(bench, "soar_train_guided")
    assert not r["correct"]
    assert r["checks"]["grad_gap"]["value"] == 1.0


def test_a_step_over_half_of_its_views_is_caught(bench, monkeypatch):
    import soar_tpu_torch.guidance.build as B
    import soar_tpu_torch.train.trainer as T

    make, build = T.make_train_step, B.build_guidance

    def half_step(*args, **kwargs):
        step = make(*args, **dict(kwargs, n_views=2))

        def run(state, batch, draws):
            d = dict(draws, c2w=draws["c2w"][:2], fovy=draws["fovy"][:2],
                     sds=dict(draws["sds"], noise=draws["sds"]["noise"][:2],
                              vae_eps=draws["sds"]["vae_eps"][:2]))
            return step(state, batch, d)

        return run

    monkeypatch.setattr(T, "make_train_step", half_step)
    monkeypatch.setattr(B, "build_guidance", lambda *a, **k: build(*a, **dict(k, n_view=2)))
    r = run_small(bench, "soar_train_guided")
    assert not r["correct"], r["checks"]


def test_a_view_answered_with_another_azimuth_is_caught(bench, monkeypatch):
    import soar_tpu_torch.avatar.renderer as R
    from soar_tpu_torch.core.transforms import batch_rodrigues, rotmat_to_rotvec

    render = R.render_view

    def turned(*args, smpl_override=None, **kwargs):
        go = batch_rodrigues(smpl_override["global_orient"].reshape(1, 3))[0]
        c, s = torch.cos(torch.tensor(0.35)), torch.sin(torch.tensor(0.35))
        ry = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return render(*args, smpl_override={"global_orient": rotmat_to_rotvec(go @ ry)},
                      **kwargs)

    monkeypatch.setattr(R, "render_view", turned)
    r = run_small(bench, "soar_turntable")
    assert not r["correct"], r["checks"]


def control_fails(bench, workload):
    """The cell's program passes its limits and the control does not."""
    _, cfg, mix, limits = harness.cell_spec(bench, workload)
    cell = harness.runner(mix).Cell(small_config(CONFIG_OF[workload]), mix, 4242,
                                    torch.device("cpu"))
    if harness.runner(mix).UNIT == "step":
        cell.warmup()
    else:
        for _ in range(mix["views"]):
            cell.unit_call()
    cell.free()
    program, control = cell.check(), cell.control()
    assert all(program[k] <= limits[k] for k in limits), program
    assert any(control[k] > limits[k] for k in limits), control


def test_the_train_control_is_not_correct(bench):
    control_fails(bench, "soar_train_guided")


def test_the_turntable_control_is_not_correct(bench):
    control_fails(bench, "soar_turntable")
