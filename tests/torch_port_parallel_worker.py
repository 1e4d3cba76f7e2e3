"""Rank workers for ``tests/test_torch_port_parallel.py``.

``torch.multiprocessing.spawn`` starts each rank in a fresh interpreter that
imports this module and nothing of the suite: no JAX and no conftest.  A
rank runs on one CPU thread, joins a gloo group through a ``file://`` store
under the test's temporary directory (so concurrent test workers never
share a port), does its work and writes its result with ``torch.save``.

:func:`run_step` is also what the test runs in its own process for the
unsharded port step: one definition of the step's set-up for both.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist


def _join(rank: int, world: int, init_file: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world)


def run_step(spec, mesh=None):
    """One port train step from ``spec`` (numpy avatar and dataset, the
    draws, the JAX background, the step's options); with ``mesh``, both
    sharders of it and the state replicated from rank 0.  Returns the
    metrics, the gradients the optimizer stepped on, and the updated
    ``xyz`` and ``colors``."""
    from soar_tpu_torch.data.dataset import AvatarDataset
    from soar_tpu_torch.io.from_jax import avatar_from_numpy, background_from_numpy
    from soar_tpu_torch.parallel import replicate, row_sharder, view_sharder
    from soar_tpu_torch.render.types import RasterConfig
    from soar_tpu_torch.train import config as tconfig
    from soar_tpu_torch.train import trainer as ttr

    params, model = avatar_from_numpy(*spec["avatar"], device="cpu")
    ds = AvatarDataset(**spec["dataset"])
    cfg = tconfig.TrainConfig(**spec["train_cfg"])
    stage = tconfig.StageConfig(loss=tconfig.LossWeights(**spec["loss"]),
                                sds_start=spec["sds_start"])
    state, opt = ttr.init_train_state(params, cfg, stage=stage)
    state.bg_params = background_from_numpy(spec["bg"], "cpu")
    state.step = spec["step"]
    shard = {}
    if mesh is not None:
        shard = dict(shard_views=view_sharder(mesh), shard_gt=row_sharder(mesh))
        replicate(mesh, [state.params, state.bg_params, state.opt])
    g, draws, out = None, spec["draws"], {}
    if spec.get("guidance"):
        # Split SDS with tiny random networks: the prelude's gen renders are
        # sharded like the step's.
        from soar_tpu_torch.guidance.build import build_guidance

        g = build_guidance(spec["guidance"], stage, generator=torch.Generator().manual_seed(5),
                           tiny=True, image_size=32, n_view=cfg.n_views, device="cpu")
        gen = torch.Generator().manual_seed(6)
        shape = (cfg.n_views, g.latent_size, g.latent_size, 4)
        draws = dict(draws, sds={"u": torch.rand((), generator=gen),
                                 "noise": torch.randn(shape, generator=gen),
                                 "vae_eps": torch.randn(shape, generator=gen)})
    step = ttr.make_train_step(model, cfg, stage, opt, raster=RasterConfig(**spec["raster"]),
                               use_explicit=spec["use_explicit"], guidance_fn=g,
                               split_sds=g is not None, **spec["sizes"],
                               **spec.get("options", {}), **shard)
    batch = ttr.make_gt_batch(ds, model, spec["frame"], device="cpu")
    if g is not None:
        lat, c2w, sds = step.sds_prelude(state, batch, draws)
        batch = dict(batch, sds_target=g.compute_target(lat, c2w, state.step, sds))
        out["latents"] = lat
    state, metrics = step(state, batch, draws)
    grads = {k: p.grad.detach().clone() for k, p in params.named_parameters()
             if p.grad is not None}
    return dict(out, metrics={k: float(v) for k, v in metrics.items()}, grads=grads,
                xyz=params.xyz.detach().clone(), colors=params.colors.detach().clone())


def sharded_steps(rank: int, world: int, init_file: str, specs, out: str):
    """A rank of the sharded steps: :func:`run_step` with both sharders
    on each spec, the results in a list."""
    from soar_tpu_torch.parallel import make_view_mesh

    _join(rank, world, init_file)
    try:
        mesh = make_view_mesh()
        torch.save([run_step(spec, mesh) for spec in specs], f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def cli_train(rank: int, world: int, init_file: str, argv_of_rank):
    """A rank of ``cli.train.main(argv_of_rank[rank])`` in the group."""
    from soar_tpu_torch.cli import train

    _join(rank, world, init_file)
    try:
        train.main(argv_of_rank[rank])
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, tmp_dir: str, *args):
    """``fn(rank, world, <store file>, *args)`` on ``world`` spawned ranks."""
    import torch.multiprocessing as mp

    init_file = os.path.join(tmp_dir, f"store_{fn.__name__}_{time.time_ns()}")
    mp.spawn(fn, args=(world, init_file) + args, nprocs=world, join=True)
