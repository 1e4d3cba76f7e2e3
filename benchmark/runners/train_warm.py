"""SOAR's geometry stage (stage 0) before its guidance starts: one training
run in a closed loop over the stage's warm-up steps.

Set-up builds what ``soar_tpu_torch.cli.train --stage 0 --guidance
imagedream`` builds: the avatar, the bf16 ImageDream guidance (UNet, VAE
encoder, and the CLIP tower and Resampler, which embed every frame's front
normal map, stage 0's reference image, once and are then released), the
bf16 LPIPS through the ``--lpips-weights`` pickle, every frame's GT batch
pinned on the device with its ip tokens, and the step ``make_train_step``
returns for the stage's ``StageConfig()``.  The guidance is held as the CLI
holds it for the stage's steps after ``sds_start``, and no step of the run
calls it: the run's step counter starts at the mix's ``start_step`` and
wraps from ``last_step`` (``sds_start``, the last step without guidance)
back to ``wrap_to``.  Each step draws its frame from a fresh seeded
permutation of the capture's frames and its cameras (and the SDS draws the
CLI takes every step) with the program's ``sample_step_draws`` from a seeded
generator on the device.  Set-up imports nothing of the reference.

The first ``checked_steps`` steps run in set-up through the window's own
call and feed; the window then continues the same run.  From them the
program's readings are kept: each step's loss, each leaf's first gradient
as Adam holds it after one step, and the change of each leaf after the
last of them.  After the window the reference repeats those steps from the
same inputs with its own copy of ``sample_step_draws``, and the numbers
compared are the gaps between the two (:meth:`Cell.gaps`), with
``guided_steps``: the steps of the run, window included, whose metrics
hold an SDS loss (a step that opened ``soar.guidance``).

For the per-layer readers of ``benchmark/metrics/*.warm.py`` the cell set
up in this process sits in :data:`LIVE`; the first span reader profiles
``span_units`` steps with the program's spans on
(``benchmark.spans.measure``) and the others read the same table.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import cell as C
from .. import scene
from . import train_step as T

UNIT = "step"

# The cell set up in this process, for the per-layer readers (the harness
# calls them after the traced run and before ``Cell.free``).
LIVE = []


def stage_config(config, t: Dict):
    """The stage's ``StageConfig()`` of ``config`` (the program's or the
    reference's module), checked against the configuration file's
    ``train`` entry."""
    stage = config.StageConfig()
    got = {"stage": stage.training_stage, "sds_start": stage.sds_start,
           "max_steps": stage.max_steps, "lambda_mask": float(stage.loss.mask),
           "max_step_percent": list(stage.max_step_percent)}
    want = {k: t[k] for k in got}
    if got != want:
        raise RuntimeError(f"StageConfig() is {got}, the configuration states {want}")
    return stage


def unguided_run(mix: Dict, stage) -> None:
    """Refuses a mix whose counter would reach a guided step."""
    if not 1 <= mix["wrap_to"] <= mix["start_step"] <= mix["last_step"] <= stage.sds_start:
        raise ValueError(f"steps {mix['start_step']}..{mix['last_step']} (wrapping to "
                         f"{mix['wrap_to']}) reach past sds_start {stage.sds_start}")


def halved(draws: Dict, nv: int) -> Dict:
    """The first ``nv`` gen views of a step's draws."""
    out = {k: v for k, v in draws.items() if k in ("head", "rand_bg", "bg_aug")}
    out.update(c2w=draws["c2w"][:nv], fovy=draws["fovy"][:nv])
    if "sds" in draws:
        s = draws["sds"]
        out["sds"] = {"u": s["u"], "noise": s["noise"][:nv], "vae_eps": s["vae_eps"][:nv]}
    return out


class Cell:
    unit = UNIT

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from soar_tpu_torch.guidance.build import build_guidance
        from soar_tpu_torch.render.types import RasterConfig
        from soar_tpu_torch.train import config as P_config
        from soar_tpu_torch.train.lpips import make_lpips_fn
        from soar_tpu_torch.train.trainer import (
            init_train_state,
            make_gt_batch_stack,
            make_train_step,
            sample_step_draws,
        )

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self._spans = None
        t, gd = cfg["train"], cfg["guidance"]
        stage = stage_config(P_config, t)
        unguided_run(mix, stage)
        self.sp, self.arrays = C.inputs(cfg, seed, device)
        C.stage("inputs", device)
        ds, params, model = C.program_avatar(cfg, seed, self.sp, self.arrays, device)
        C.stage("avatar", device)
        if params.xyz.shape[0] != cfg["surfels"]:
            raise RuntimeError(f"{params.xyz.shape[0]} surfels, the configuration states "
                               f"{cfg['surfels']}")
        tcfg = T.train_cfg(P_config, t)
        raster = RasterConfig(max_per_tile=cfg["raster"]["max_per_tile"],
                              composite_dtype=cfg["raster"]["composite_dtype"])

        path = scene.write_lpips_pickle(scene.lpips_state(seed, device))
        try:
            lpips_fn = make_lpips_fn(path, dtype=T._dtype(cfg["lpips_dtype"]), device=device)
        finally:
            os.remove(path)
        C.stage("lpips", device)

        tiny = gd["shapes"] == "tiny"
        g = build_guidance(
            gd["kind"], stage, generator=scene.generator(seed, "unet", device),
            text_embeddings=scene.text_embeddings(seed, gd["context_dim"], device),
            mock=not tiny, tiny=tiny, image_size=gd["image_size"], n_view=t["n_views"],
            dtype=T._dtype(gd["dtype"]), device=device)
        C.stage("guidance_build", device)
        enc = g.image_encoder
        self.n_params = {"unet": sum(p.numel() for p in g.unet.parameters()),
                         "vae": sum(p.numel() for p in g.vae.parameters()),
                         "clip": sum(p.numel() for p in enc["clip"].parameters()),
                         "resampler": sum(p.numel() for p in enc["resampler"].parameters())}
        if self.n_params != cfg["parameters"]:
            raise RuntimeError(f"guidance parameters {self.n_params}, the configuration "
                               f"states {cfg['parameters']}")
        for m, tag in ((g.unet, "unet"), (g.vae, "vae"), (enc["clip"], "clip"),
                       (enc["resampler"], "resampler")):
            scene.fill_network_(m, seed, tag)
        C.stage("guidance_weights", device)
        # Stage 0's reference image is the front normal map (cli/train.py).
        with torch.no_grad():
            ip_table = torch.stack([g.embed_ref(np.asarray(r, np.float32))
                                    for r in ds.normal_F])
        g.release_image_encoder()
        del enc
        C.stage("ip_tokens", device)

        state, opt = init_train_state(params, tcfg, seed=C.init_seed(seed), stage=stage)
        state.step = mix["start_step"]
        stacked, select, pos_of = make_gt_batch_stack(ds, model, ds.train_idx, store_u8=False,
                                                      ip_table=ip_table, device=device)
        step = make_train_step(
            model, tcfg, stage, opt, gen_size=(t["gen_size"],) * 2, gt_size=ds.image_size,
            normal_size=(t["normal_size"],) * 2, raster=raster, use_explicit=False,
            has_normals=True, has_normal_B=True, guidance_fn=g, lpips_fn=lpips_fn,
            split_sds=False)
        self.guidance, self.state, self.opt = g, state, opt
        self.feed = T.Feed(sample_step_draws, tcfg, seed, len(ds.train_idx), g.latent_size,
                           device)
        self.guided = 0
        C.stage("step_build", device)

        def unit_call():
            frame, draws = self.feed.next()
            _, metrics = step(self.state, select(stacked, pos_of[frame]), draws)
            if self.state.step > mix["last_step"]:
                self.state.step = mix["wrap_to"]
            self.guided += "loss_sds" in metrics
            return metrics

        self.unit_call = unit_call
        LIVE[:] = [self]

    def warmup(self):
        """The checked steps, their readings kept, then the warm-up steps."""
        start = {k: p.detach().clone() for k, p in T.leaves(self.opt).items()}
        losses = []
        for i in range(self.mix["checked_steps"]):
            losses.append(float(self.unit_call()["loss"]))
            if i == 0:
                grad = T.first_grad_norms(self.opt)
        self.readings = {"loss": losses, "grad": grad,
                         "change": T.change_norms(self.opt, start)}
        del start
        C.stage("checked_steps", self.device)
        for _ in range(self.mix["warmup_steps"]):
            self.unit_call()
        C.stage("warmup_steps", self.device)

    # The guided cell's closed loop: steps until the window's end, one sync.
    window = T.Cell.window

    def span_table(self) -> Dict:
        """The program's span table over the mix's ``span_units`` steps,
        measured once; empty where the program has no spans."""
        if self._spans is None:
            try:
                from soar_tpu_torch.core import spans  # noqa: F401
            except ImportError:
                self._spans = {}
                return self._spans
            from ..spans import measure

            self._spans = measure(self, self.mix, self.mix["span_units"])
        return self._spans

    def free(self):
        LIVE.clear()
        del self.guidance, self.state, self.opt, self.unit_call
        C.empty_cache(self.device)

    # ---------------------------------------------------------------- check

    def reference_run(self, mode: str = "reference") -> Dict:
        """The reference's readings of the checked steps, from the same
        inputs: ``mode`` "reference" (in the configuration's precisions:
        float32, LPIPS in its ``dtype``), "control" (a precision below: the
        float32 products under bf16 autocast, the composite in bf16,
        LPIPS's weights in fp8) or "half_views" (a fault: half of the gen
        views left out, the losses' means over the rest)."""
        from ..reference import full_float32

        with full_float32():
            return self._reference_run(mode)

    def _reference_run(self, mode: str) -> Dict:
        from ..reference.guidance.build import build_guidance
        from ..reference.render.types import RasterConfig
        from ..reference.train import config as R_config
        from ..reference.train.lpips import LPIPS
        from ..reference.train.trainer import (
            init_train_state,
            make_gt_batch,
            make_train_step,
            sample_step_draws,
        )

        cfg, seed, dev, mix = self.cfg, self.seed, self.device, self.mix
        t, gd = cfg["train"], cfg["guidance"]
        control = mode == "control"
        nv = t["n_views"] // 2 if mode == "half_views" else t["n_views"]
        stage = stage_config(R_config, t)
        ds, params, model = C.reference_avatar(cfg, seed, self.sp, self.arrays, dev)
        tcfg = T.train_cfg(R_config, t)
        raster = RasterConfig(max_per_tile=cfg["raster"]["max_per_tile"])
        if control:
            raster = RasterConfig(max_per_tile=cfg["raster"]["max_per_tile"],
                                  composite="plain", composite_dtype="bf16")
        net = LPIPS(T._dtype(cfg["lpips_dtype"])).to(dev)
        net.load_state_dict(scene.lpips_state(seed, dev))
        if control:
            T._fp8_(net)
        net.eval().requires_grad_(False)

        def lpips_fn(a, b):
            return net(a[None], b[None])[0]

        # The guidance the stage holds, which none of these steps calls.
        tiny = gd["shapes"] == "tiny"
        g = build_guidance(
            gd["kind"], stage, generator=scene.generator(seed, "unet", dev),
            text_embeddings=scene.text_embeddings(seed, gd["context_dim"], dev),
            mock=not tiny, tiny=tiny, image_size=gd["image_size"], n_view=nv,
            dtype=T._dtype(gd["dtype"]), device=dev)
        g.release_image_encoder()
        for m, tag in ((g.unet, "unet"), (g.vae, "vae")):
            scene.fill_network_(m, seed, tag)

        state, opt = init_train_state(params, tcfg, seed=C.init_seed(seed), stage=stage)
        state.step = mix["start_step"]
        step = make_train_step(
            model, tcfg, stage, opt, gen_size=(t["gen_size"],) * 2, gt_size=ds.image_size,
            normal_size=(t["normal_size"],) * 2, raster=raster, use_explicit=False,
            has_normals=True, has_normal_B=True, guidance_fn=g, lpips_fn=lpips_fn,
            n_views=nv)
        feed = T.Feed(sample_step_draws, tcfg, seed, cfg["capture"]["frames"], g.latent_size,
                      dev)
        start = {k: p.detach().clone() for k, p in T.leaves(opt).items()}
        losses, guided = [], 0
        for i in range(mix["checked_steps"]):
            frame, draws = feed.next()
            if nv != t["n_views"]:
                draws = halved(draws, nv)
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=control):
                _, m = step(state, make_gt_batch(ds, model, frame, dev), draws)
            losses.append(float(m["loss"]))
            guided += "loss_sds" in m
            if i == 0:
                grad = T.first_grad_norms(opt)
        return {"loss": losses, "grad": grad, "change": T.change_norms(opt, start),
                "guided": guided}

    @staticmethod
    def gaps(got: Dict, want: Dict, detail: bool = False) -> Dict[str, float]:
        """The numbers compared, program (or control, or fault) ``got``
        against the reference ``want``, as the guided cell defines them
        (``runners/train_step.Cell.gaps``): ``loss_gap``, the largest
        relative gap of a checked step's loss; ``grad_gap`` and
        ``change_gap``, the median over the moving leaves of the gap of the
        first gradient's and of the change's norm against the reference's
        norm of that leaf or of the median leaf, whichever is larger;
        ``grad_worst`` and ``change_worst``, those of the worst moving leaf.
        ``detail`` adds the first step's loss gap (a diagnostic)."""
        def rel(a, b):
            return abs(a - b) / max(abs(b), 1e-30)

        g_ref, c_ref = want["grad"], want["change"]
        nz = [v for v in g_ref.values() if v > 0.0]
        med_g = float(np.median(nz)) if nz else 0.0
        moving = [k for k, v in g_ref.items() if v > 0.0 and v >= 1e-3 * med_g]
        med_c = float(np.median([c_ref[k] for k in moving])) if moving else 0.0

        def per_leaf(a, b, med):
            return [abs(a[k] - b[k]) / max(b[k], med, 1e-30) for k in moving] or [0.0]

        grad = per_leaf(got["grad"], g_ref, med_g)
        change = per_leaf(got["change"], c_ref, med_c)
        out = {
            "loss_gap": max(rel(a, b) for a, b in zip(got["loss"], want["loss"])),
            "grad_gap": float(np.median(grad)),
            "change_gap": float(np.median(change)),
            "grad_worst": max(grad),
            "change_worst": max(change),
        }
        if detail:
            out["loss_gap_first"] = rel(got["loss"][0], want["loss"][0])
        return out

    def check(self, detail: bool = False) -> Dict[str, float]:
        self.want = self.reference_run()
        return dict(self.gaps(self.readings, self.want, detail),
                    guided_steps=float(self.guided))

    def control(self, detail: bool = False) -> Dict[str, float]:
        self.ctl = self.reference_run("control")
        return self.gaps(self.ctl, self._want(), detail)

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The planted faults' readings (a state left unchanged reads 1 on
        ``grad_gap`` and ``change_gap`` by their definition and needs no
        run)."""
        return {"half_views": self.gaps(self.reference_run("half_views"), self._want(), True)}

    _want = T.Cell._want
    leaf_table = staticmethod(T.Cell.leaf_table)


# ------------------------------------------------------ the per-layer readers


def reading(ctx: Dict, name: str) -> Optional[float]:
    """Per-layer number ``name`` (``lpips_ms``, ``raster_front_ms``,
    ``host_syncs``: ``benchmark.spans.readings``' of a step) of the warm
    cell set up in this process, from its span table; None for another
    cell's units, or where the program's step opens no ``soar.step``."""
    from ..spans import readings

    cell = LIVE[0] if LIVE else None
    if cell is None or ctx.get("unit") != UNIT:
        return None
    table = cell.span_table().get("table")
    if not table or "soar.step" not in table["spans"]:
        return None
    return readings(table, UNIT)[f"{name}.train"]
