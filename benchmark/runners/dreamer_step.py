"""The GaussianDreamer training step under MVDream guidance: one training
run in a closed loop.

Set-up builds what ``soar_tpu_torch.train.systems.make_gaussiandreamer_step``
trains: the avatar's surfels padded to the configuration's static
capacity, their kNN skin weights, Adam, and the bf16 text-only MVDream
guidance (UNet and VAE encoder, checked against the configuration's
parameter counts, then given the benchmark's weights and text embeddings).
A unit is one ``loss_step`` followed by ``maintain`` at the published
cadence.  Each step draws its cameras and SDS draws with the program's
``sample_dreamer_draws`` from a seeded generator on the device; a step
whose ``maintain`` densifies then draws the split's normals [C, 3] from the
same generator and hands them over.  The run's step counter starts at the
mix's ``start_step`` and wraps from ``last_step`` back to ``wrap_to``, so a
densify lands every ``densify_interval`` steps and no step reaches
``prune_from``.  Set-up imports nothing of the reference.

The first ``checked_steps`` steps run in set-up, the last of them
densifying; the window then continues the same run.  From them the
program's readings are kept: each step's loss and SDS loss, each leaf's
first gradient as Adam holds it, each leaf's change over the checked loss
steps, the surfels and statistics just before the last ``maintain``, and
the alive mask and surfels after it.  After the window the reference
repeats those steps from the same inputs with its own copy of
``sample_dreamer_draws``, and the numbers compared are the gaps between the
two (``Cell.gaps``).

For the per-layer readers of ``benchmark/metrics/*.dreamer.py`` the cell
set up in this process sits in :data:`LIVE`; the first reader profiles a
window of the cell's units with the program's spans on
(``benchmark.spans.measure``) and the others read the same table.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Dict, Optional

import numpy as np
import torch

from .. import cell as C
from .. import scene
from .train_step import _fp8_, change_norms, first_grad_norms, leaves

UNIT = "step"
SURFEL_FIELDS = ("xyz", "rotation", "scaling", "opacity", "colors", "occ")
STATE_FIELDS = ("alive", "xyz_grad_accum", "scale_grad_accum", "opac_accum", "denom")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# The cell set up in this process, for the per-layer readers (the harness
# calls them after the traced run and before ``Cell.free``).
LIVE = []


def dreamer_cfg(systems, types_mod, cameras, config, cfg: Dict, **raster):
    """The ``DreamerConfig`` of a configuration file, built from the
    program's or the reference's modules; ``raster`` overrides its raster
    switches."""
    d = cfg["dreamer"]
    cam = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["cameras"].items()}
    return systems.DreamerConfig(
        n_views=d["n_views"], image_size=(d["image_size"],) * 2,
        densify_from=d["densify_from"], densify_until=d["densify_until"],
        densify_interval=d["densify_interval"], prune_from=d["prune_from"],
        prune_interval=d["prune_interval"], densify_grad_threshold=d["densify_grad_threshold"],
        min_opac_prune=d["min_opac_prune"], extent=d["extent"],
        loss=config.LossWeights(**d["loss"]),
        raster=types_mod.RasterConfig(**dict(cfg["raster"], **raster)),
        cameras=cameras.CameraSampleConfig(**cam))


def stage_cfg(config, gd: Dict):
    """The guidance's ``StageConfig``: the defaults (the SDS timestep
    window's anneal) with the configuration's CFG scale."""
    return dataclasses.replace(config.StageConfig(), guidance_scale=gd["guidance_scale"])


def densifies(dcfg, step: int) -> bool:
    return (dcfg.densify_from <= step <= dcfg.densify_until
            and step % dcfg.densify_interval == 0)


def next_step(mix: Dict, step: int) -> int:
    return mix["wrap_to"] if step >= mix["last_step"] else step + 1


class Feed:
    """A step's draws (``draw``, a ``sample_dreamer_draws``) and a split's
    normals, from one generator on the device seeded from the run's seed."""

    def __init__(self, draw, dcfg, seed: int, latent_size: int, capacity: int, device):
        self._draw, self.dcfg, self.latent_size = draw, dcfg, latent_size
        self.capacity = capacity
        self.gen = scene.generator(seed, "feed", device)

    def draws(self) -> Dict:
        return self._draw(self.gen, self.dcfg, latent_size=self.latent_size)

    def split_noise(self) -> torch.Tensor:
        return torch.randn((self.capacity, 3), generator=self.gen, device=self.gen.device)


def half_draws(draws: Dict, nv: int) -> Dict:
    """The first ``nv`` views of a step's draws."""
    sds = draws["sds"]
    return {"c2w": draws["c2w"][:nv], "fovy": draws["fovy"][:nv],
            "sds": {"u": sds["u"], "noise": sds["noise"][:nv], "vae_eps": sds["vae_eps"][:nv]}}


def _snapshot(params, dstate) -> Dict[str, torch.Tensor]:
    out = {k: getattr(params, k).detach().clone() for k in SURFEL_FIELDS}
    out.update({k: getattr(dstate, k).clone() for k in STATE_FIELDS})
    return out


class Runs:
    """The loop both sides run: ``loss_step`` then ``maintain`` on the
    counter, and the checked steps' readings."""

    def __init__(self, loss_step, maintain, feed, dcfg, mix, params, dstate, pw, opt):
        self.loss_step, self.maintain, self.feed = loss_step, maintain, feed
        self.dcfg, self.mix, self.opt = dcfg, mix, opt
        self.params, self.dstate, self.pw = params, dstate, pw
        self.step = mix["start_step"]

    def loss(self, draws=None) -> Dict:
        draws = self.feed.draws() if draws is None else draws
        self.params, self.dstate, m = self.loss_step(self.params, self.dstate, self.pw, draws,
                                                     self.step)
        return m

    def keep(self, skip: bool = False) -> Optional[torch.Tensor]:
        """``maintain`` at the counter (not run with ``skip``); returns the
        split's normals it drew, or None."""
        noise = self.feed.split_noise() if densifies(self.dcfg, self.step) else None
        if not skip:
            self.params, self.dstate, self.pw = self.maintain(self.params, self.dstate,
                                                              self.pw, self.step, noise=noise)
        self.step = next_step(self.mix, self.step)
        return noise

    def unit(self) -> Dict:
        m = self.loss()
        self.keep()
        return m

    def checked(self, views: Optional[int] = None, autocast: bool = False,
                skip_last_maintain: bool = False) -> Dict:
        """The checked steps and their readings; ``views`` keeps the first
        of each step's views, ``autocast`` runs under bf16 autocast,
        ``skip_last_maintain`` leaves the last ``maintain`` out."""
        n = self.mix["checked_steps"]
        dev = self.params.xyz.device
        start = {k: p.detach().clone() for k, p in leaves(self.opt).items()}
        losses, sds, noise = [], [], None
        for i in range(n):
            draws = self.feed.draws()
            if views is not None:
                draws = half_draws(draws, views)
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=autocast):
                m = self.loss(draws)
                losses.append(float(m["loss"]))
                sds.append(float(m["loss_sds"]))
                if i == 0:
                    grad = first_grad_norms(self.opt)
                if i == n - 1:
                    change = change_norms(self.opt, start)
                    snap = _snapshot(self.params, self.dstate)
                noise = self.keep(skip=skip_last_maintain and i == n - 1)
        return {"loss": losses, "loss_sds": sds, "grad": grad, "change": change, "snap": snap,
                "noise": noise, "alive": self.dstate.alive.clone(),
                "post": {k: getattr(self.params, k).detach().clone()
                         for k in ("xyz", "scaling")}}


class Cell:
    unit = UNIT

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from soar_tpu_torch.avatar.densify import DensifyState, pad_to_capacity
        from soar_tpu_torch.avatar.optim import make_optimizer
        from soar_tpu_torch.body.skinning import knn_idw_weights
        from soar_tpu_torch.data import cameras as P_cameras
        from soar_tpu_torch.guidance.build import build_guidance
        from soar_tpu_torch.render import types as P_types
        from soar_tpu_torch.train import config as P_config
        from soar_tpu_torch.train import systems as P_systems

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self._spans = None
        self.dcfg = dreamer_cfg(P_systems, P_types, P_cameras, P_config, cfg)
        if mix["last_step"] >= self.dcfg.prune_from:
            raise ValueError("the run would reach prune_from, where every surfel is pruned")
        gd, cap = cfg["guidance"], cfg["capacity"]
        self.sp, self.arrays = C.inputs(cfg, seed, device)
        C.stage("inputs", device)
        _, params, model = C.program_avatar(cfg, seed, self.sp, self.arrays, device)
        n = params.xyz.shape[0]
        if n != cfg["surfels"] or cap < n:
            raise RuntimeError(f"{n} surfels at capacity {cap}, the configuration states "
                               f"{cfg['surfels']}")
        params = pad_to_capacity(params, cap)
        with torch.no_grad():
            pw = knn_idw_weights(params.xyz, model.skin.cano_vertices, model.body.lbs_weights)
        dstate = DensifyState.create(cap, n, device=device)
        C.stage("avatar", device)

        tiny = gd["shapes"] == "tiny"
        g = build_guidance(
            gd["kind"], stage_cfg(P_config, gd), generator=scene.generator(seed, "unet", device),
            text_embeddings=scene.text_embeddings(seed, gd["context_dim"], device),
            mock=not tiny, tiny=tiny, image_size=gd["image_size"],
            n_view=self.dcfg.n_views, dtype=DTYPES[gd["dtype"]], device=device)
        C.stage("guidance_build", device)
        self.n_params = {"unet": sum(p.numel() for p in g.unet.parameters()),
                         "vae": sum(p.numel() for p in g.vae.parameters())}
        if self.n_params != cfg["parameters"] or g.embed_ref is not None:
            raise RuntimeError(f"guidance parameters {self.n_params}, the configuration "
                               f"states {cfg['parameters']} (text only)")
        for m, tag in ((g.unet, "unet"), (g.vae, "vae")):
            scene.fill_network_(m, seed, tag)
        C.stage("guidance_weights", device)

        opt = make_optimizer(params, P_config.OptimConfig())
        loss_step, maintain = P_systems.make_gaussiandreamer_step(model, self.dcfg, opt, g)
        feed = Feed(P_systems.sample_dreamer_draws, self.dcfg, seed, g.latent_size, cap,
                    device)
        self.runs = Runs(loss_step, maintain, feed, self.dcfg, mix, params, dstate, pw, opt)
        self.unit_call = self.runs.unit
        C.stage("step_build", device)
        LIVE[:] = [self]

    def warmup(self):
        """The checked steps, their readings kept, then the warm-up steps."""
        self.readings = self.runs.checked()
        C.stage("checked_steps", self.device)
        for _ in range(self.mix["warmup_steps"]):
            self.unit_call()
        C.stage("warmup_steps", self.device)

    def window(self, seconds: float) -> Dict:
        losses = []
        C.sync(self.device)
        t0 = time.perf_counter()
        end = t0 + seconds
        while time.perf_counter() < end:
            losses.append(self.unit_call()["loss"])
        C.sync(self.device)
        wall = time.perf_counter() - t0
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"attempted": len(losses), "failed": failed,
                "metrics": {"train_step_ms": 1e3 * wall / len(losses)}}

    def span_table(self) -> Dict:
        """The program's span table over ``span_units`` units from step
        ``span_start`` (a window that holds one densifying ``maintain``),
        measured once; empty where the program has no spans."""
        if self._spans is None:
            try:
                from soar_tpu_torch.core import spans  # noqa: F401
            except ImportError:
                self._spans = {}
                return self._spans
            from ..spans import measure

            self.runs.step = self.mix["span_start"]
            self._spans = measure(self, self.mix, self.mix["span_units"])
        return self._spans

    def free(self):
        LIVE.clear()
        del self.unit_call, self.runs
        C.empty_cache(self.device)

    # ---------------------------------------------------------------- check

    def reference_run(self, mode: str = "reference") -> Dict:
        """The reference's readings of the checked steps from the same
        inputs: ``mode`` "reference" (the configuration's precisions:
        float32, the guidance networks in its ``dtype``), "control" (a
        precision below: the float32 products under bf16 autocast, the
        composite in bf16, the bf16 networks' weights in fp8), or a planted
        fault: "half_views" (half of each step's views left out) or
        "maintain_skipped" (the densifying ``maintain`` not run)."""
        from ..reference import full_float32

        with full_float32():
            return self._reference_run(mode)

    def _reference_run(self, mode: str) -> Dict:
        from ..reference.avatar.densify import DensifyState, pad_to_capacity
        from ..reference.avatar.optim import make_optimizer
        from ..reference.body.skinning import knn_idw_weights
        from ..reference.data import cameras as R_cameras
        from ..reference.guidance.build import build_guidance
        from ..reference.render import types as R_types
        from ..reference.train import config as R_config
        from ..reference.train import systems as R_systems

        cfg, seed, dev = self.cfg, self.seed, self.device
        gd, cap = cfg["guidance"], cfg["capacity"]
        control = mode == "control"
        raster = dict(composite="plain", composite_dtype="bf16") if control else {}
        dcfg = dreamer_cfg(R_systems, R_types, R_cameras, R_config, cfg, **raster)
        nv = dcfg.n_views // 2 if mode == "half_views" else None
        _, params, model = C.reference_avatar(cfg, seed, self.sp, self.arrays, dev)
        n = params.xyz.shape[0]
        params = pad_to_capacity(params, cap)
        with torch.no_grad():
            pw = knn_idw_weights(params.xyz, model.skin.cano_vertices, model.body.lbs_weights)
        dstate = DensifyState.create(cap, n, device=dev)
        tiny = gd["shapes"] == "tiny"
        g = build_guidance(
            gd["kind"], stage_cfg(R_config, gd), generator=scene.generator(seed, "unet", dev),
            text_embeddings=scene.text_embeddings(seed, gd["context_dim"], dev),
            mock=not tiny, tiny=tiny, image_size=gd["image_size"],
            n_view=nv or dcfg.n_views, dtype=DTYPES[gd["dtype"]], device=dev)
        for m, tag in ((g.unet, "unet"), (g.vae, "vae")):
            scene.fill_network_(m, seed, tag)
            if control:
                _fp8_(m)
        opt = make_optimizer(params, R_config.OptimConfig())
        loss_step, maintain = R_systems.make_gaussiandreamer_step(model, dcfg, opt, g)
        feed = Feed(R_systems.sample_dreamer_draws, dcfg, seed, g.latent_size, cap, dev)
        runs = Runs(loss_step, maintain, feed, dcfg, self.mix, params, dstate, pw, opt)
        return runs.checked(views=nv, autocast=control,
                            skip_last_maintain=mode == "maintain_skipped")

    def densify_reference(self, got: Dict) -> Optional[Dict[str, torch.Tensor]]:
        """The reference's densify of ``got``'s own surfels and statistics
        just before its last ``maintain``, with its split normals: the
        alive mask and surfels it leaves (None where that step did not
        densify)."""
        from ..reference import full_float32
        from ..reference.avatar.densify import DensifyState, adaptive_densify

        if got["noise"] is None:
            return None
        d = self.cfg["dreamer"]
        snap = got["snap"]
        params = types.SimpleNamespace(**{k: snap[k].clone() for k in SURFEL_FIELDS})
        state = DensifyState(**{k: snap[k].clone() for k in STATE_FIELDS})
        with full_float32():
            params, state = adaptive_densify(
                params, state, got["noise"], grad_threshold=d["densify_grad_threshold"],
                extent=d["extent"], surface=self.cfg["raster"]["surface"])
        return {"alive": state.alive, "xyz": params.xyz, "scaling": params.scaling}

    def gaps(self, got: Dict, want: Dict, detail: bool = False) -> Dict[str, float]:
        """The numbers compared, program (or control, or fault) ``got``
        against the reference ``want``:

        - ``loss_gap``, ``sds_gap``, ``grad_gap``, ``change_gap``,
          ``grad_worst``, ``change_worst``: as the guided SOAR step's
          (``runners/train_step.Cell.gaps``), the change over the checked
          loss steps;
        - ``alive_gap``: the share of the slots whose ``alive`` flag
          differs after the last ``maintain``;
        - ``densify_gap``: over the slots revived by that ``maintain``, in
          ``got`` or in the reference's densify of ``got``'s own surfels,
          statistics and split normals just before it, the worst relative
          gap of a slot's position (L2) and scale.  A densify fills dead
          slots in the order of its sources, so one source whose gradient
          sits at the threshold shifts every later slot; the positions and
          scales are held slot by slot against the same decision, and
          ``alive_gap`` holds the decision itself.

        ``detail`` adds the first step's loss gaps and the slots revived."""
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
        before = got["snap"]["alive"]
        dens = self.densify_reference(got)
        revived = got["alive"] & ~before
        if dens is not None:
            revived = revived | (dens["alive"] & ~before)
        densify = 0.0
        if dens is not None and bool(revived.any()):
            xr, xg = dens["xyz"][revived], got["post"]["xyz"][revived]
            dx = torch.linalg.norm(xg - xr, dim=-1) / torch.clamp_min(
                torch.linalg.norm(xr, dim=-1), 1e-12)
            sr, sg = torch.exp(dens["scaling"][revived]), torch.exp(got["post"]["scaling"][revived])
            ds = (sg - sr).abs() / torch.clamp_min(sr, 1e-30)
            densify = max(float(dx.max()), float(ds.max()))
        out = {
            "loss_gap": max(rel(a, b) for a, b in zip(got["loss"], want["loss"])),
            "sds_gap": max(rel(a, b) for a, b in zip(got["loss_sds"], want["loss_sds"])),
            "grad_gap": float(np.median(grad)),
            "change_gap": float(np.median(change)),
            "grad_worst": max(grad),
            "change_worst": max(change),
            "alive_gap": float((got["alive"] != want["alive"].to(got["alive"].device))
                               .float().mean()),
            "densify_gap": densify,
        }
        if detail:
            out.update(loss_gap_first=rel(got["loss"][0], want["loss"][0]),
                       sds_gap_first=rel(got["loss_sds"][0], want["loss_sds"][0]),
                       revived=int((got["alive"] & ~before).sum()),
                       revived_reference=int((want["alive"] & ~want["snap"]["alive"]).sum()))
        return out

    def check(self, detail: bool = False) -> Dict[str, float]:
        self.want = self.reference_run()
        return self.gaps(self.readings, self.want, detail)

    def control(self, detail: bool = False) -> Dict[str, float]:
        self.ctl = self.reference_run("control")
        return self.gaps(self.ctl, self._want(), detail)

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The planted faults' readings: half of each step's views left out,
        and the densifying ``maintain`` skipped."""
        want = self._want()
        return {mode: self.gaps(self.reference_run(mode), want, True)
                for mode in ("half_views", "maintain_skipped")}

    def _want(self):
        if getattr(self, "want", None) is None:
            self.want = self.reference_run()
        return self.want

    @staticmethod
    def leaf_table(got: Dict, want: Dict) -> Dict[str, list]:
        """Per leaf: the first-gradient and change norms, program (or
        control) then reference (diagnostics)."""
        return {k: [got["grad"][k], want["grad"][k], got["change"][k], want["change"][k]]
                for k in want["grad"] if want["grad"][k] > 0 or got["grad"][k] > 0}


# ------------------------------------------------------ the per-layer readers


def reading(ctx: Dict, name: str) -> Optional[float]:
    """Per-layer number ``name`` of the dreamer cell set up in this process,
    from its span table; None for another cell's units, or where the
    program's dreamer step opens no ``soar.step`` (or, for
    ``densify_ms``, no ``soar.densify``)."""
    cell = LIVE[0] if LIVE else None
    if cell is None or ctx.get("unit") != UNIT:
        return None
    table = cell.span_table().get("table")
    if not table or "soar.step" not in table["spans"]:
        return None
    rows, ctr = table["spans"], table["counters"]

    def total(key):
        return float(sum(ctr[key].values())) if key in ctr else None

    if name == "field_ms":
        return rows["soar.field"]["device_ms"] if "soar.field" in rows else None
    if name == "guidance_ms":
        return rows["soar.guidance"]["device_ms"] if "soar.guidance" in rows else None
    if name == "densify_ms":
        row = rows.get("soar.densify")
        return row["device_ms"] / row["calls"] if row and row["calls"] > 0 else None
    if name == "sort_key_use":
        keys, in_tiles = total("raster.keys"), total("raster.keys_in_tiles")
        return 100.0 * in_tiles / keys if keys else None
    if name == "host_syncs":
        return total("host_syncs") or 0.0
    raise KeyError(name)
