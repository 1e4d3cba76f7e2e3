"""The guided SOAR training step: one training run in a closed loop.

Set-up builds what ``soar_tpu_torch.cli.train`` builds for its stage-1
guided run: the avatar, the bf16 ImageDream guidance (UNet, VAE encoder,
and the CLIP tower and Resampler, which embed every frame's crop once and
are then released), the bf16 LPIPS through the ``--lpips-weights`` pickle,
every frame's GT batch pinned on the device with its ip tokens, and the step
``make_train_step`` returns.  Each step draws its frame uniformly from the
capture's frames (a fresh permutation every pass over them) and its cameras
and SDS draws with the program's ``sample_step_draws``, as ``cli.train``
does every step, from a seeded generator on the device.  Set-up imports
nothing of the reference.

The first ``checked_steps`` steps run in set-up through the window's own
call and feed, on frames that all differ; the window then continues the
same run.  From them the program's readings are kept: each step's loss and
SDS loss, each leaf's first gradient as Adam holds it after one step, the
change of each leaf after the last of them, and the ip tokens of their
frames.  After the window the reference repeats those steps from the same
inputs, its draws taken by its own copy of ``sample_step_draws`` from a
generator seeded alike, and the numbers compared are the gaps between the
two.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from .. import cell as C
from .. import scene

UNIT = "step"
BETA1 = 0.9  # Adam's first-moment decay: exp_avg after one step is (1 - BETA1) * g


def _frame_order(seed: int, n_frames: int):
    """Frames in a fresh seeded permutation every pass: uniform over the
    capture, and the first ``n_frames`` all differ."""
    rng = np.random.RandomState(scene.sub_seed(seed, "frames") % 2**32)
    while True:
        for f in rng.permutation(n_frames):
            yield int(f)


class Feed:
    """The step's inputs: (frame, draws), the draws by ``draw`` (a
    ``sample_step_draws``) from a generator on the device seeded from the
    run's seed."""

    def __init__(self, draw, cfg, seed: int, n_frames: int, latent_size: int, device):
        self._draw = draw
        self.frames = _frame_order(seed, n_frames)
        self.gen = scene.generator(seed, "feed", device)
        self.cfg, self.latent_size = cfg, latent_size

    def next(self):
        return next(self.frames), self._draw(self.gen, self.cfg, latent_size=self.latent_size)


def train_cfg(mod_config, t: Dict):
    return mod_config.TrainConfig(n_views=t["n_views"], head_prob=t["head_prob"])


def leaves(opt) -> Dict[str, torch.Tensor]:
    """Every optimised leaf by ``group.index``."""
    return {f"{g}.{i}": p for g, ps in opt.groups.items() for i, p in enumerate(ps)}


def first_grad_norms(opt) -> Dict[str, float]:
    """Each leaf's gradient of the first step, read from Adam's state."""
    out = {}
    for k, p in leaves(opt).items():
        st = opt.adam.state.get(p, {})
        m = st.get("exp_avg")
        out[k] = 0.0 if m is None else float(torch.linalg.norm(m.float())) / (1.0 - BETA1)
    return out


def change_norms(opt, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm((p.detach() - start[k]).float()))
            for k, p in leaves(opt).items()}


def _dtype(name: str) -> torch.dtype:
    return {"bf16": torch.bfloat16, "f32": torch.float32}[name]


def _fp8_(module):
    """Rounds every weight of two or more dims to float8 e4m3 with a
    per-tensor scale (the weights of an fp8 deployment)."""
    with torch.no_grad():
        for p in module.parameters():
            if p.ndim >= 2:
                s = torch.clamp_min(p.abs().max().float(), 1e-30) / 448.0
                p.copy_(((p.float() / s).to(torch.float8_e4m3fn).float() * s).to(p.dtype))


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
        t, gd = cfg["train"], cfg["guidance"]
        self.sp, self.arrays = C.inputs(cfg, seed, device)
        C.stage("inputs", device)
        ds, params, model = C.program_avatar(cfg, seed, self.sp, self.arrays, device)
        C.stage("avatar", device)
        if params.xyz.shape[0] != cfg["surfels"]:
            raise RuntimeError(f"{params.xyz.shape[0]} surfels, the configuration states "
                               f"{cfg['surfels']}")
        tcfg = train_cfg(P_config, t)
        stage = P_config.stage1_config()
        raster = RasterConfig(max_per_tile=cfg["raster"]["max_per_tile"],
                              composite_dtype=cfg["raster"]["composite_dtype"])

        # LPIPS: the benchmark's weights, handed over as the CLI's pickle.
        path = scene.write_lpips_pickle(scene.lpips_state(seed, device))
        try:
            lpips_fn = make_lpips_fn(path, dtype=_dtype(cfg["lpips_dtype"]), device=device)
        finally:
            os.remove(path)
        C.stage("lpips", device)

        # Guidance: built as the CLI builds it, then given the benchmark's
        # weights and text embeddings.
        tiny = gd["shapes"] == "tiny"
        g = build_guidance(
            gd["kind"], stage, generator=scene.generator(seed, "unet", device),
            text_embeddings=scene.text_embeddings(seed, gd["context_dim"], device),
            mock=not tiny, tiny=tiny, image_size=gd["image_size"], n_view=t["n_views"],
            dtype=_dtype(gd["dtype"]), device=device)
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
        with torch.no_grad():
            ip_table = torch.stack([g.embed_ref(np.asarray(r, np.float32))
                                    for r in ds.images_crop])
        g.release_image_encoder()
        del enc
        C.stage("ip_tokens", device)

        state, opt = init_train_state(params, tcfg, seed=C.init_seed(seed), stage=stage)
        # Stage 1 guides every step after its first (step > sds_start = 0):
        # the run starts at step 1, so every step of it is guided.
        state.step = 1
        stacked, select, pos_of = make_gt_batch_stack(ds, model, ds.train_idx, store_u8=False,
                                                      ip_table=ip_table, device=device)
        step = make_train_step(
            model, tcfg, stage, opt, gen_size=(t["gen_size"],) * 2, gt_size=ds.image_size,
            normal_size=(t["normal_size"],) * 2, raster=raster, use_explicit=False,
            has_normals=True, has_normal_B=True, guidance_fn=g, lpips_fn=lpips_fn,
            split_sds=False)
        self.guidance, self.state, self.opt = g, state, opt
        self.feed = Feed(sample_step_draws, tcfg, seed, len(ds.train_idx), g.latent_size,
                         device)
        C.stage("step_build", device)

        def unit_call():
            frame, draws = self.feed.next()
            self.frame = frame
            _, metrics = step(self.state, select(stacked, pos_of[frame]), draws)
            return metrics

        self.unit_call = unit_call
        self._ip_table = ip_table

    def warmup(self):
        """The checked steps, their readings kept, then the warm-up steps."""
        n = self.mix["checked_steps"]
        start = {k: p.detach().clone() for k, p in leaves(self.opt).items()}
        losses, sds, frames = [], [], []
        for i in range(n):
            m = self.unit_call()
            frames.append(self.frame)
            losses.append(float(m["loss"]))
            sds.append(float(m["loss_sds"]))
            if i == 0:
                grad = first_grad_norms(self.opt)
        self.readings = {"loss": losses, "loss_sds": sds, "grad": grad,
                         "change": change_norms(self.opt, start),
                         "ip": {f: self._ip_table[f].clone() for f in frames}}
        del start
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

    def trace_ranges(self):
        """Ranges around the UNet's forward and the VAE encoder's forward and
        backward, for ``guidance_ms.train``."""
        from ..trace import module_ranges

        return module_ranges({"unet": self.guidance.unet, "vae": self.guidance.vae}, ["vae"])

    def flops(self) -> Dict[str, int]:
        from ..counts import flops

        return flops.train_step(self.cfg, self.cfg["surfels"], self.cfg["body"]["num_joints"])

    def free(self):
        del self.guidance, self.state, self.opt, self.unit_call, self._ip_table
        C.empty_cache(self.device)

    # ---------------------------------------------------------------- check

    def reference_run(self, mode: str = "reference") -> Dict:
        """The reference's readings of the checked steps, from the same
        inputs: ``mode`` "reference" (in the configuration's precisions:
        float32, the guidance networks and LPIPS in its ``dtype``s),
        "control" (a precision below: the float32 products under bf16
        autocast, the bf16 networks' weights in fp8) or "half_views" (a
        fault: half of the gen views left out, the losses' means over the
        rest)."""
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

        cfg, seed, dev = self.cfg, self.seed, self.device
        t, gd = cfg["train"], cfg["guidance"]
        control = mode == "control"
        nv = t["n_views"] // 2 if mode == "half_views" else t["n_views"]
        ds, params, model = C.reference_avatar(cfg, seed, self.sp, self.arrays, dev)
        tcfg = train_cfg(R_config, t)
        stage = R_config.stage1_config()
        raster = RasterConfig(max_per_tile=cfg["raster"]["max_per_tile"])
        if control:
            raster = RasterConfig(max_per_tile=cfg["raster"]["max_per_tile"],
                                  composite="plain", composite_dtype="bf16")
        net = LPIPS(_dtype(cfg["lpips_dtype"])).to(dev)
        net.load_state_dict(scene.lpips_state(seed, dev))
        tiny = gd["shapes"] == "tiny"
        g = build_guidance(
            gd["kind"], stage, generator=scene.generator(seed, "unet", dev),
            text_embeddings=scene.text_embeddings(seed, gd["context_dim"], dev),
            mock=not tiny, tiny=tiny, image_size=gd["image_size"], n_view=nv,
            dtype=_dtype(gd["dtype"]), device=dev)
        enc = g.image_encoder
        mods = ((g.unet, "unet"), (g.vae, "vae"), (enc["clip"], "clip"),
                (enc["resampler"], "resampler"))
        for m, tag in mods:
            scene.fill_network_(m, seed, tag)
        if control:
            for m, _ in mods:
                _fp8_(m)
            _fp8_(net)
        net.eval().requires_grad_(False)

        def lpips_fn(a, b):
            return net(a[None], b[None])[0]

        frames = list(self.readings["ip"])
        with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16, enabled=control):
            ip = {f: g.embed_ref(torch.as_tensor(ds.images_crop[f], device=dev)).float()
                  for f in frames}
        g.release_image_encoder()
        del enc, mods

        state, opt = init_train_state(params, tcfg, seed=C.init_seed(seed), stage=stage)
        state.step = 1
        step = make_train_step(
            model, tcfg, stage, opt, gen_size=(t["gen_size"],) * 2, gt_size=ds.image_size,
            normal_size=(t["normal_size"],) * 2, raster=raster, use_explicit=False,
            has_normals=True, has_normal_B=True, guidance_fn=g, lpips_fn=lpips_fn,
            n_views=nv)
        feed = Feed(sample_step_draws, tcfg, seed, cfg["capture"]["frames"], g.latent_size, dev)
        start = {k: p.detach().clone() for k, p in leaves(opt).items()}
        losses, sds = [], []
        for i in range(self.mix["checked_steps"]):
            frame, draws = feed.next()
            if nv != t["n_views"]:
                draws = {k: (v if k in ("head", "rand_bg", "bg_aug") else
                             ({kk: vv[:nv] if vv.ndim else vv for kk, vv in v.items()}
                              if k == "sds" else v[:nv]))
                         for k, v in draws.items()}
            batch = dict(make_gt_batch(ds, model, frame, dev), ref_ip=ip[frame])
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=control):
                _, m = step(state, batch, draws)
            losses.append(float(m["loss"]))
            sds.append(float(m["loss_sds"]))
            if i == 0:
                grad = first_grad_norms(opt)
        return {"loss": losses, "loss_sds": sds, "grad": grad,
                "change": change_norms(opt, start), "ip": ip}

    @staticmethod
    def gaps(got: Dict, want: Dict, detail: bool = False) -> Dict[str, float]:
        """The numbers compared, program (or control) ``got`` against the
        reference ``want``:

        - ``loss_gap`` / ``sds_gap``: the largest relative gap of a checked
          step's loss / SDS loss;
        - ``grad_gap``: the median over the moving leaves of the gap between
          the two first-gradient norms, against the reference's norm of that
          leaf or of the median leaf, whichever is larger.  Moving leaves
          are those whose reference gradient is at least a thousandth of the
          median leaf's (median over the leaves with a gradient); the others
          move under Adam by round-off;
        - ``change_gap``: the same median for the change of each leaf after
          the checked steps;
        - ``grad_worst`` / ``change_worst``: the same gaps of the worst
          moving leaf;
        - ``ip_gap``: the largest relative L2 distance of the checked
          frames' ip tokens.

        The median and the worst leaf each have a limit of their own: the
        worst leaf reads 1e-7 on most seeds and up to 2.5e-2 / 6.7e-2 on a
        few (``PERF.md`` section 2), so its limit is wider, and the median
        holds the bulk of the leaves to a tight one.  ``detail`` adds the
        first step's loss gaps (diagnostics, not compared)."""
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
        ip = max(float(torch.linalg.norm(got["ip"][f].to(want["ip"][f]) - want["ip"][f])
                       / torch.linalg.norm(want["ip"][f])) for f in want["ip"])
        out = {
            "loss_gap": max(rel(a, b) for a, b in zip(got["loss"], want["loss"])),
            "sds_gap": max(rel(a, b) for a, b in zip(got["loss_sds"], want["loss_sds"])),
            "grad_gap": float(np.median(grad)),
            "change_gap": float(np.median(change)),
            "grad_worst": max(grad),
            "change_worst": max(change),
            "ip_gap": ip,
        }
        if detail:
            out.update(loss_gap_first=rel(got["loss"][0], want["loss"][0]),
                       sds_gap_first=rel(got["loss_sds"][0], want["loss_sds"][0]))
        return out

    def check(self, detail: bool = False) -> Dict[str, float]:
        self.want = self.reference_run()
        return self.gaps(self.readings, self.want, detail)

    def control(self, detail: bool = False) -> Dict[str, float]:
        self.ctl = self.reference_run("control")
        return self.gaps(self.ctl, self._want(), detail)

    def faults(self) -> Dict[str, Dict[str, float]]:
        """The planted faults' readings (a state left unchanged reads 1 on
        ``grad_gap`` and ``change_gap`` by their definition and needs no
        run)."""
        return {"half_views": self.gaps(self.reference_run("half_views"), self._want(), True)}

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
