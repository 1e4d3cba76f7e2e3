"""The turntable: one client in a closed loop, one request a view, as
``soar_tpu_torch.cli.render_rot.run_turntable`` renders a checkpoint's
avatar: the azimuths in turn, each composed with frame 0's orientation,
through frame 0's GT camera, white background, the field queried on every
view.  A request ends when the images ``run_turntable`` saves for the view
(rgb, normal, occ, mask) are uint8 arrays on the host; the PNG encoding and
the disk writes are left out.

Correctness: a sample of the window's requests, drawn from the seed, is
kept, and after the window the reference renders the same views; each image
kind is compared by the share of the covered pixels that differ by more
than one level of 255 (the worst sampled view).
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import cell as C
from .. import scene

KINDS = ("rgb", "normal", "occ", "mask")
UNIT = "view"


def _u8(x: torch.Tensor) -> torch.Tensor:
    """The saved image's bytes: ``train.evaluate.save_png``'s clip, *255
    and truncation to uint8."""
    return (torch.clamp(x, 0.0, 1.0) * 255.0).to(torch.uint8)


def rotation(i: int, n: int, R0: torch.Tensor) -> torch.Tensor:
    """``run_turntable``'s global orientation of view ``i`` of ``n``."""
    angle = 2.0 * np.pi * i / n
    c, s = np.cos(angle), np.sin(angle)
    Ry = torch.as_tensor(np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32),
                         device=R0.device)
    return R0 @ Ry


def images(out: Dict[str, torch.Tensor]) -> List[np.ndarray]:
    """The four saved images of a view's render, as uint8 on the host."""
    return [_u8(out["render"]).cpu().numpy(), _u8(out["normal"]).cpu().numpy(),
            _u8(out["occ"]).cpu().numpy(),
            _u8(out["mask"])[..., None].expand(*out["mask"].shape, 3).cpu().numpy()]


def off_share(a: np.ndarray, b: np.ndarray, covered: np.ndarray) -> float:
    """Share of the covered pixels at which two uint8 images differ by
    more than one level in some channel."""
    off = (np.abs(a.astype(np.int16) - b.astype(np.int16)) > 1).any(-1)
    return float(np.sum(off & covered)) / max(int(np.sum(covered)), 1)


class Cell:
    unit = UNIT

    def __init__(self, cfg: Dict, mix: Dict, seed: int, device):
        from soar_tpu_torch.avatar.renderer import RenderSettings, render_view
        from soar_tpu_torch.cli.render_rot import gt_camera
        from soar_tpu_torch.core.transforms import batch_rodrigues, rotmat_to_rotvec

        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.sp, self.arrays = C.inputs(cfg, seed, device)
        C.stage("inputs", device)
        ds, params, model = C.program_avatar(cfg, seed, self.sp, self.arrays, device)
        C.stage("avatar", device)
        if params.xyz.shape[0] != cfg["surfels"]:
            raise RuntimeError(f"{params.xyz.shape[0]} surfels, the configuration states "
                               f"{cfg['surfels']}")
        self.n_views = mix["views"]
        H, W = ds.image_size
        cam = gt_camera(ds, 0, device)
        go0 = torch.as_tensor(np.asarray(ds.smpl_params["global_orient"][0], np.float32),
                              device=device).reshape(1, 3)
        R0 = batch_rodrigues(go0)[0]
        bg = torch.ones(3, device=device)
        settings = RenderSettings(use_explicit=False)
        self.params, self.model = params, model

        def render(i: int):
            R = rotation(i, self.n_views, R0)
            return render_view(params, model, cam, (H, W), bg, 0, settings,
                               smpl_override={"global_orient": rotmat_to_rotvec(R)})

        self._render = render
        self.i = 0
        self.sample_rng = np.random.RandomState(scene.sub_seed(seed, "sample") % 2**32)
        self.kept: List = []  # (request number, view index, images)
        self.done = 0

    @torch.no_grad()
    def unit_call(self, keep: bool = True):
        """One request: the next view, its images on the host, kept in the
        sample when ``keep``."""
        i = self.i
        self.i = (self.i + 1) % self.n_views
        imgs = images(self._render(i))
        if keep:
            self._keep(i, imgs)
        return imgs

    def _keep(self, i: int, imgs):
        """Reservoir sample of the window's requests (seeded)."""
        n, k = self.done, self.mix["sample"]
        if n < k:
            self.kept.append((n, i, imgs))
        else:
            j = self.sample_rng.randint(n + 1)
            if j < k:
                self.kept[j] = (n, i, imgs)
        self.done += 1

    def warmup(self):
        for _ in range(self.n_views):
            self.unit_call(keep=False)
        C.stage("warmup_views", self.device)
        self.i = 0

    def window(self, seconds: float) -> Dict:
        lat = []
        t0 = time.perf_counter()
        end = t0 + seconds
        t = t0
        while t < end:
            self.unit_call()
            t1 = time.perf_counter()
            lat.append(t1 - t)
            t = t1
        wall = t - t0
        lat_ms = 1e3 * np.asarray(lat)
        return {"attempted": len(lat), "failed": 0,
                "metrics": {"view_ms": 1e3 * wall / len(lat),
                            "view_p95_ms": float(np.percentile(lat_ms, 95))}}

    def flops(self) -> Dict[str, int]:
        from ..counts import flops

        return flops.view(self.cfg, self.cfg["surfels"], self.cfg["body"]["num_joints"])

    def free(self):
        del self.params, self.model, self._render
        C.empty_cache(self.device)

    # ---------------------------------------------------------------- check

    def reference_views(self, views, control: bool = False) -> Dict[int, List[np.ndarray]]:
        """The reference's images of the given view indices; ``control``
        computes it a precision below the configuration's float32: the
        field's and the skinning's products under bf16 autocast and the
        composite in bf16."""
        from ..reference import full_float32

        with full_float32():
            return self._reference_views(views, control)

    def _reference_views(self, views, control: bool) -> Dict[int, List[np.ndarray]]:
        import dataclasses

        from ..reference.avatar.renderer import RenderSettings, render_view
        from ..reference.core.camera import camera_from_c2w
        from ..reference.core.transforms import batch_rodrigues, rotmat_to_rotvec
        from ..reference.render.types import RasterConfig

        dev = self.device
        ds, params, model = C.reference_avatar(self.cfg, self.seed, self.sp, self.arrays, dev)
        H, W = ds.image_size
        fov = ds.frame_fovs(0)
        cam = camera_from_c2w(
            torch.as_tensor(ds.gt_c2w(0), dtype=torch.float32, device=dev),
            fov["fovx"], fov["fovy"], znear=0.1, zfar=100.0,
            prcppoint=torch.tensor([fov["cx"] / W, fov["cy"] / H], dtype=torch.float32,
                                   device=dev))
        go0 = torch.as_tensor(np.asarray(ds.smpl_params["global_orient"][0], np.float32),
                              device=dev).reshape(1, 3)
        R0 = batch_rodrigues(go0)[0]
        raster = RasterConfig()
        if control:
            raster = dataclasses.replace(raster, composite="plain", composite_dtype="bf16")
        settings = RenderSettings(use_explicit=False, raster=raster)
        bg = torch.ones(3, device=dev)
        out = {}
        with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16, enabled=control):
            for i in sorted(set(views)):
                R = rotation(i, self.n_views, R0)
                r = render_view(params, model, cam, (H, W), bg, 0, settings,
                                smpl_override={"global_orient": rotmat_to_rotvec(R)})
                out[i] = images({k: v.float() for k, v in r.items()
                                 if k in ("render", "normal", "occ", "mask")})
        return out

    def readings(self, got: Dict[int, List[np.ndarray]], want: Dict[int, List[np.ndarray]],
                 views) -> Dict[str, float]:
        """Per image kind, the largest share over the views of the pixels
        either side covers (mask above 0) that are off by more than one
        level."""
        m = KINDS.index("mask")
        cov = {i: (got[i][m][..., 0] > 0) | (want[i][m][..., 0] > 0) for i in views}
        return {f"{k}_px": max(off_share(got[i][j], want[i][j], cov[i]) for i in views)
                for j, k in enumerate(KINDS)}

    def check(self) -> Dict[str, float]:
        """The numbers compared: per image kind, the largest share of pixels
        off by more than one level over the sampled requests."""
        views = [i for _, i, _ in self.kept]
        want = self.reference_views(views)
        got = {i: imgs for _, i, imgs in self.kept}
        return self.readings(got, want, views)

    def faults(self) -> Dict[str, Dict[str, float]]:
        """A planted fault: every sampled view answered with the next
        azimuth's images (an answer altered where it is produced)."""
        views = sorted({i for _, i, _ in self.kept})
        nxt = sorted({(i + 1) % self.n_views for i in views})
        ref = self.reference_views(sorted(set(views) | set(nxt)))
        got = {i: ref[(i + 1) % self.n_views] for i in views}
        return {"next_view": self.readings(got, ref, views)}

    def control(self) -> Dict[str, float]:
        """The same numbers for the control against the reference (the
        sampled views)."""
        views = sorted({i for _, i, _ in self.kept})
        return self.readings(self.reference_views(views, control=True),
                             self.reference_views(views), views)
