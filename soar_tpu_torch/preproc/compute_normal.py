"""Clothed-normal-map CLI (port of ``soar_tpu.preproc.compute_normal``).

    python -m soar_tpu_torch.preproc.compute_normal --data-dir DIR \
        --smpl-model SMPLX_NEUTRAL.npz [--econ-ckpt normal.ckpt] \
        [--fallback template|error] [--device cuda]

Per frame: the mask-bbox 512² crop (the K transformed into crop space), the
fitted SMPL-X template's front and back normals through
:mod:`soar_tpu_torch.render.mesh_raster` (back = the projection's third row
flipped), ECON's NormalNet for the clothed normals, RGBA PNGs
(``normal_F/``, ``normal_B/``, the cropped mask in alpha) and ``normal_Ks``
appended to ``smplx/params.pth``.  Without ``--econ-ckpt``, ``--fallback
template`` writes the template normals themselves.

The crop samples the frame bilinearly with a zero border, in float, where
the JAX package calls ``cv2.remap`` (bilinear weights quantized to 1/32 px).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from glob import glob

import numpy as np
import torch

from .. import resolve_device
from ..data.dataset import _mask_channel
from ..io.png import read_png
from ..render.mesh_raster import get_proj_mat, render_mesh
from ..train.evaluate import save_png

CROP_WH = (512, 512)


def transform_K_by_bbox(K: np.ndarray, bbox, crop_wh) -> np.ndarray:
    """Intrinsics for a square crop resampled to crop_wh, in the half-pixel
    (align_corners=False) convention, the exact inverse of
    :func:`crop_grid`: crop pixel centre ``u`` samples the source at
    ``x0 + (u + 0.5)/sx - 0.5``."""
    x0, y0, x1, y1 = [float(v) for v in bbox]
    sx = crop_wh[0] / (x1 - x0)
    sy = crop_wh[1] / (y1 - y0)
    out = K.copy()
    out[0, 0] *= sx
    out[1, 1] *= sy
    out[0, 2] = (K[0, 2] - x0 + 0.5) * sx - 0.5
    out[1, 2] = (K[1, 2] - y0 + 0.5) * sy - 0.5
    return out


def crop_grid(bbox, crop_wh):
    """Source-coordinate sampling grids (mx, my) [h, w] of the crop,
    consistent with :func:`transform_K_by_bbox`."""
    x0, y0, x1, y1 = [float(v) for v in bbox]
    gx = x0 + (np.arange(crop_wh[0], dtype=np.float32) + 0.5) * (x1 - x0) / crop_wh[0] - 0.5
    gy = y0 + (np.arange(crop_wh[1], dtype=np.float32) + 0.5) * (y1 - y0) / crop_wh[1] - 0.5
    return np.meshgrid(gx, gy)


def mask_bbox(mask: np.ndarray, margin: float = 1.1):
    """Square bbox around the mask's pixels, ``margin`` times its longer
    side; an empty mask raises, as in the JAX package."""
    ys, xs = np.nonzero(mask)
    cx, cy = (xs.min() + xs.max()) / 2.0, (ys.min() + ys.max()) / 2.0
    s = max(xs.max() - xs.min(), ys.max() - ys.min()) * margin
    return (cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2)


def remap_bilinear(img: torch.Tensor, mx: torch.Tensor, my: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of ``img`` [H, W, C] at source pixel coordinates
    (mx, my) [h, w]; a neighbour outside the image counts as 0 (OpenCV's
    ``BORDER_CONSTANT``).  Returns [h, w, C]."""
    H, W = img.shape[:2]
    x0f, y0f = torch.floor(mx), torch.floor(my)
    wx, wy = (mx - x0f)[..., None], (my - y0f)[..., None]
    x0, y0 = x0f.long(), y0f.long()
    out = torch.zeros(mx.shape + img.shape[2:], dtype=img.dtype, device=img.device)
    for dy, wgt_y in ((0, 1.0 - wy), (1, wy)):
        for dx, wgt_x in ((0, 1.0 - wx), (1, wx)):
            xi, yi = x0 + dx, y0 + dy
            ok = ((xi >= 0) & (xi < W) & (yi >= 0) & (yi < H))[..., None]
            v = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
            out = out + torch.where(ok, v, torch.zeros_like(v)) * (wgt_y * wgt_x)
    return out


def _normal_model(econ_ckpt: str, dev):
    """ECON's NormalNet with the checkpoint's weights (a Lightning file
    carries non-tensor entries, hence ``weights_only=False``: load only
    checkpoints you trust)."""
    from .normal_net import NormalNet, econ_state_dict

    sd = torch.load(econ_ckpt, map_location="cpu", weights_only=False)
    with torch.device("meta"):
        net = NormalNet()
    net.load_state_dict({k: v.float() for k, v in econ_state_dict(sd).items()}, strict=True,
                        assign=True)
    return net.to(dev).eval()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--smpl-model", required=True)
    ap.add_argument("--econ-ckpt", default=None)
    ap.add_argument("--fallback", default="template", choices=["template", "error"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from ..body.model import load_smplx_npz, smplx_forward

    img_dir = osp.join(args.data_dir, "images")
    mask_dir = osp.join(args.data_dir, "masks")
    nf_dir = osp.join(args.data_dir, "normal_F")
    nb_dir = osp.join(args.data_dir, "normal_B")
    param_path = osp.join(args.data_dir, "smplx", "params.pth")
    img_paths = sorted(glob(osp.join(img_dir, "*.png")))

    if osp.exists(nf_dir) and len(os.listdir(nf_dir)) >= len(img_paths) and osp.exists(nb_dir):
        print("Normals already computed.")
        return
    os.makedirs(nf_dir, exist_ok=True)
    os.makedirs(nb_dir, exist_ok=True)

    params = torch.load(param_path, map_location="cpu", weights_only=False)
    np_params = {k: v.numpy() if hasattr(v, "numpy") else v for k, v in params.items()}
    body = load_smplx_npz(args.smpl_model, device=dev)
    smpl_in = {k: torch.as_tensor(v.reshape(v.shape[0], -1) if v.ndim == 3 else v).to(dev)
               for k, v in np_params.items() if k not in ("Ks", "w2c", "img_wh")}
    with torch.no_grad():
        verts_all = smplx_forward(body, smpl_in).vertices

    normal_model = None
    if args.econ_ckpt:
        normal_model = _normal_model(args.econ_ckpt, dev)
    elif args.fallback == "error":
        raise SystemExit("--econ-ckpt required (ECON normal.ckpt)")

    normal_Ks = []
    w2c = torch.as_tensor(np.asarray(np_params["w2c"], np.float32)).to(dev)
    for i, img_path in enumerate(img_paths):
        img = read_png(img_path)
        if img.ndim == 3 and img.shape[-1] == 4:
            mask = img[..., 3] > 0
        else:
            mask = _mask_channel(read_png(osp.join(mask_dir, osp.basename(img_path)))) > 0
        rgb = torch.from_numpy(img[..., :3].astype(np.float32) / 255.0).to(dev)

        bbox = mask_bbox(mask)
        K_c = transform_K_by_bbox(np.asarray(np_params["Ks"][i], np.float32), bbox, CROP_WH)
        normal_Ks.append(K_c)

        mx, my = (torch.from_numpy(g).to(dev) for g in crop_grid(bbox, CROP_WH))
        crop_img = remap_bilinear(rgb, mx, my)
        crop_mask = remap_bilinear(torch.from_numpy(mask.astype(np.float32)).to(dev)[..., None],
                                   mx, my)

        verts = verts_all[i]
        znear = float(verts[:, 2].mean()) - 3.0
        proj_f = get_proj_mat(torch.from_numpy(K_c).to(dev), CROP_WH, znear=max(znear, 1e-3))
        front = render_mesh(verts, body.faces, w2c, proj_f, CROP_WH)
        proj_b = proj_f.clone()
        proj_b[2] *= -1.0  # far-surface trick
        back = render_mesh(verts, body.faces, w2c, proj_b, CROP_WH)
        for tag, out in (("front", front), ("back", back)):
            capped = int(out["overflow"][1])
            if capped:
                print(f"[compute_normal] WARNING frame {i} {tag}: {capped} faces exceeded "
                      "the rasterizer's dup_side tile grid (holes possible) — raise "
                      "render_mesh dup_side")

        t_f = (front["normal"] * 2 - 1) * front["mask"]
        t_b = (back["normal"] * 2 - 1) * back["mask"]
        if normal_model is not None:
            inp = (crop_img * 2 - 1) * crop_mask
            with torch.no_grad():
                nmlF, nmlB = normal_model(*(x.permute(2, 0, 1)[None] for x in (inp, t_f, t_b)))
            nmlF, nmlB = nmlF[0].permute(1, 2, 0), nmlB[0].permute(1, 2, 0)
        else:
            nmlF, nmlB = t_f, t_b  # template fallback

        for arr, out_dir in ((nmlF, nf_dir), (nmlB, nb_dir)):
            rgba = torch.cat([(arr + 1) / 2 * crop_mask, crop_mask], dim=-1)
            save_png(osp.join(out_dir, f"{i:05d}.png"), rgba.cpu().numpy())

    params["normal_Ks"] = torch.from_numpy(np.stack(normal_Ks).astype(np.float32))
    torch.save(params, param_path)
    print(f"wrote normals for {len(img_paths)} frames (+normal_Ks)")


if __name__ == "__main__":
    main()
