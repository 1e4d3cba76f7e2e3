"""ECON's NormalNet: clothed front/back normal prediction (port of
``soar_tpu.preproc.normal_net``).

Two independent pix2pixHD ``GlobalGenerator``s: ``netF`` takes (image,
T_normal_F), ``netB`` (image, T_normal_B), 6 channels each.  A generator is
a 7x7 conv (reflect pad), 4 stride-2 downsamples (64..1024), 9
reflect-padded resnet blocks, 4 transposed-conv upsamples, a 7x7 conv and
tanh, with affine-free instance norm throughout.  The outputs are
L2-normalised and masked by the nonzero input pixels.

Each generator is one ``model`` ``nn.Sequential`` in ECON's layout, so its
``state_dict()`` keys are ECON's own (``netF.model.1.weight``, ...,
``netF.model.{16..24}.conv_block.{1,5}``, ``netF.model.38``) and the user's
``normal.ckpt`` loads with ``load_state_dict(strict=True)``.  Tensors are
NCHW.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn


def InstanceNorm(dim: int) -> nn.InstanceNorm2d:
    """Affine-free instance norm, eps 1e-5, biased variance."""
    return nn.InstanceNorm2d(dim, eps=1e-5, affine=False)


class ResnetBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), InstanceNorm(dim), nn.ReLU(True),
            nn.ReflectionPad2d(1), nn.Conv2d(dim, dim, 3), InstanceNorm(dim),
        )

    def forward(self, x):
        return x + self.conv_block(x)


class GlobalGenerator(nn.Module):
    def __init__(self, input_nc: int = 6, output_nc: int = 3, ngf: int = 64,
                 n_downsampling: int = 4, n_blocks: int = 9):
        super().__init__()
        self.ngf, self.n_downsampling, self.n_blocks, self.output_nc = (
            ngf, n_downsampling, n_blocks, output_nc)
        layers = [nn.ReflectionPad2d(3), nn.Conv2d(input_nc, ngf, 7), InstanceNorm(ngf),
                  nn.ReLU(True)]
        for i in range(n_downsampling):
            mult = 2**i
            layers += [nn.Conv2d(ngf * mult, ngf * mult * 2, 3, stride=2, padding=1),
                       InstanceNorm(ngf * mult * 2), nn.ReLU(True)]
        mult = 2**n_downsampling
        layers += [ResnetBlock(ngf * mult) for _ in range(n_blocks)]
        for i in range(n_downsampling):
            mult = 2 ** (n_downsampling - i)
            layers += [nn.ConvTranspose2d(ngf * mult, ngf * mult // 2, 3, stride=2, padding=1,
                                          output_padding=1),
                       InstanceNorm(ngf * mult // 2), nn.ReLU(True)]
        layers += [nn.ReflectionPad2d(3), nn.Conv2d(ngf, output_nc, 7), nn.Tanh()]
        self.model = nn.Sequential(*layers)

    def forward(self, x):
        return self.model(x)


class NormalNet(nn.Module):
    """Dual-generator front/back normal predictor."""

    def __init__(self, ngf: int = 64, n_downsampling: int = 4, n_blocks: int = 9):
        super().__init__()
        kw = dict(ngf=ngf, n_downsampling=n_downsampling, n_blocks=n_blocks)
        self.netF = GlobalGenerator(**kw)
        self.netB = GlobalGenerator(**kw)

    def forward(self, image, t_normal_f, t_normal_b) -> Tuple[torch.Tensor, torch.Tensor]:
        """All inputs [B, 3, H, W] in [-1, 1]; returns (nmlF, nmlB) in
        [-1, 1], unit-norm, masked by the image foreground."""
        nmlF = self.netF(torch.cat([image, t_normal_f], dim=1))
        nmlB = self.netB(torch.cat([image, t_normal_b], dim=1))
        nmlF = nmlF / torch.clamp_min(torch.linalg.norm(nmlF, dim=1, keepdim=True), 1e-8)
        nmlB = nmlB / torch.clamp_min(torch.linalg.norm(nmlB, dim=1, keepdim=True), 1e-8)
        mask = (torch.sum(torch.abs(image), dim=1, keepdim=True) != 0.0).to(image.dtype)
        return nmlF * mask, nmlB * mask


def econ_state_dict(ckpt: Dict) -> Dict[str, torch.Tensor]:
    """The NormalNet entries (``netF.*``, ``netB.*``) of an ECON checkpoint:
    a Lightning file's ``state_dict``, or the state_dict itself."""
    sd = ckpt.get("state_dict", ckpt)
    return {k: v for k, v in sd.items() if k.startswith(("netF.", "netB."))}
