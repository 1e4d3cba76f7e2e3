"""Canonical-space neural attribute field (port of
``soar_tpu.field.attribute_field``).

Two hash encodings (one shared by the shs/scales/offsets/opacities heads,
one for quats) feed five 2-layer MLP heads with the reference's output
activations:

- shs:        sigmoid, 3 channels
- scales:     sigmoid(x) * 2e-2, 1 channel
- quats:      L2-normalized, 4 channels
- offsets:    linear, zero-init last layer, takes a 2-dim latent ``z``
- opacities:  sigmoid, 1 channel

The heads are ``nn.Linear`` stacks, whose weight is [out, in]; the JAX
package stores ``w`` as [in, out] (see :mod:`soar_tpu_torch.io.from_jax`).

:func:`reset_field` is the Adam distillation of explicit surfel attributes
into the field.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .hashgrid import HashGridConfig, hash_encode, init_hash_grid, normalize_positions

HEADS = ("shs", "scales", "quats", "offsets", "opacities")


@dataclasses.dataclass(frozen=True)
class AttributeFieldConfig:
    grid: HashGridConfig = HashGridConfig()
    hidden_dim: int = 64
    num_layers: int = 2


def _make_mlp(in_dim, hidden, out_dim, num_layers, generator, zero_last=False):
    """Linear stack with torch's uniform(-1/sqrt(in), 1/sqrt(in)) init drawn
    from ``generator`` (the JAX package draws the same distribution)."""
    dims = [in_dim] + [hidden] * (num_layers - 1) + [out_dim]
    layers = nn.ModuleList()
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        lin = nn.utils.skip_init(nn.Linear, a, b, device=generator.device)
        bound = 1.0 / a**0.5
        with torch.no_grad():
            for t in (lin.weight, lin.bias):
                if zero_last and i == len(dims) - 2:
                    t.zero_()
                else:
                    u = torch.rand(t.shape, generator=generator, device=t.device)
                    t.copy_((2.0 * u - 1.0) * bound)
        layers.append(lin)
    return layers


def _apply_mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


class AttributeField(nn.Module):
    """The field's parameters (two hash tables, five MLP heads) and the AABB
    buffer; ``forward`` is ``attribute_field_apply``."""

    def __init__(
        self,
        aabb: torch.Tensor,
        cfg: AttributeFieldConfig = AttributeFieldConfig(),
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = aabb.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self.cfg = cfg
        self.register_buffer("aabb", aabb.clone())
        self.encoding = nn.Parameter(init_hash_grid(generator, cfg.grid, dev))
        self.quat_encoding = nn.Parameter(init_hash_grid(generator, cfg.grid, dev))
        enc_dim = cfg.grid.out_dim
        h, L = cfg.hidden_dim, cfg.num_layers
        self.mlp_shs = _make_mlp(enc_dim, h, 3, L, generator)
        self.mlp_scales = _make_mlp(enc_dim, h, 1, L, generator)
        self.mlp_quats = _make_mlp(enc_dim, h, 4, L, generator)
        self.mlp_offsets = _make_mlp(enc_dim + 2, h, 3, L, generator, zero_last=True)
        self.mlp_opacities = _make_mlp(enc_dim, h, 1, L, generator)

    def forward(
        self,
        xyz: torch.Tensor,
        z: Optional[torch.Tensor] = None,
        is_normalized: bool = False,
        heads: Optional[Tuple[str, ...]] = None,
    ) -> Dict[str, torch.Tensor]:
        return attribute_field_apply(self, xyz, z, is_normalized, heads)


def attribute_field_apply(
    field: AttributeField,
    xyz: torch.Tensor,  # [N, 3] canonical-space positions
    z: Optional[torch.Tensor] = None,  # [2] per-frame latent for offsets
    is_normalized: bool = False,
    heads: Optional[Tuple[str, ...]] = None,  # None = all five
) -> Dict[str, torch.Tensor]:
    gcfg = field.cfg.grid
    pos = xyz if is_normalized else normalize_positions(xyz, field.aabb)[0]
    want = HEADS if heads is None else heads
    out: Dict[str, torch.Tensor] = {}

    x = None
    if {"shs", "scales", "offsets", "opacities"} & set(want):
        x = hash_encode(field.encoding, pos, gcfg)
    if "shs" in want:
        out["shs"] = torch.sigmoid(_apply_mlp(field.mlp_shs, x))
    if "scales" in want:
        out["scales"] = torch.sigmoid(_apply_mlp(field.mlp_scales, x)) * 2e-2
    if "quats" in want:
        xq = hash_encode(field.quat_encoding, pos, gcfg)
        quats = _apply_mlp(field.mlp_quats, xq)
        out["quats"] = quats / torch.clamp_min(
            torch.linalg.norm(quats, dim=-1, keepdim=True), 1e-12
        )
    if "offsets" in want:
        if z is None:
            zfeat = torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype, device=x.device)
        else:
            zfeat = torch.as_tensor(z, dtype=x.dtype, device=x.device).expand(
                x.shape[:-1] + (2,)
            )
        out["offsets"] = _apply_mlp(field.mlp_offsets, torch.cat([x, zfeat], -1))
    if "opacities" in want:
        out["opacities"] = torch.sigmoid(_apply_mlp(field.mlp_opacities, x))
    return out


def reset_field(
    field: AttributeField,
    xyz: torch.Tensor,
    gt_shs: torch.Tensor,
    gt_scales: torch.Tensor,
    gt_quats: torch.Tensor,
    steps: int = 1000,
    lr: float = 1e-3,
    batch_size: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[AttributeField, torch.Tensor]:
    """Distill explicit attributes into ``field``: ``steps`` Adam updates
    (lr 1e-3, optax's defaults) of mse(shs) + 1000 mse(scales) + mse(quats)
    (``sdf_fields.py:221-250``).  Only the heads in the loss and their
    encodings are trained; the offsets and opacities heads are left alone.
    With ``batch_size`` each step draws its minibatch uniformly with
    replacement from ``generator`` (on the points' device); None keeps the
    full batch.  Updates ``field`` in place (it holds the only copy of the
    hash tables) and returns ``(field, per-step losses)``."""
    pos = normalize_positions(xyz.detach(), field.aabb)[0]
    targets = (gt_shs.detach(), gt_scales.detach(), gt_quats.detach())
    trained = [field.encoding, field.quat_encoding]
    for head in (field.mlp_shs, field.mlp_scales, field.mlp_quats):
        trained += list(head.parameters())
    opt = torch.optim.Adam(trained, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    N = pos.shape[0]
    use_batch = batch_size is not None and batch_size < N
    if use_batch and generator is None:
        generator = torch.Generator(device=pos.device).manual_seed(0)
    losses = []
    for _ in range(steps):
        if use_batch:
            idx = torch.randint(0, N, (batch_size,), generator=generator,
                                device=pos.device)
            pos_b, shs_b, scales_b, quats_b = (a[idx] for a in (pos,) + targets)
        else:
            pos_b, (shs_b, scales_b, quats_b) = pos, targets
        out = attribute_field_apply(field, pos_b, is_normalized=True,
                                    heads=("shs", "scales", "quats"))
        loss = (
            torch.mean((out["shs"] - shs_b) ** 2)
            + 1000.0 * torch.mean((out["scales"] - scales_b) ** 2)
            + torch.mean((out["quats"] - quats_b) ** 2)
        )
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return field, torch.stack(losses) if losses else torch.zeros(0, device=pos.device)
