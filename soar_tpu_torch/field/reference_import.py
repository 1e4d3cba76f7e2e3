"""Import the reference checkpoint's ``HashMLPSDFField`` (port of
``soar_tpu.field.reference_import``).

The reference ships its attribute field inside the Lightning state_dict
(``geometry.attribute_field.*``, read at ``test/render_rot.py:129-135``)
in one of two layouts, by ``implementation`` (``geometry/sdf_fields.py:
56``):

- **torch** (nerfstudio's fallback): ``encoding.hash_table`` [L*T, F] with
  per-level resolutions ``floor(min_res * growth^l)`` and prime-XOR hashing
  at every level, which is the port's ``corner``-mode
  :func:`soar_tpu_torch.field.hashgrid.hash_encode`: the table reshapes
  straight into that layout; the MLP heads are plain Linear stacks.
- **tcnn** (the default the shipped configs train with): packed fp16
  buffers ``encoding.tcnn_encoding.params`` in tiny-cuda-nn's own grid
  layout (dense indexing at coarse levels, a +0.5 sample offset, per-level
  row counts rounded to 8) and FullyFusedMLP packed weight matrices (no
  biases, widths padded to 16).  :func:`tcnn_hash_encode` evaluates the
  packed grid point for point (cast to float32, as the JAX package does),
  and :func:`unpack_tcnn_mlp` splits the packed matrices.

:func:`import_reference_field` returns a :class:`ReferenceField`, whose
tensors live on one explicit device, and :func:`reference_field_apply`
computes ``HashMLPSDFField.forward`` (``sdf_fields.py:163-220``): sigmoid
shs, sigmoid * 2e-2 scales, L2-normalised quats, offsets with the 2-dim z
latent, sigmoid opacities.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from .hashgrid import _PRIMES, _U32, HashGridConfig, hash_encode, normalize_positions

# ---------------------------------------------------------------------------
# tcnn GridEncoding layout and sampling


@dataclasses.dataclass(frozen=True)
class TcnnGridLayout:
    """Per-level geometry of a tcnn hash grid (grid.h)."""

    resolutions: Tuple[int, ...]  # grid_resolution per level
    scales: Tuple[float, ...]  # grid_scale per level
    row_offsets: Tuple[int, ...]  # feature-row offset per level (+ total)
    dense: Tuple[bool, ...]  # stride-indexed (no hashing) per level
    features_per_level: int


def tcnn_grid_layout(
    num_levels: int,
    min_res: int,
    max_res: int,
    log2_hashmap_size: int,
    features_per_level: int = 2,
) -> TcnnGridLayout:
    """tiny-cuda-nn's grid geometry: ``scale = 2^(l*log2(growth)) * base -
    1``, ``resolution = ceil(scale) + 1``, rows per level
    ``min(next_multiple(res^3, 8), 2^log2_hashmap_size)``; a level is
    densely indexed when res^3 fits."""
    growth = (math.exp((math.log(max_res) - math.log(min_res)) / (num_levels - 1))
              if num_levels > 1 else 1.0)
    hashmap_rows = 1 << log2_hashmap_size
    resolutions, scales, offsets, dense = [], [], [0], []
    for lvl in range(num_levels):
        scale = (2.0 ** (lvl * math.log2(growth))) * min_res - 1.0
        res = int(math.ceil(scale)) + 1
        n_dense = res**3
        rows = min(-(-n_dense // 8) * 8, hashmap_rows)  # next_multiple(.., 8)
        resolutions.append(res)
        scales.append(scale)
        dense.append(n_dense <= rows)
        offsets.append(offsets[-1] + rows)
    return TcnnGridLayout(tuple(resolutions), tuple(scales), tuple(offsets), tuple(dense),
                          features_per_level)


_CORNERS = tuple((c & 1, (c >> 1) & 1, (c >> 2) & 1) for c in range(8))


def tcnn_hash_encode(
    params: torch.Tensor,  # flat [total_rows * F] float32
    positions: torch.Tensor,  # [N, 3] in [0, 1]
    layout: TcnnGridLayout,
) -> torch.Tensor:
    """Evaluate a packed tcnn grid: ``pos = scale * x + 0.5``; stride
    indexing ``% rows`` where the level is dense (the top boundary cell
    wraps), the prime-XOR hash ``% rows`` otherwise; trilinear weights.
    The hash runs in int64, each product reduced mod 2^32 (uint32
    wraparound) before the XOR.  Returns [N, L * F] float32."""
    F = layout.features_per_level
    L = len(layout.resolutions)
    p = positions.reshape(-1, 3)
    N = p.shape[0]
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=p.device)  # [8, 3]

    outs = []
    for lvl in range(L):
        res = layout.resolutions[lvl]
        rows = layout.row_offsets[lvl + 1] - layout.row_offsets[lvl]
        pos = p * layout.scales[lvl] + 0.5
        base_f = torch.floor(pos)
        w = pos - base_f
        cidx = base_f.to(torch.int64)[:, None, :] + corners[None]  # [N, 8, 3]
        cw = torch.prod(torch.where(corners[None] == 1, w[:, None, :], 1.0 - w[:, None, :]),
                        dim=-1)  # [N, 8]
        if layout.dense[lvl]:
            idx = (cidx[..., 0] + cidx[..., 1] * res + cidx[..., 2] * (res * res)) % rows
        else:
            h = (((cidx[..., 0] * _PRIMES[0]) & _U32)
                 ^ ((cidx[..., 1] * _PRIMES[1]) & _U32)
                 ^ ((cidx[..., 2] * _PRIMES[2]) & _U32))
            idx = h % rows
        level = params[layout.row_offsets[lvl] * F:layout.row_offsets[lvl + 1] * F]
        g = level.reshape(rows, F)[idx.reshape(-1)].reshape(N, 8, F).to(torch.float32)
        outs.append(torch.sum(g * cw[..., None], dim=1))
    out = torch.cat(outs, dim=-1)
    return out.reshape(positions.shape[:-1] + (L * F,))


def unpack_tcnn_mlp(
    packed: np.ndarray, in_dim: int, hidden: int, out_dim: int, num_layers: int,
) -> List[Dict[str, np.ndarray]]:
    """Split a FullyFusedMLP packed weight buffer into dense layers
    ``{"w": [in, out], "b": [out]}`` (numpy float32).

    tcnn stores row-major [n_out, n_in] matrices back to back, the input
    width padded to a multiple of 16, the output width padded to 16, no
    biases.  tcnn pads the input activations with ONES, so the first
    matrix's columns past ``in_dim`` act as per-neuron biases: their row
    sums become ``b`` of the first layer (dropping them would shift every
    first-layer pre-activation).  The other biases are zero."""

    def pad16(n):
        return -(-n // 16) * 16

    in_p, out_p = pad16(in_dim), pad16(out_dim)
    shapes = [(hidden, in_p)] + [(hidden, hidden)] * (num_layers - 2) + [(out_p, hidden)]
    total = sum(a * b for a, b in shapes)
    if packed.size != total:
        raise ValueError(f"packed MLP size {packed.size} != expected {total} for in={in_dim} "
                         f"hidden={hidden} out={out_dim} layers={num_layers}")
    layers, off = [], 0
    for i, (rows, cols) in enumerate(shapes):
        W = packed[off:off + rows * cols].reshape(rows, cols)
        off += rows * cols
        b = np.zeros(W.shape[0], np.float32)
        if i == 0:
            b = np.asarray(W[:, in_dim:].sum(axis=1), np.float32)
            W = W[:, :in_dim]
        if i == len(shapes) - 1:
            W, b = W[:out_dim], b[:out_dim]
        layers.append({"w": np.asarray(W, np.float32).T, "b": b})
    return layers


# ---------------------------------------------------------------------------
# the imported field


@dataclasses.dataclass
class ReferenceField:
    """Imported ``HashMLPSDFField``, every tensor on one device; evaluate
    with :func:`reference_field_apply`."""

    aabb: torch.Tensor  # [2, 3]
    heads: Dict[str, List[Dict[str, torch.Tensor]]]  # shs/scales/quats/offsets/opacities
    # tcnn layout: packed buffers and their layout; torch layout: corner-mode tables.
    tcnn: bool = False
    layout: Optional[TcnnGridLayout] = None
    enc_params: Optional[torch.Tensor] = None  # tcnn packed (flat)
    quat_enc_params: Optional[torch.Tensor] = None
    enc_table: Optional[torch.Tensor] = None  # torch layout [L, T, F]
    quat_enc_table: Optional[torch.Tensor] = None
    grid_cfg: Optional[HashGridConfig] = None

    def encode(self, pos: torch.Tensor, quat: bool = False) -> torch.Tensor:
        if self.tcnn:
            return tcnn_hash_encode(self.quat_enc_params if quat else self.enc_params, pos,
                                    self.layout)
        return hash_encode(self.quat_enc_table if quat else self.enc_table, pos, self.grid_cfg)


def _apply_layers(layers: List[Dict[str, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    for i, layer in enumerate(layers):
        x = x @ layer["w"] + layer["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def reference_field_apply(
    rf: ReferenceField, xyz: torch.Tensor, z: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """``HashMLPSDFField.forward`` (``sdf_fields.py:163-220``) at the
    canonical points ``xyz`` [N, 3]."""
    pos, _ = normalize_positions(xyz, rf.aabb)
    x = rf.encode(pos)
    shs = torch.sigmoid(_apply_layers(rf.heads["shs"], x))
    scales = torch.sigmoid(_apply_layers(rf.heads["scales"], x)) * 2e-2
    quats = _apply_layers(rf.heads["quats"], rf.encode(pos, quat=True))
    quats = quats / torch.clamp_min(torch.linalg.norm(quats, dim=-1, keepdim=True), 1e-12)
    if z is None:
        zfeat = torch.zeros(x.shape[:-1] + (2,), dtype=x.dtype, device=x.device)
    else:
        zfeat = torch.as_tensor(z, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (2,))
    offsets = _apply_layers(rf.heads["offsets"], torch.cat([x, zfeat], dim=-1))
    opacities = torch.sigmoid(_apply_layers(rf.heads["opacities"], x))
    return {"shs": shs, "scales": scales, "quats": quats, "offsets": offsets,
            "opacities": opacities}


_HEADS = {
    "shs": ("mlp_base_shs", 3),
    "scales": ("mlp_base_scales", 1),
    "quats": ("mlp_base_quats", 4),
    "offsets": ("mlp_base_offsets", 3),
    "opacities": ("mlp_base_opacities", 1),
}


def _np32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _torch_mlp_layers(sd, prefix) -> List[Dict[str, np.ndarray]]:
    layers, i = [], 0
    while f"{prefix}.layers.{i}.weight" in sd:
        layers.append({"w": _np32(sd[f"{prefix}.layers.{i}.weight"]).T,
                       "b": _np32(sd[f"{prefix}.layers.{i}.bias"])})
        i += 1
    if not layers:
        raise KeyError(f"{prefix}.layers.0.weight")
    return layers


def import_reference_field(
    sd: Dict,
    prefix: str = "geometry.attribute_field.",
    hidden_dim: int = 64,
    num_layers: int = 2,
    base_res: int = 16,
    device="cuda",
) -> ReferenceField:
    """Build a :class:`ReferenceField` on ``device`` from the reference
    state_dict's entries (numpy arrays or tensors).  The field's
    hyperparameters come from its stored buffers (``sdf_fields.py:62-65``:
    aabb, max_res, num_levels, log2_hashmap_size); ``base_res`` and
    ``hidden_dim`` are constructor defaults the checkpoint does not
    store."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(_np32(a))).to(dev)

    aabb = _np32(sd[prefix + "aabb"]).reshape(2, 3)
    num_levels = int(np.asarray(sd[prefix + "num_levels"]))
    max_res = int(np.asarray(sd[prefix + "max_res"]))
    log2_hs = int(np.asarray(sd[prefix + "log2_hashmap_size"]))

    enc_dim = num_levels * 2
    heads = {}
    for name, (ref_name, out_dim) in _HEADS.items():
        torch_key = f"{prefix}{ref_name}.layers.0.weight"
        tcnn_key = f"{prefix}{ref_name}.tcnn_encoding.params"
        if torch_key in sd:
            layers = _torch_mlp_layers(sd, prefix + ref_name)
        elif tcnn_key in sd:
            in_dim = enc_dim + 2 if name == "offsets" else enc_dim
            layers = unpack_tcnn_mlp(_np32(sd[tcnn_key]).ravel(), in_dim, hidden_dim, out_dim,
                                     num_layers)
        else:
            raise KeyError(f"no weights for head {ref_name}")
        heads[name] = [{k: t(v) for k, v in layer.items()} for layer in layers]

    if (prefix + "encoding.tcnn_encoding.params") in sd:
        return ReferenceField(
            aabb=t(aabb), heads=heads, tcnn=True,
            layout=tcnn_grid_layout(num_levels, base_res, max_res, log2_hs),
            enc_params=t(_np32(sd[prefix + "encoding.tcnn_encoding.params"]).ravel()),
            quat_enc_params=t(_np32(sd[prefix + "quat_encoding.tcnn_encoding.params"]).ravel()),
        )

    # torch layout: hash_table [L * T, F] -> the corner-mode [L, T, F].
    cfg = HashGridConfig(num_levels=num_levels, min_res=base_res, max_res=max_res,
                         log2_hashmap_size=log2_hs, mode="corner", dtype="float32")
    shape = (num_levels, cfg.table_size, cfg.features_per_level)
    return ReferenceField(
        aabb=t(aabb), heads=heads, tcnn=False,
        enc_table=t(_np32(sd[prefix + "encoding.hash_table"]).reshape(shape)),
        quat_enc_table=t(_np32(sd[prefix + "quat_encoding.hash_table"]).reshape(shape)),
        grid_cfg=cfg,
    )
