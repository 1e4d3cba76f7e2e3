"""``benchmark/counts`` against counts worked by hand at tiny shapes."""

import pytest
import torch

from benchmark.counts import composite, flops
from benchmark.counts.peaks import H100_BYTES_PER_S, H100_F32_FLOPS


def one_pixel_launch(opacities, C=1):
    """One tile, one pixel at (0.5, 0.5), every slot's splat centred on it
    (alpha = its opacity), as packed features [1, K, 9 + C]."""
    K = len(opacities)
    feat = torch.zeros(1, K, 9 + C)
    feat[0, :, 0:2] = 0.5
    feat[0, :, 2] = 1.0
    feat[0, :, 4] = 1.0
    feat[0, :, 5] = torch.tensor(opacities)
    feat[0, :, 6] = 1.0
    pixf = torch.tensor([[[0.5, 0.5]]])
    return feat, pixf


def test_forward_bound_by_hand():
    feat, pixf = one_pixel_launch([0.5, 0.5])
    # Two slots evaluated (T 0.5 then 0.25, no early stop) and blended:
    # 2 * 19 + 2 * (2C + 6) operations; bytes: feat 2 x 10, pixf 2, out C + 2.
    assert composite.walk_counts(composite.unpack_feat(feat, pixf)) == (2, 2, 2)
    b = composite.fwd_bound(feat, pixf)
    assert b["ops"] == 2 * 19 + 2 * 8
    assert b["bytes"] == 4 * (20 + 2 + 3)
    assert b["bound_s"] == pytest.approx(max(54 / H100_F32_FLOPS, 100 / H100_BYTES_PER_S))
    assert b["bound_by"] == "bytes"


def test_backward_bound_by_hand():
    feat, pixf = one_pixel_launch([0.5, 0.5])
    b = composite.bwd_bound(feat, pixf)
    # Two walks of 2 evaluated slots, 2 blended (5C + 48), 2 slots' 9 sums.
    assert b["ops"] == 2 * 2 * 19 + 2 * 53 + 2 * 9 * 1
    assert b["bytes"] == 4 * (2 * 20 + 2 + 3)


def test_early_stop_and_invalid_slots_are_not_counted():
    feat, pixf = one_pixel_launch([0.99, 0.95, 0.99, 0.5])
    feat[0, 3, 6] = 0.0  # the last slot invalid
    # T: 0.01, 5e-4, then 5e-6 < 1e-4: the walk stops at the third slot,
    # which it evaluates and does not blend.
    ev, bl, _ = composite.walk_counts(composite.unpack_feat(feat, pixf))
    assert ev == 3 and bl == 2


def test_field_and_skinning_by_hand():
    cfg = {"field": {"num_levels": 2, "features_per_level": 2, "hidden_dim": 8}}
    enc = 4
    per_point = 2 * sum(a * 8 + 8 * b for a, b in
                        ((enc, 3), (enc, 1), (enc, 4), (enc + 2, 3), (enc, 1)))
    assert flops.field_query(cfg, 10, backward=False) == 10 * per_point
    assert flops.field_query(cfg, 10, backward=True) == 30 * per_point
    assert flops.skinning(5, 3) == 2 * 5 * 3 * 16


def test_flop_counter_counts_a_convolution_by_hand():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1, device="meta")
    x = torch.empty(2, 3, 16, 16, device="meta")
    assert flops._count(lambda: conv(x)) == 2 * 2 * 3 * 8 * 9 * 16 * 16


def test_lpips_forward_and_input_gradient_by_hand():
    """VGG16's 13 convolutions at 16x16 over a batch of two, and their
    input gradients: twice the forward."""
    cfg = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512)
    cin, side, fwd = 3, 16, 0
    for c in cfg:
        if c == "M":
            side //= 2
            continue
        fwd += 2 * 2 * cin * c * 9 * side * side
        cin = c
    assert flops.lpips_forward_backward(16, 1) == 2 * fwd


def test_network_counts_on_meta_match_a_real_run():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.guidance.build import NetworkShapes
    from benchmark.reference.guidance.networks import VAEEncoder

    gd = {"shapes": "tiny", "image_size": 32}
    vae = VAEEncoder(NetworkShapes.tiny(32).vae).requires_grad_(False)
    x = torch.rand(2, 3, 32, 32, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        vae(x, torch.zeros(2, 4, 16, 16)).sum().backward()
    assert flops.vae_forward_backward(gd, 2) == fc.get_total_flops() > 0
    assert flops.unet_forward(gd, 4) > 0
