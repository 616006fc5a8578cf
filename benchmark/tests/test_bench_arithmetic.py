"""The FLOP count and the kernel bounds against hand counts."""

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import bounds, flops
from benchmark import reference as R

from tiny import tiny_cell

PEAKS = {"bf16_flops_per_s": 1e15, "f32_flops_per_s": 1e14,
         "hbm_bytes_per_s": 1e12}


def test_bounds_by_hand():
    # A on (1, 2, 2, 8) bf16: 32 elements read, 128 written, 2 bytes each
    assert bounds.upsample_bound((1, 2, 2, 8), 2, PEAKS) == 320 / 1e12
    # B on (2, 4, 8) bf16: q, k, v and out of 64 elements, 2 bytes; 4*2*16*8
    # operations
    assert bounds.attention_bound(2, 4, 8, 2, PEAKS) == max(
        512 / 1e12, 1024 / 1e15)
    # B at the Grid-ViT's shape is bound by its bytes on an H100 (PERF.md)
    h100 = {"bf16_flops_per_s": 9.89e14, "f32_flops_per_s": 6.7e13,
            "hbm_bytes_per_s": 3.35e12}
    assert abs(bounds.attention_bound(32, 576, 1024, 2, h100) * 1e3
               - 0.0451) < 1e-4
    # C: 13 h^2 products a joint and row, weights in bf16
    h, b, j = 4, 2, 3
    ops = 2 * b * h * 13 * h * j
    nbytes = 13 * h * h * 2 + 4 * (b * j * h * 6 + 9 * h)
    assert bounds.pu_chain_bound(b, j, h, 2, PEAKS) == max(nbytes / 1e12,
                                                           ops / 1e15)


def test_forward_calls_follow_the_decoder():
    cfg = tiny_cell("r18.serve-b32").config
    calls = bounds.forward_calls(dict(cfg, image_size=256), 32)
    assert calls["upsample"][:3] == [(32, 8, 8, 1024), (32, 16, 16, 1024),
                                     (32, 32, 32, 512)]
    assert len(calls["upsample"]) == 6 and len(calls["attention"]) == 3


def test_lifter_flops_by_hand():
    cfg = tiny_cell("r18.serve-b32").config     # 16 x 16 heatmaps
    b, d, s, mlp = 2, 1024, 36, 4096            # 36 tokens of width 1024
    with torch.device("meta"):
        lifter = R.EgoTAP(cfg).lifter
        hm = torch.empty(b, 16, 16, 90)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        lifter(hm)
    vit = (2 * b * 30 * 256 * d                     # patch projection
           + 3 * (2 * b * s * d * (4 * d + 2 * mlp)   # q k v o, MLP
                  + 2 * 2 * b * s * s * d))          # QK^T, PV
    fc_pos = 2 * b * 30 * (d * 2048 + 2048 * 512 + 512 * 128)
    fc_rot = 2 * b * 30 * (2 * 256 * 2048 + 2048 * 512 + 512 * 128)
    pu = 2 * b * 15 * (256 * 768 + 256 * 2048 + 256 * 2048
                       + 512 * 2048 + 512 * 512 + 2 * 512 * 2048)
    heads = 2 * b * 15 * 768 * 3 + 2 * b * 7680 * 6
    assert counter.get_total_flops() == vit + fc_pos + fc_rot + pu + heads


def test_flops_scale_with_batch_and_training_adds_backward():
    cfg = tiny_cell("r18.serve-b32").config
    one, two = flops.count(cfg, 1, False), flops.count(cfg, 2, False)
    assert two == 2 * one
    train = flops.count(cfg, 2, True)
    assert two < train < 4 * two
