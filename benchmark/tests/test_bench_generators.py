"""Inputs and weights are a function of the seed alone."""

import torch

from benchmark import reference as R
from benchmark import weights as W
from benchmark.common import draw_states

from tiny import tiny_cell

BIG = 2 ** 31 + 12345


def test_frames_and_poses_repeat_by_seed():
    a = W.frames(2, 32, 3, BIG, 4, "cpu")
    b = W.frames(2, 32, 3, BIG, 4, "cpu")
    c = W.frames(2, 32, 3, BIG + 1, 4, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], a[1])            # the pool's batches differ
    p = W.poses(2, 16, 3, BIG, 5, "cpu")
    assert all(torch.equal(x, y)
               for x, y in zip(p, W.poses(2, 16, 3, BIG, 5, "cpu")))


def test_sub_seeds_take_large_seeds():
    s = {W.sub_seed(seed, key) for seed in (0, 2 ** 31, 2 ** 33 + 1, -5)
         for key in (1, 2)}
    assert len(s) == 8 and all(0 <= x < 2 ** 63 for x in s)


def test_states_repeat_by_seed_and_traffic_files_say_the_same():
    cfg = tiny_cell("r18.serve-b32").config
    _, a = draw_states(cfg, BIG, "cpu")
    _, b = draw_states(cfg, BIG, "cpu")
    _, c = draw_states(cfg, BIG + 1, "cpu")
    for net in a:
        assert all(torch.equal(a[net][k], b[net][k]) for k in a[net])
    key = "after_backbone.conv_up1.0.weight"
    assert not torch.equal(a["pos_net"][key], c["pos_net"][key])
    # the aliases of the trunk are the same tensors
    sd = a["pos_net"]
    assert torch.equal(sd["backbone.backbone.layer0.0.weight"],
                       sd["backbone.backbone.backbone.conv1.weight"])


def test_training_lifter_style_is_the_reference_init():
    with torch.device("meta"):
        lifter = R.EgoTAP(tiny_cell("r18.train2-b32").config).lifter
    sd = W.draw_state(lifter, 3, 3, "cpu", style="train")
    w = sd["pos_heatmap_encoder.fc1.fc.weight"]
    assert abs(w.std().item() - (2.0 / w.shape[1]) ** 0.5) < 0.05 * w.std()
    assert sd["pos_heatmap_encoder.fc1.fc.bias"].abs().max() == 0
    assert sd["pos_heatmap_encoder.fc1.bn.running_var"].eq(1).all()
