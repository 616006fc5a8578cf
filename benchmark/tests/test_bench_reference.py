"""The plain reference against the program on the CPU, at a tiny size, in
float32: the serving forward and the first stage-2 training steps."""


import torch

from benchmark import reference as R
from benchmark import weights as W
from benchmark.common import KEYS, draw_states, port_config
from benchmark.drivers import train_lifter
from benchmark.drivers.serve import predictor

from tiny import tiny_cell


def test_serving_forward_matches_the_program_in_f32():
    from egotap_tpu_torch.serving import Predictor
    cell = tiny_cell("r18.serve-b32")
    cfg = cell.config
    model, states = draw_states(cfg, 5, "cpu")
    pred = Predictor(port_config(cfg), states["pos_net"], states["rot_net"],
                     states["lifter"], bf16=False, device="cpu")
    rgb = W.frames(2, 64, 1, 5, KEYS["frames"], "cpu")[0]
    with torch.no_grad():
        pos, rot, pose = model.eval()(rgb)
    hm = torch.from_numpy(pred.heatmaps(rgb.numpy()))
    ref = torch.cat([pos, rot], -1)
    assert (hm - ref).abs().max() <= 1e-5 * ref.abs().max()
    got = torch.from_numpy(pred(rgb.numpy()))
    assert (got - pose).abs().max() <= 1e-5 * pose.abs().max()


def test_serving_cell_builds_the_configured_predictor():
    cell = tiny_cell("r18.serve-b32")
    _, states = draw_states(cell.config, 5, "cpu")
    pred = predictor(cell.config, states, "cpu", 5, 2)
    assert pred.bf16 and pred.int8 == (False, False)
    assert pred.cfg.model_name == "resnet18"


def test_training_steps_match_the_program_in_f32():
    cell = tiny_cell("r18.train2-b32")
    cell.config["use_amp"] = False
    drv = train_lifter.Driver(cell, 9, "cpu")
    drv.setup({})
    assert drv.task.dtype == torch.float32
    gaps = drv.check()
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-4, gaps
    assert gaps["change_gap"] < 1e-3, gaps


def test_fp8_control_rounds_operands():
    x = torch.linspace(-3, 3, 101)
    q = R.Arith(fp8=True).q(x)
    # e4m3 keeps 3 mantissa bits: a rounding moves a value by 2^-4 of it
    assert (q - x).abs().max() > 0
    assert ((q - x).abs() <= x.abs() / 16 + 1e-6).all()
    assert torch.equal(R.F32.q(x), x)
