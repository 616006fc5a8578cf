"""The port's int8 serving path against the benchmark's plain int8
reference (`benchmark/reference_int8.py`), on the CPU at a small size, in
float32 and with seeded weights.

In float32 the two compute the same integer products from the same codes
and dequantise them alike, so where both hold the same static scales they
agree to float32 rounding; the reference's own calibration follows the
program's protocol. Each module that runs int8 products gives, from its
own input, the reference's exact product to float32 rounding. The
bfloat16 `Predictor` with int8 off, the program's int8 modules computing
float products, and the reference at 4 bits, are the controls that the
tolerances must reject. The reference's list of int8 products agrees
with the program's counters.
"""

import copy
import json
import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import control_int8  # noqa: E402
from benchmark import reference_int8 as Q  # noqa: E402
from benchmark import weights as W  # noqa: E402
from benchmark.common import KEYS, draw_states, port_config  # noqa: E402
from benchmark.drivers import serve  # noqa: E402
from benchmark.drivers.serve_int8 import (product_rms,  # noqa: E402
                                          program_scales)
from egotap_tpu_torch.serving import Predictor  # noqa: E402
from egotap_tpu_torch.utils import profiling  # noqa: E402

SEED = 2 ** 31 + 911
BATCH = 1
# Stage 1: the same codes, products and dequantisation; the float32 stem
# convolution (NHWC against NCHW) is the one place the two may round apart.
HEATMAP_RMS = 1e-6
# Scales of the heatmap nets: from the same calibration forward.
SCALE_GAP_STAGE1 = 1e-6
# Scales of the lifter: its calibration forward quantises dynamically, so
# float32 rounding differences of the float parts (attention, GELU, the
# position embeddings) flip codes and move later maxima (4e-3 read).
SCALE_GAP_LIFTER = 2e-2
# The pose with the program's scales in the reference: float32 rounding of
# the float parts (the PU chain, attention) alone (3e-7 read).
POSE_MAX = 1e-5
# Each int8 module from its own input with the program's scales: the same
# codes and exact sums, the dequantisation's float32 rounding alone (about
# 1e-7 read); an int8 module computing a float product reads its int8
# rounding (about 1e-2).
PRODUCT_RMS = 1e-5


def small_cfg():
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "egotap-unrealego-r18-int8.json")) as f:
        cfg = json.load(f)
    cfg["image_size"] = 64
    cfg["load_size_heatmap"] = [16, 16]
    cfg["widths"]["vit_tokens"] = 36
    return cfg


def rel_rms(got, ref):
    return float((got - ref).square().mean().sqrt()
                 / ref.square().mean().sqrt())


def rel_max(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def stack_and_pose(pred, rgb):
    """The program's heatmap stack (f32) and pose for ``rgb``."""
    kept = {}
    hooks = [net.register_forward_hook(
        lambda _m, _a, out, i=i: kept.__setitem__(i, out))
        for i, net in enumerate((pred.pos_net, pred.rot_net))]
    try:
        pose = torch.from_numpy(pred(rgb.numpy()))
    finally:
        for h in hooks:
            h.remove()
    return torch.cat([kept[0].float(), kept[1].float()], -1), pose


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the float64 convolutions' thread pool stalls when oversubscribed."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup(one_thread):
    cfg = small_cfg()
    model, states = draw_states(cfg, SEED, "cpu")
    calib = serve.calibration_frames(cfg, SEED, BATCH, "cpu")
    rgb = W.frames(BATCH, cfg["image_size"], 1, SEED, KEYS["frames"],
                   "cpu")[0]
    pred = Predictor(port_config(cfg), states["pos_net"], states["rot_net"],
                     states["lifter"], bf16=False, device="cpu")
    pred.calibrate(calib)
    ref = Q.Int8EgoTAP(copy.deepcopy(model), cfg).calibrate(calib)
    with torch.no_grad():
        pos, rot, pose = ref(rgb)
    return dict(cfg=cfg, model=model, states=states, calib=calib, rgb=rgb,
                pred=pred, ref=ref, ref_out=(torch.cat([pos, rot], -1), pose))


def test_int8_predictor_matches_the_plain_int8_reference(setup):
    pred, ref = setup["pred"], setup["ref"]
    scales = program_scales(pred)
    assert sorted(scales) == sorted(set(ref.ar.plan.values()))
    for key, s in scales.items():
        gap = float((s - ref.ar.scales[key]).abs() / s)
        limit = SCALE_GAP_LIFTER if key.startswith("lifter.") \
            else SCALE_GAP_STAGE1
        assert gap <= limit, (key, gap)
    hm, pose = stack_and_pose(pred, setup["rgb"])
    ref_hm, _ = setup["ref_out"]
    assert rel_rms(hm, ref_hm) <= HEATMAP_RMS
    ref.use_scales(scales)
    with torch.no_grad():
        _, _, ref_pose = ref(setup["rgb"])
    assert rel_max(pose, ref_pose) <= POSE_MAX


def test_controls_exceed_the_tolerances(setup):
    cfg, rgb = setup["cfg"], setup["rgb"]
    ref_hm, ref_pose = setup["ref_out"]
    states = setup["states"]
    bf16 = Predictor(port_config(cfg), states["pos_net"], states["rot_net"],
                     states["lifter"], bf16=True, int8=False, device="cpu")
    hm, pose = stack_and_pose(bf16, rgb)
    assert rel_rms(hm, ref_hm) > 100 * HEATMAP_RMS
    assert rel_max(pose, ref_pose) > 100 * POSE_MAX
    four = Q.Int8EgoTAP(copy.deepcopy(setup["model"]), cfg, bits=4)
    four.calibrate(setup["calib"])
    with torch.no_grad():
        pos, rot, pose4 = four(rgb)
    assert four.ar.qmax == 7.0
    assert rel_rms(torch.cat([pos, rot], -1), ref_hm) > 100 * HEATMAP_RMS
    assert rel_max(pose4, ref_pose) > 100 * POSE_MAX


def test_int8_modules_match_the_reference_products(setup):
    """Every int8 module of the program from its own input, against the
    reference's exact product with the program's scales; the program with
    float products in those modules, and with int8 off, fail."""
    pred, ref, rgb = setup["pred"], setup["ref"], setup["rgb"].numpy()
    ref.use_scales(program_scales(pred))
    assert len(ref.sites) == 2 * (8 + 8) + 3 * 6 + 2 * 3
    assert product_rms(pred, ref, rgb) <= PRODUCT_RMS
    undo = control_int8.float_products()
    try:
        assert product_rms(pred, ref, rgb) > 100 * PRODUCT_RMS
    finally:
        undo()
    undo = control_int8.float_products(stage1=False)
    try:
        assert product_rms(pred, ref, rgb) > 100 * PRODUCT_RMS
    finally:
        undo()
    states = setup["states"]
    bf16 = Predictor(port_config(setup["cfg"]), states["pos_net"],
                     states["rot_net"], states["lifter"], bf16=True,
                     int8=False, device="cpu")
    assert math.isnan(product_rms(bf16, ref, rgb))


def test_int8_products_agree_with_the_program_counters(setup):
    products = Q.int8_products(setup["cfg"], BATCH)
    profiling.reset()
    profiling.enable()
    try:
        setup["pred"](setup["rgb"].numpy())
    finally:
        profiling.disable()
    counts = profiling.counters()["serve.request"]
    profiling.reset()
    assert counts["int8.products"] == len(products)
    assert counts["int8.macs"] == sum(m * n * k for m, n, k in products)
    assert counts.get("int8.float_convs", 0) == 0
    # two nets: 19 trunk convolutions after the float stem and 8 of the
    # decoder each; the lifter: 3 ViT layers of 6 products, 2 FC stacks of 3
    assert len(products) == 2 * (19 + 8) + 3 * 6 + 2 * 3
    assert all(min(p) > 0 for p in products)
