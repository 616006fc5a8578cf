"""The port's serving Predictor against the JAX package's, end to end
(stereo RGB -> pose) at a small size: 4 joints, 64x64 images (16x16
heatmaps), resnet18 heatmap nets, lifter hidden 32, ViT 1024 x 3."""

import numpy as np
import pytest
import torch

from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.serving import Predictor as JaxPredictor
from egotap_tpu_torch.compat.from_jax import (heatmap_net_state_dict,
                                              jax_scales, lifter_state_dict)
from egotap_tpu_torch.ops.quant import Calibrated
from egotap_tpu_torch.serving import Predictor, serving_config
from tests.test_torch_compat import heatmap_vars, lifter_vars
from tests.test_torch_quant import FLIP_RATE, FORCED_TOL, CodeTape

SMALL = dict(num_heatmap=4, num_rot_heatmap=4, ae_hidden_size=32,
             load_size_heatmap=(16, 16))
# f32: same math, other summation orders. bf16: both sides compute in
# bf16 (norms in f32); the port keeps f32 attention scores and PU state
# where the JAX default paths round to bf16 (see test_torch_lifter).
TOL = {"float32": 1e-5, "bfloat16": 5e-2}


@pytest.fixture(scope="module")
def weights():
    hv = heatmap_vars(4, 64)
    rv = heatmap_vars(8, 64, seed=1)
    lv = lifter_vars(res=16, seed=2)
    return (hv, rv, lv), (heatmap_net_state_dict(hv),
                          heatmap_net_state_dict(rv), lifter_state_dict(lv))


@pytest.fixture(scope="module")
def rgb():
    return np.random.default_rng(0).standard_normal(
        (2, 2, 64, 64, 3)).astype(np.float32)


def _jax_predictor(variables, bf16, int8=False):
    cfg = JaxConfig(joint_preset="UnrealEgo", model="egotap_autoencoder",
                    heatmap_type="sin", skel_layer="PU",
                    patched_heatmap_ae=True, **SMALL).derive()
    return JaxPredictor(cfg, *variables, bf16=bf16, int8=int8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax_predictor(weights, rgb, dtype):
    jax_vars, states = weights
    bf16 = dtype == "bfloat16"
    ref = _jax_predictor(jax_vars, bf16)(rgb)
    pred = Predictor(serving_config(**SMALL), *states, bf16=bf16,
                     device="cpu")
    got = pred(rgb)
    assert got.dtype == np.float32 and got.shape == ref.shape == (2, 5, 3)
    assert np.abs(got - ref).max() <= TOL[dtype] * np.abs(ref).max()


# `heatmaps` runs the nets on the f32 input, as JAX's does, also with
# bf16=True. f32: same math, other summation orders. bf16: the port's
# bf16 predictor stores its conv weights rounded to bf16, JAX keeps them
# in f32, so the two f32 stacks differ by that rounding (read 5.6e-3 of
# max); the limit is the bf16 heatmap net's (tests/test_torch_heatmap_net.py)
HEATMAP_TOL = {False: 1e-5, True: 2e-2}


@pytest.mark.parametrize("bf16", [False, True])
def test_heatmaps_match_jax(weights, rgb, bf16):
    jax_vars, states = weights
    ref = _jax_predictor(jax_vars, bf16=bf16).heatmaps(rgb)
    got = Predictor(serving_config(**SMALL), *states, bf16=bf16,
                    device="cpu").heatmaps(rgb)
    assert got.shape == ref.shape == (2, 16, 16, 2 * 4 + 2 * 8)
    assert np.abs(got - ref).max() <= HEATMAP_TOL[bf16] * np.abs(ref).max()


def test_from_reference_checkpoints(weights, rgb, tmp_path):
    """Reference-layout .pth files (written with torch.save) strict-load
    into the port and give the same poses as the in-memory weights."""
    _, states = weights
    paths = []
    for name, sd in zip(("HeatMap", "RotHeatMap", "AutoEncoder"), states):
        path = str(tmp_path / f"best_net_{name}.pth")
        torch.save(sd, path)
        paths.append(path)
    pred = Predictor.from_reference_checkpoints(
        *paths, preset="UnrealEgo", bf16=False, device="cpu", **SMALL)
    direct = Predictor(serving_config(**SMALL), *states, bf16=False,
                       device="cpu")
    np.testing.assert_array_equal(pred(rgb), direct(rgb))


def test_strict_load_rejects_missing_keys(weights):
    _, (hs, rs, ls) = weights
    broken = {k: v for k, v in ls.items() if "pose_mlp" not in k}
    with pytest.raises(RuntimeError, match="pose_mlp"):
        Predictor(serving_config(**SMALL), hs, rs, broken, device="cpu")


def test_seeded_random_weights_are_reproducible(rgb):
    a = Predictor(serving_config(**SMALL), bf16=False, device="cpu", seed=3)
    b = Predictor(serving_config(**SMALL), bf16=False, device="cpu", seed=3)
    out = a(rgb)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out, b(rgb))


# The calibrated int8 Predictor against JAX's (both int8 flags),
# calibration included, in f32 and in the serving configuration's bf16.
# JAX runs it jitted, where XLA multiplies by 1/127 instead of dividing,
# so now and then an int8 code lands one step off the port's, and a flip
# cascades through the lifter to a few % of the pose
# (tests/test_torch_quant.py). `CodeTape` holds every code array of both
# calibration batches and of the request against JAX's and goes on with
# JAX's. f32 (read: 49 of 9.4M codes one step off): the static scales
# agree to 1e-5 (read 7.9e-7: max|x| / 127 of inputs that agree to float
# rounding), the poses to FORCED_TOL (read 2.4e-7). bf16: XLA's and
# PyTorch's CPU bf16 convolutions round differently (the bf16 heatmap
# net's outputs differ in about three quarters of their elements, as
# jitted JAX's differ from op-by-op JAX's), and one bf16 ulp at the top of a tensor's
# range is one int8 step: read at most 2 steps off, in at most 22.8% of
# one call's codes, scales 8.8e-3 apart (about 2 bf16 ulps), poses 4.7e-3
# of max; the limits below are 1.5-4 times that, and the pose's is the
# bf16 Predictor's (TOL).
INT8_LIMITS = {  # bf16: (codes: share, step; scales rtol; pose of max)
    False: (FLIP_RATE, 1, 1e-5, FORCED_TOL),
    True: (0.35, 3, 2e-2, TOL["bfloat16"]),
}


@pytest.mark.parametrize("bf16", [False, True])
def test_calibrated_int8_matches_jax(weights, rgb, monkeypatch, bf16):
    jax_vars, states = weights
    flip_rate, max_step, scale_rtol, pose_tol = INT8_LIMITS[bf16]
    calib = [rgb + 0.1 * np.random.default_rng(10 + i).standard_normal(
        rgb.shape).astype(np.float32) for i in range(2)]
    tape = CodeTape(monkeypatch, flip_rate, max_step)
    jax_pred = _jax_predictor(jax_vars, bf16=bf16, int8=True)
    jax_pred.calibrate(calib)
    ref = jax_pred(rgb)
    pred = Predictor(serving_config(**SMALL), *states, bf16=bf16, int8=True,
                     device="cpu")
    assert not pred._has_static_scales()
    pred.calibrate(calib)
    assert pred._has_static_scales()
    for net, variables in zip(pred.nets, jax_pred._vars):
        want = jax_scales(variables["qparams"])
        got = {n: m.a_scale.numpy() for n, m in net.named_modules()
               if isinstance(m, Calibrated) and m.a_scale is not None}
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name],
                                       rtol=scale_rtol, err_msg=name)
    got = pred(rgb)
    tape.check_all_used()
    assert got.shape == ref.shape == (2, 5, 3) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= pose_tol * np.abs(ref).max()


def test_int8_follows_the_config_flags(weights):
    _, states = weights
    cfg = serving_config(int8_heatmap_inference=True, **SMALL)
    pred = Predictor(cfg, *states, device="cpu")
    assert pred.int8 == (True, False)
    assert Predictor(cfg, *states, int8=False, device="cpu").int8 == (
        False, False)
    assert not any(isinstance(m, Calibrated) for m in pred.lifter.modules())
    pred.calibrate([np.zeros((1, 2, 64, 64, 3), np.float32)])
    # the lifter, not int8, records nothing; the heatmap nets have scales
    assert pred._has_static_scales()
