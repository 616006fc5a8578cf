"""The port's serving Predictor against the JAX package's, end to end
(stereo RGB -> pose) at a small size: 4 joints, 64x64 images (16x16
heatmaps), resnet18 heatmap nets, lifter hidden 32, ViT 1024 x 3."""

import numpy as np
import pytest
import torch

from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.serving import Predictor as JaxPredictor
from egotap_tpu_torch.compat.from_jax import (heatmap_net_state_dict,
                                              lifter_state_dict)
from egotap_tpu_torch.serving import Predictor, serving_config
from tests.test_torch_compat import heatmap_vars, lifter_vars

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


def _jax_predictor(variables, bf16):
    cfg = JaxConfig(joint_preset="UnrealEgo", model="egotap_autoencoder",
                    heatmap_type="sin", skel_layer="PU",
                    patched_heatmap_ae=True, **SMALL).derive()
    return JaxPredictor(cfg, *variables, bf16=bf16, int8=False)


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


def test_heatmaps_match_jax(weights, rgb):
    jax_vars, states = weights
    ref = _jax_predictor(jax_vars, bf16=False).heatmaps(rgb)
    got = Predictor(serving_config(**SMALL), *states, bf16=False,
                    device="cpu").heatmaps(rgb)
    assert got.shape == ref.shape == (2, 16, 16, 2 * 4 + 2 * 8)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


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
