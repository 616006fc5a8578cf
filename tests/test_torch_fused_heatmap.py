"""The port's FusedHeatmapUNet, fuse_heatmap_variables and split_views
against the JAX package's (`egotap_tpu/models/heatmap_net.py:100-225`),
and the fused net against the two separate nets it was built from."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egotap_tpu.models.heatmap_net import FusedHeatmapUNet as JaxFused
from egotap_tpu.models.heatmap_net import HeatmapUNet as JaxHeatmapUNet
from egotap_tpu.models.heatmap_net import fuse_heatmap_variables as jax_fuse
from egotap_tpu.models.heatmap_net import split_views as jax_split_views
from egotap_tpu_torch.compat.from_jax import (fused_heatmap_state_dict,
                                              heatmap_net_from_jax)
from egotap_tpu_torch.models.heatmap_net import (FusedHeatmapUNet,
                                                 fuse_heatmap_variables,
                                                 split_views)
from tests.test_torch_resnet_variants import _image, _rel, jax_variables

# Fused against separate, f32: the JAX package's own bound
# (tests/test_fused_heatmap.py:60), absolute, and in bf16 the heatmap
# net's budget (tests/test_torch_heatmap_net.py); the port reads 0 in
# both (each group's conv computes as the separate net's). Fused against
# JAX's fused net: f32 summation order (read 1.8e-6 of the max), bf16
# that budget (read 7.4e-3).
SEPARATE_ATOL = 2e-4
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# training mode: batch statistics over the whole folded batch (JAX's
# fused trunk has one BatchNorm group), f32 noise through them (read
# 2.7e-6), and the running statistics (read 1.8e-6 absolute)
TRAIN_TOL, STATS_TOL = 1e-4, 1e-5
MAPS, IMAGE = (15, 30), 64


@pytest.fixture(scope="module")
def variables():
    shape = (1, 2, IMAGE, IMAGE, 3)
    pv, rv = (jax_variables(JaxHeatmapUNet(num_output_maps=m), shape,
                            seed=s) for m, s in zip(MAPS, (0, 1)))
    return pv, rv, jax_fuse([pv, rv])


def _fused_from_jax(fv):
    net = FusedHeatmapUNet(MAPS)
    net.load_state_dict(fused_heatmap_state_dict(fv), strict=True)
    return net


def test_fuse_matches_jax_fuse(variables):
    """The port's fuse of the two port nets is the bridge of JAX's fuse,
    key for key and bit for bit."""
    pv, rv, fv = variables
    nets = [heatmap_net_from_jax(v, device="cpu") for v in (pv, rv)]
    mine = fuse_heatmap_variables([n.state_dict() for n in nets])
    want = fused_heatmap_state_dict(fv)
    assert sorted(mine) == sorted(want)
    for key, value in want.items():
        assert torch.equal(mine[key], value), key
    assert sorted(mine) == sorted(FusedHeatmapUNet(MAPS).state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_matches_jax_and_separate(variables, dtype):
    pv, rv, fv = variables
    x = _image(0, 2, 2, IMAGE, IMAGE, 3)
    tdt = getattr(torch, dtype)
    ref = JaxFused(out_maps=MAPS).apply(
        fv, jnp.asarray(x, getattr(jnp, dtype)), train=False)
    fused = _fused_from_jax(fv).eval()
    nets = [heatmap_net_from_jax(v, device="cpu") for v in (pv, rv)]
    with torch.no_grad():
        got = fused(torch.from_numpy(x).to(tdt))
        separate = torch.cat([n(torch.from_numpy(x).to(tdt)) for n in nets],
                             dim=-1)
    assert got.shape == (2, IMAGE // 4, IMAGE // 4, 2 * sum(MAPS))
    assert got.dtype == tdt
    assert _rel(got, ref) <= TOL[dtype]
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), separate.numpy(),
                                   atol=SEPARATE_ATOL)
    else:
        assert _rel(got, separate.float().numpy()) <= TOL[dtype]


def test_fused_trains_like_jax(variables):
    _, _, fv = variables
    x = _image(1, 2, 2, IMAGE, IMAGE, 3)
    ref, upd = JaxFused(out_maps=MAPS).apply(
        fv, jnp.asarray(x), train=True, mutable=["batch_stats"])
    fused = _fused_from_jax(fv).train()
    got = fused(torch.from_numpy(x))
    assert _rel(got, ref) <= TRAIN_TOL
    want = fused_heatmap_state_dict({"params": fv["params"],
                                     "batch_stats": upd["batch_stats"]})
    for key, value in fused.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       atol=STATS_TOL, err_msg=key)


@pytest.mark.parametrize("views", [1, 2, 3])
def test_split_views_matches_jax(views):
    x = _image(2, 2, 4, 4, 6 * views)
    got = split_views(torch.from_numpy(x), views)
    ref = jax_split_views(jnp.asarray(x), views)
    assert len(got) == len(ref) == views
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    with pytest.raises(ValueError):
        split_views(torch.zeros(1, 7), 2)
