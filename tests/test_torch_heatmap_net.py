"""The port's stage-1 HeatmapUNet against the JAX package's, on the same
weights (carried across by egotap_tpu_torch.compat.from_jax) and inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.heatmap_net import HeatmapUNet as JaxHeatmapUNet
from egotap_tpu_torch.compat.from_jax import heatmap_net_from_jax
from egotap_tpu_torch.models.heatmap_net import _merge_views
from egotap_tpu_torch.models.resnet import ResNetEncoder
from tests.test_torch_compat import heatmap_vars

# f32: the same convolutions, eval-mode BN and upsamples in f32, summed
# in another order (XLA vs oneDNN). bf16: both sides round every conv
# output to bf16 (BN in f32), in different places and orders, through 20
# layers; the heatmaps then differ by under 1% of their largest value
# (docs/PARITY_TABLE.md measures the same order for JAX bf16 vs f32).
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax(dtype):
    maps, image = 15, 64
    v = heatmap_vars(maps, image)
    x = np.random.default_rng(0).standard_normal(
        (2, 2, image, image, 3)).astype(np.float32)
    ref = JaxHeatmapUNet(num_output_maps=maps).apply(
        v, jnp.asarray(x, getattr(jnp, dtype)), train=False)
    ref = np.asarray(ref, np.float32)
    net = heatmap_net_from_jax(v, "resnet18", device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    assert got.shape == ref.shape == (2, image // 4, image // 4, 2 * maps)
    assert np.abs(got - ref).max() <= TOL[dtype] * np.abs(ref).max()


def test_merge_views_is_view_major():
    """Channel block v of the merged pyramid is view v of the sample."""
    feat = torch.arange(2 * 2 * 1 * 1 * 3.0).reshape(4, 1, 1, 3)
    merged = _merge_views(feat, batch=2, views=2)
    torch.testing.assert_close(merged[1, 0, 0], torch.cat([feat[2, 0, 0],
                                                           feat[3, 0, 0]]))


def test_encoder_pyramid_shapes():
    enc = ResNetEncoder("resnet34").eval()
    with torch.no_grad():
        pyr = enc(torch.randn(1, 64, 64, 3))
    assert [tuple(p.shape[1:]) for p in pyr] == [
        (64, 64, 3), (32, 32, 64), (16, 16, 64), (8, 8, 128), (4, 4, 256),
        (2, 2, 512)]


def test_bottleneck_nets_are_not_ported():
    """Bottleneck nets, refused before they were ported, now build and
    match the JAX encoder (the name is kept from then; the full cases are
    in tests/test_torch_resnet_variants.py)."""
    from egotap_tpu.models.resnet import ResNetEncoder as JaxEncoder
    from egotap_tpu_torch.compat.from_jax import resnet_state_dict
    from tests.test_torch_resnet_variants import (EVAL_TOL, _image, _rel,
                                                  jax_variables)
    x = _image(0, 1, 32, 32, 3)
    model = JaxEncoder("resnet50")
    v = jax_variables(model, (1, 32, 32, 3))
    enc = ResNetEncoder("resnet50").eval()
    enc.load_state_dict(resnet_state_dict(v, "resnet50"), strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    for g, r in zip(got, model.apply(v, jnp.asarray(x), train=False)):
        assert _rel(g, r) <= EVAL_TOL["float32"]
