"""The port's weight bridge (egotap_tpu_torch.compat.from_jax) against the
JAX package's exporter, key for key and bit for bit, plus shared helpers
for the port's parity tests (JAX variables made from a seed)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.compat.export import export_heatmap_net, export_lifter
from egotap_tpu.models.heatmap_net import HeatmapUNet as JaxHeatmapUNet
from egotap_tpu.models.lifter import EgoTAPLifter as JaxLifter
from egotap_tpu_torch.compat import from_jax


def randomize(variables, seed):
    """Non-trivial BatchNorm/LayerNorm affine and running statistics and a
    non-zero mask token, so eval-mode parity is a real test; everything
    else keeps the JAX init."""
    rng = np.random.default_rng(seed)

    def visit(tree, col):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = visit(v, col)
                continue
            v = np.asarray(v, np.float32)
            if col == "batch_stats" and k == "mean":
                v = rng.normal(0, 0.05, v.shape)
            elif col == "batch_stats" and k == "var":
                v = rng.uniform(0.8, 1.2, v.shape)
            elif k == "scale":
                v = 1 + rng.normal(0, 0.05, v.shape)
            elif k == "bias" or k == "mask_token":
                v = rng.normal(0, 0.05, v.shape)
            out[k] = np.asarray(v, np.float32)
        return out

    return {col: visit(tree, col) for col, tree in variables.items()}


@functools.lru_cache(maxsize=None)
def heatmap_vars(num_maps, image, seed=0, model_name="resnet18"):
    model = JaxHeatmapUNet(num_output_maps=num_maps, model_name=model_name)
    x = jnp.zeros((1, 2, image, image, 3))
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), x)
    return randomize(jax.tree.map(np.asarray, v), seed)


LIFTER_SMALL = dict(num_heatmap=4, num_joints=5, hidden_size=32)


@functools.lru_cache(maxsize=None)
def lifter_vars(res=32, seed=0, **kw):
    kw = {**LIFTER_SMALL, **kw}
    model = JaxLifter(**kw)
    nh = kw["num_heatmap"]
    nr = kw.get("num_rot_heatmap") or nh
    x = jnp.zeros((1, res, res, 2 * nh + 2 * 2 * nr))   # 2 views, sin limbs
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), x)
    return randomize(jax.tree.map(np.asarray, v), seed)


def _assert_same(ours, ref):
    assert list(ours) == list(ref)
    for k in ref:
        a, b = ours[k].numpy(), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


class TestStateDictMatchesExporter:
    def test_heatmap_net(self):
        v = heatmap_vars(15, 64)
        _assert_same(from_jax.heatmap_net_state_dict(v, "resnet18"),
                     export_heatmap_net(v, "resnet18"))

    def test_lifter(self):
        v = lifter_vars()
        _assert_same(from_jax.lifter_state_dict(v, 3),
                     export_lifter(v, 3))

    def test_lifter_without_global_head(self):
        """EgoCap-style lifter: no head joint and no offset -> no
        global_mlp keys on either side."""
        v = lifter_vars(num_joints=4, use_global_offset=False)
        ours = from_jax.lifter_state_dict(v, 3)
        assert not any(k.startswith("global_mlp") for k in ours)
        _assert_same(ours, export_lifter(v, 3))


class TestStrictLoad:
    def test_heatmap_net_modules_hold_the_weights(self):
        v = heatmap_vars(15, 64)
        net = from_jax.heatmap_net_from_jax(v, "resnet18", device="cpu")
        sd = net.state_dict()
        ref = export_heatmap_net(v, "resnet18")
        assert set(sd) == set(ref)
        # the Encoder_Block aliases are the same tensors, not copies
        assert (net.backbone.backbone.layer0[0].weight
                is net.backbone.backbone.backbone.conv1.weight)
        np.testing.assert_array_equal(
            sd["backbone.backbone.layer1.1.0.conv1.weight"].numpy(),
            ref["backbone.backbone.backbone.layer1.0.conv1.weight"])

    def test_lifter_round_trip(self):
        v = lifter_vars()
        net = from_jax.lifter_from_jax(v, 3, device="cpu", **LIFTER_SMALL,
                                       heatmap_size=32)
        _assert_same({k: t for k, t in net.state_dict().items()},
                     export_lifter(v, 3))

    def test_default_device_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            from_jax.heatmap_net_from_jax(heatmap_vars(15, 64), "resnet18")
