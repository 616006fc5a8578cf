"""The port's legacy stage-2 encoders and their layers against the JAX
package's: `ConvBlock` (`egotap_tpu/models/layers.py:192-215`),
`ConvHeatmapEncoder` and `HeatmapDecoder` (`models/encoders.py:48-103`,
the decoder's transposed convs with kernels that are not symmetric), and
an int8 `FCBlock` in training mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egotap_tpu.models.encoders import ConvHeatmapEncoder as JaxConvEncoder
from egotap_tpu.models.encoders import HeatmapDecoder as JaxDecoder
from egotap_tpu.models.layers import ConvBlock as JaxConvBlock
from egotap_tpu.models.layers import FCBlock as JaxFCBlock
from egotap_tpu_torch.compat.from_jax import (conv_encoder_state_dict,
                                              heatmap_decoder_state_dict)
from egotap_tpu_torch.models.encoders import ConvHeatmapEncoder, HeatmapDecoder
from egotap_tpu_torch.models.layers import ConvBlock, FCBlock
from tests.test_torch_resnet_variants import _image, _rel, jax_variables

# f32, relative to the output's max: the same convs, products and
# BatchNorms summed in another order (read up to 9.0e-7 in eval mode);
# training mode takes batch statistics over the 4 rows of a batch in the
# FC blocks, which divides that noise by their deviation (read up to
# 7.7e-6); the running statistics (read up to 4.2e-7 absolute).
TOL, TRAIN_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5


def _running_close(module, want):
    for key, value in module.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       atol=STATS_TOL, err_msg=key)


@pytest.mark.parametrize("train", [False, True])
def test_conv_block_matches_jax(train):
    x = _image(0, 4, 16, 16, 6)
    model = JaxConvBlock(8)
    v = jax_variables(model, (1, 16, 16, 6))
    out = model.apply(v, jnp.asarray(x), train=train,
                      mutable=["batch_stats"] if train else False)
    ref = out[0] if train else out
    block = ConvBlock(6, 8)
    p, s = v["params"], v["batch_stats"]
    block.load_state_dict({
        "conv.weight": torch.from_numpy(p["conv"]["kernel"].transpose(
            3, 2, 0, 1).copy()),
        "conv.bias": torch.from_numpy(p["conv"]["bias"]),
        "bn.weight": torch.from_numpy(p["bn"]["scale"]),
        "bn.bias": torch.from_numpy(p["bn"]["bias"]),
        "bn.running_mean": torch.from_numpy(s["bn"]["mean"]),
        "bn.running_var": torch.from_numpy(s["bn"]["var"]),
        "bn.num_batches_tracked": torch.tensor(0)})
    got = block.train(train)(torch.from_numpy(x))
    assert got.shape == (4, 8, 8, 8)
    assert _rel(got, ref) <= (TRAIN_TOL if train else TOL)
    if train:
        np.testing.assert_allclose(
            block.bn.running_var.numpy(),
            np.asarray(out[1]["batch_stats"]["bn"]["var"]), atol=STATS_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_conv_encoder_matches_jax(train):
    x = _image(1, 4, 64, 64, 30)
    model = JaxConvEncoder(hidden_size=32)
    v = jax_variables(model, (1, 64, 64, 30), seed=1)
    out = model.apply(v, jnp.asarray(x), train=train,
                      mutable=["batch_stats"] if train else False)
    enc = ConvHeatmapEncoder(30, hidden_size=32)
    enc.load_state_dict(conv_encoder_state_dict(v), strict=True)
    got = enc.train(train)(torch.from_numpy(x))
    assert got.shape == (4, 32)
    if not train:
        assert _rel(got, out) <= TOL
        return
    assert _rel(got, out[0]) <= TRAIN_TOL
    _running_close(enc, conv_encoder_state_dict(
        {"params": v["params"], "batch_stats": out[1]["batch_stats"]}))


@pytest.mark.parametrize("train", [False, True])
def test_heatmap_decoder_matches_jax(train):
    """Flax's ConvTranspose does not flip its kernel and PyTorch's does:
    the bridge flips it, which only a kernel that is not symmetric
    shows (the unflipped weights are the control)."""
    z = _image(2, 4, 32)
    model = JaxDecoder(num_heatmap=15)
    v = jax_variables(model, (1, 32), seed=2)
    kernel = v["params"]["deconv1"]["kernel"]
    assert not np.allclose(kernel, kernel[::-1, ::-1], atol=1e-2)
    out = model.apply(v, jnp.asarray(z), train=train,
                      mutable=["batch_stats"] if train else False)
    ref = out[0] if train else out
    dec = HeatmapDecoder(32, 15)
    sd = heatmap_decoder_state_dict(v)
    dec.load_state_dict(sd, strict=True)
    got = dec.train(train)(torch.from_numpy(z))
    assert got.shape == (4, 64, 64, 15)
    assert _rel(got, ref) <= (TRAIN_TOL if train else TOL)
    if train:
        _running_close(dec, heatmap_decoder_state_dict(
            {"params": v["params"], "batch_stats": out[1]["batch_stats"]}))
    else:
        for i in (1, 2, 3):
            sd[f"deconv{i}.weight"] = sd[f"deconv{i}.weight"].flip(2, 3)
        dec.load_state_dict(sd)
        assert _rel(dec(torch.from_numpy(z)), ref) > 100 * TOL


def test_int8_fc_block_trains_like_jax():
    """JAX's FCBlock takes nn.Dense under train=True whatever quant says
    (`egotap_tpu/models/layers.py:170-173`); the port ran its int8 product
    there."""
    x = _image(3, 16, 96)
    model = JaxFCBlock(64, quant=True)
    v = jax_variables(model, (1, 96), seed=3)
    ref, upd = model.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    block = FCBlock(96, 64, quant=True)
    p, s = v["params"], upd["batch_stats"]
    block.load_state_dict({
        "fc.weight": torch.from_numpy(p["fc"]["kernel"].T.copy()),
        "fc.bias": torch.from_numpy(p["fc"]["bias"]),
        "bn.weight": torch.from_numpy(p["bn"]["scale"]),
        "bn.bias": torch.from_numpy(p["bn"]["bias"]),
        "bn.running_mean": torch.from_numpy(v["batch_stats"]["bn"]["mean"]),
        "bn.running_var": torch.from_numpy(v["batch_stats"]["bn"]["var"]),
        "bn.num_batches_tracked": torch.tensor(0)})
    got = block.train()(torch.from_numpy(x))
    assert _rel(got, ref) <= TRAIN_TOL
    np.testing.assert_allclose(block.bn.running_mean.numpy(),
                               np.asarray(s["bn"]["mean"]), atol=STATS_TOL)
