"""The port's int8 inference ops and modules (egotap_tpu_torch.ops.quant)
against the JAX package's (egotap_tpu.ops.quant) on identical inputs,
and the quantized HeatmapUNet and EgoTAPLifter against the JAX ones under
the same static scales."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.heatmap_net import HeatmapUNet as JaxHeatmapUNet
from egotap_tpu.models.lifter import EgoTAPLifter as JaxLifter
from egotap_tpu.models.vit import ViTBlock as JaxViTBlock
from egotap_tpu.ops import quant as jq
from egotap_tpu_torch.compat.from_jax import (_VIT_NAMES, heatmap_net_from_jax,
                                              install_jax_scales,
                                              lifter_from_jax)
from egotap_tpu_torch.models.resnet import ResNetEncoder
from egotap_tpu_torch.models.vit import ViTBlock
from egotap_tpu_torch.ops import quant as tq
from egotap_tpu_torch.serving import init_weights
from tests.test_torch_compat import LIFTER_SMALL, heatmap_vars, lifter_vars


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _data(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def test_quantize_weights_matches_jax():
    k, d = _data(0, (3, 3, 20, 30), (96, 40))
    wq, ws = jq.quantize_weights(jnp.asarray(k))
    got_q, got_s = tq.quantize_weights(_t(k.transpose(3, 2, 0, 1)))
    np.testing.assert_array_equal(_np(got_q).transpose(2, 3, 1, 0), _np(wq))
    np.testing.assert_array_equal(_np(got_s), _np(ws))
    # dense: JAX (in, out) kernel, per-output-column scale, as
    # quantize_dense_tree computes it
    got_q, got_s = tq.quantize_weights(_t(d.T))
    wq, ws = jq.quantize_weights(jnp.asarray(d)[None, None])
    np.testing.assert_array_equal(_np(got_q).T, _np(wq)[0, 0])
    np.testing.assert_array_equal(_np(got_s), _np(ws))
    # quantize_dense_tree itself runs under jit, where XLA turns the
    # division by 127 into a multiply by its reciprocal: one ulp apart
    tree = jq.quantize_dense_tree({"d": {"kernel": jnp.asarray(d)}})["d"]
    np.testing.assert_array_equal(_np(got_q).T, _np(tree["kernel_q"]))
    np.testing.assert_array_max_ulp(_np(got_s), _np(tree["scale"]), 1)


@pytest.mark.parametrize("static", [False, True])
def test_quantize_activation_matches_jax(static):
    (x,) = _data(1, (2, 5, 7, 24))
    a = np.float32(0.011) if static else None
    xq, s = jq.quantize_activation(jnp.asarray(x), a)
    got_q, got_s = tq.quantize_activation(
        _t(x), None if a is None else torch.tensor(a))
    np.testing.assert_array_equal(_np(got_q), _np(xq))
    assert got_s.item() == float(s)
    if static:                   # the static scale clips: codes saturate
        assert np.abs(_np(got_q)).max() == 127


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("k", [1, 3])
def test_quantized_conv_matches_jax(k, stride, bias, static):
    """20 input channels (im2col depth 20 or 180, padded to 24 or 184)
    and 30 outputs (padded to 32) exercise `int8_matmul`'s padding."""
    x, kern, b = _data(2, (2, 9, 11, 20), (k, k, 20, 30), (30,))
    b = b if bias else None
    a = np.float32(0.02) if static else None
    pad = k // 2
    # int8 codes and int32 sums: equal
    xq, a_used = jq.quantize_activation(jnp.asarray(x), a)
    wq, _ = jq.quantize_weights(jnp.asarray(kern))
    acc = jax.lax.conv_general_dilated(
        xq, wq, (stride, stride), ((pad, pad),) * 2,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    cols, (ho, wo) = tq.im2col(_t(np.asarray(xq)), k, stride, pad)
    got_acc = tq.int8_matmul(cols, tq.conv_weight_rows(
        _t(np.asarray(wq).transpose(3, 2, 0, 1))))
    np.testing.assert_array_equal(_np(got_acc).reshape(acc.shape),
                                  np.asarray(acc))
    # f32 outputs: within one ulp (XLA may contract the dequantization's
    # multiply-add into an FMA, the port rounds after each)
    ref = jq.quantized_conv(jnp.asarray(x), jnp.asarray(kern), stride,
                            ((pad, pad),) * 2,
                            bias=None if b is None else jnp.asarray(b),
                            a_scale=a)
    twq, tws = tq.quantize_weights(_t(kern.transpose(3, 2, 0, 1)))
    got = tq.quantized_conv(_t(x), twq, tws, stride, pad,
                            None if b is None else _t(b),
                            a_scale=None if a is None else torch.tensor(a))
    np.testing.assert_array_max_ulp(_np(got), np.asarray(ref), maxulp=1)


@pytest.mark.parametrize("mode", ["dynamic", "static", "pre_q"])
def test_quantized_dense_matches_jax(mode):
    x, k1, k2, b = _data(3, (3, 17, 72), (72, 40), (72, 40), (40,))
    a = np.float32(0.03) if mode == "static" else None
    if mode == "pre_q":         # one quantized input, two consumers
        pre = jq.quantize_activation(jnp.asarray(x))
        tpre = tq.quantize_activation(_t(x))
        refs = [jq.quantized_dense(jnp.asarray(x), jnp.asarray(k),
                                   jnp.asarray(b), pre_q=pre)
                for k in (k1, k2)]
        gots = [tq.quantized_dense(_t(x), *tq.quantize_weights(_t(k.T)),
                                   _t(b), pre_q=tpre)
                for k in (k1, k2)]
    else:
        refs = [jq.quantized_dense(jnp.asarray(x), jnp.asarray(k1),
                                   jnp.asarray(b), a_scale=a)]
        gots = [tq.quantized_dense(
            _t(x), *tq.quantize_weights(_t(k1.T)), _t(b),
            a_scale=None if a is None else torch.tensor(a))]
    for got, ref in zip(gots, refs):
        assert got.shape == (3, 17, 40)
        np.testing.assert_array_max_ulp(_np(got), np.asarray(ref), maxulp=1)


@pytest.mark.parametrize("in_ch,static,quantized", [
    (32, True, False),            # in_ch < 64: never quantized
    (64, False, False),           # 64..127: float without a static scale
    (64, True, True),             # ... quantized with one
    (128, False, True),           # >= 128: always (dynamic here)
])
def test_qconv_gating_matches_jax(in_ch, static, quantized):
    x, kern, b = _data(4, (2, 6, 6, in_ch), (3, 3, in_ch, 16), (16,))
    variables = {"params": {"kernel": jnp.asarray(kern),
                            "bias": jnp.asarray(b)}}
    a = np.float32(0.03)
    if static:
        variables["qparams"] = {"a_scale": jnp.asarray(a)}
    ref = np.asarray(jq.QConv(16, 3, 1, 1, use_bias=True).apply(
        variables, jnp.asarray(x)))
    conv = tq.QConv(in_ch, 16, 3, 1, 1)
    conv.load_state_dict({"weight": _t(kern.transpose(3, 2, 0, 1)),
                          "bias": _t(b)})
    if static:
        conv.a_scale = torch.tensor(a)
    conv.calibrating = True
    with torch.no_grad():
        got = _np(conv(_t(x)))
    # the float path sums in another order (1e-6); quantized, an ulp
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    plain = torch.nn.functional.conv2d(
        _t(x).permute(0, 3, 1, 2), conv.weight, conv.bias, 1, 1
    ).permute(0, 2, 3, 1).detach().numpy()
    assert np.array_equal(got, plain) != quantized
    # only convs that may quantize read (and record) a static scale
    assert (conv.amax is not None) == (in_ch >= 64)


@pytest.mark.parametrize("kind", ["dense", "conv", "encoder"])
def test_weight_cache_follows_loaded_parameters(kind):
    """The int8 weights a module keeps (`prequantize`) are dropped when
    parameters load: the module then computes what a fresh module with
    those parameters computes, never with its old int8 weights."""
    make, shape = {
        "dense": (lambda: tq.QDense(72, 40), (3, 72)),
        "conv": (lambda: tq.QConv(128, 16, 3, 1, 1), (1, 6, 6, 128)),
        "encoder": (lambda: ResNetEncoder("resnet18", quant=True,
                                          fused_layer1=True), (1, 32, 32, 3)),
    }[kind]
    gen = torch.Generator().manual_seed(0)
    old, new = make(), make()
    for m in (old, new):
        init_weights(m, gen)
        m.eval()
    x = torch.randn(shape, generator=gen)

    def run(m):
        out = m(x)
        return torch.cat([o.flatten() for o in out]) \
            if isinstance(out, list) else out

    with torch.no_grad():
        tq.prequantize([old])
        stale = run(old)
        old.load_state_dict(new.state_dict())
        got, want = run(old), run(new)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(stale, want)


def test_calibration_records_and_installs_like_jax():
    """amax recorded in f32 per module, maximised over batches; QDense
    given ``pre_q`` records none; a_scale = max(amax, 1e-12) / 127."""
    x1, x2 = _data(5, (4, 64), (4, 64))
    stub, dense = tq.QuantStub(), tq.QDense(64, 8)
    tq.set_calibrating([stub, dense], True)
    with torch.no_grad():
        for x in (x1, x2):
            dense(_t(x), pre_q=stub(_t(x)))
        zero = tq.QDense(64, 8)
        zero.calibrating = True
        zero(torch.zeros(4, 64))
    tq.set_calibrating([stub, dense], False)
    assert dense.amax is None and stub.amax.item() == max(
        np.abs(x1).max(), np.abs(x2).max())
    ref = jq.amax_to_qparams({"stub": {"amax": stub.amax.numpy()},
                              "zero": {"amax": zero.amax.numpy()}})
    assert tq.install_scales([stub, dense, zero]) == 2
    assert stub.a_scale.item() == float(ref["stub"]["a_scale"])
    assert zero.a_scale.item() == float(ref["zero"]["a_scale"])   # 1e-12/127
    assert stub.amax is None


def _jax_qparams(model, variables, x, tree_fn):
    """JAX calibration on x, jitted; only its static scales are kept, and
    the port is given the same ones."""
    _, mut = jax.jit(functools.partial(model.apply, train=False,
                                       mutable=["calib"]))(variables, x)
    return jq.merge_qparams(tree_fn(variables["params"]),
                            jq.amax_to_qparams(mut["calib"]))


# With the same static scales both sides quantize the same values. Where
# their float paths differ in the last bit, now and then a value lands on
# the other side of a rounding boundary and its int8 code flips by one,
# and later layers amplify that: the JAX lifter itself moves by 2.5% of
# its max pose for an input scaled by 1 + 1e-7, as much as int8 differs
# from f32 there. Op by op, JAX computes the same IEEE operations as the
# port (the BatchNorm folds, the divisions by 127): the heatmap nets agree
# exactly on these inputs, and the bound allows a few flipped steps (1/127
# of a layer's scale), no cascade; one ViT block alone holds to as much.
# Where flips cascade (the lifter, the Predictor), `CodeTape` stops them:
# every port code array is held against JAX's, code by code, and then
# replaced by it, so the outputs must agree to float rounding.
HEATMAP_TOL, BLOCK_TOL = 1e-3, 1e-3
# `CodeTape`: at most this share of one call's codes may differ, each by
# one step (read: 1.1e-4 with the Predictor's jitted JAX, whose divisions
# by 127 multiply by the reciprocal); the forced outputs then agree to
# FORCED_TOL of their max (read: 1.9e-7 lifter, 2.4e-7 Predictor).
FLIP_RATE, FORCED_TOL = 1e-3, 1e-5


class CodeTape:
    """Teacher forcing for int8 comparisons with JAX. While installed,
    JAX's `quantize_activation` records every int8 code array it returns,
    in call order (an ordered debug callback, so under jit too); the
    port's then holds its own codes at each call against the next
    recorded ones (same shape, at most ``flip_rate`` of them off, by at
    most ``max_step``; by default `FLIP_RATE` and one step) and goes on
    with JAX's. A float rounding that flips a code is counted there
    instead of cascading, and a float module where JAX quantizes,
    or a wrong scale, fails at once."""

    def __init__(self, monkeypatch, flip_rate=FLIP_RATE, max_step=1):
        self.codes, self.used = [], 0
        jax_q, port_q = jq.quantize_activation, tq.quantize_activation

        def record(x, a_scale=None):
            xq, scale = jax_q(x, a_scale)
            jax.debug.callback(lambda c: self.codes.append(np.asarray(c)),
                               xq, ordered=True)
            return xq, scale

        def force(x, a_scale=None):
            xq, scale = port_q(x, a_scale)
            want = self.codes[self.used]
            self.used += 1
            assert xq.shape == want.shape, (self.used, xq.shape, want.shape)
            diff = np.abs(xq.numpy().astype(np.int32) - want)
            share = (diff > 0).mean()
            assert diff.max() <= max_step and share <= flip_rate, (
                self.used, diff.max(), share)
            return torch.tensor(want), scale

        monkeypatch.setattr(jq, "quantize_activation", record)
        monkeypatch.setattr(tq, "quantize_activation", force)

    def check_all_used(self):
        assert 0 < self.used == len(self.codes), (self.used, len(self.codes))


def test_vit_block_quant_matches_jax():
    d, heads = 256, 2
    (x,) = _data(8, (2, 24, d))
    model = JaxViTBlock(d, heads, 4 * d, quant=True)
    v = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3),
                                            jnp.asarray(x)))
    _, mut = model.apply(v, jnp.asarray(x), mutable=["calib"])
    qparams = jq.amax_to_qparams(mut["calib"])
    ref = np.asarray(model.apply({**v, "qparams": qparams}, jnp.asarray(x)))
    blk = ViTBlock(d, heads, 4 * d, quant=True)
    p = v["params"]
    sd = {}
    for f_name, t_name in _VIT_NAMES.items():
        if f_name != "qkv_in":
            sd[t_name + ".weight"] = p[f_name]["kernel"].T
            sd[t_name + ".bias"] = p[f_name]["bias"]
    for f_name, t_name in (("ln_before", "layernorm_before"),
                           ("ln_after", "layernorm_after")):
        sd[t_name + ".weight"] = p[f_name]["scale"]
        sd[t_name + ".bias"] = p[f_name]["bias"]
    blk.load_state_dict({k: _t(np.array(a)) for k, a in sd.items()})
    assert sorted(qparams) == ["attn_out", "mlp_in", "mlp_out", "qkv_in"]
    for f_name, q in qparams.items():
        blk.get_submodule(_VIT_NAMES[f_name]).a_scale = _t(q["a_scale"])
    with torch.no_grad():
        got = _np(blk(_t(x)))
    assert np.abs(got - ref).max() <= BLOCK_TOL * np.abs(ref).max()


def test_heatmap_net_quant_matches_jax():
    maps, image = 4, 32          # layer4 at 1x1: keeps op-by-op JAX short
    v = heatmap_vars(maps, image)
    x = _data(6, (2, 2, image, image, 3))[0]
    model = JaxHeatmapUNet(num_output_maps=maps, quant=True)
    qparams = _jax_qparams(model, v, jnp.asarray(x), jq.quantize_conv_tree)
    ref = np.asarray(model.apply({**v, "qparams": qparams}, jnp.asarray(x),
                                 train=False))                # op by op
    net = heatmap_net_from_jax(v, "resnet18", quant=True, device="cpu")
    # every module that JAX calibrated: 19 ResNet convs (the stem never
    # records) and 8 decoder convs
    assert install_jax_scales(net, qparams) == 27
    tq.prequantize([net])
    with torch.no_grad():
        got = _np(net(_t(x)))
    assert got.shape == ref.shape == (2, image // 4, image // 4, 2 * maps)
    assert np.abs(got - ref).max() <= HEATMAP_TOL * np.abs(ref).max()


def test_lifter_quant_matches_jax(monkeypatch):
    """3 ViT layers, 6 FC blocks and the PU chain, every int8 code array
    held against JAX's (`CodeTape`)."""
    res = 16
    v = lifter_vars(res=res)
    # calibrated on one draw, run on another: static scales are not the
    # dynamic ones of the input
    calib, x = np.random.default_rng(7).uniform(
        0, 1, (2, 2, res, res, 4 * 2 + 4 * 2 * 2)).astype(np.float32)
    model = JaxLifter(**LIFTER_SMALL, quant=True)
    qparams = _jax_qparams(model, v, jnp.asarray(calib),
                           jq.quantize_dense_tree)
    tape = CodeTape(monkeypatch)
    ref = np.asarray(jax.jit(functools.partial(model.apply, train=False))(
        {**v, "qparams": qparams}, jnp.asarray(x)))
    net = lifter_from_jax(v, 3, device="cpu", heatmap_size=res, quant=True,
                          **LIFTER_SMALL)
    # per ViT layer qkv_in, attn_out, mlp_in, mlp_out; 3 + 3 FC blocks
    assert install_jax_scales(net, qparams) == 3 * 4 + 6
    tq.prequantize([net])
    with torch.no_grad():
        got = _np(net(_t(x)))
    tape.check_all_used()
    assert len(tape.codes) == 3 * 4 + 6
    assert got.shape == ref.shape == (2, 5, 3)
    assert np.abs(got - ref).max() <= FORCED_TOL * np.abs(ref).max()
