"""The Bottleneck ResNets (resnet50, resnet101), the space-to-depth stem,
int8 blocks in training mode and the fused-layer1 gate of the port's
`models/resnet.py`, against the JAX package's `models/resnet.py` on the
same weights (carried by `compat.from_jax`) and inputs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn

from egotap_tpu.compat.export import (_TorchWriter, _export_resnet,
                                      export_heatmap_net)
from egotap_tpu.models.heatmap_net import HeatmapUNet as JaxHeatmapUNet
from egotap_tpu.models.resnet import RESNET_SPECS
from egotap_tpu.models.resnet import Bottleneck as JaxBottleneck
from egotap_tpu.models.resnet import ResNetEncoder as JaxEncoder
from egotap_tpu.models.resnet import S2DStemConv as JaxS2DStem
from egotap_tpu_torch.compat.from_jax import (heatmap_net_state_dict,
                                              resnet_state_dict)
from egotap_tpu_torch.models import resnet
from egotap_tpu_torch.models.heatmap_net import HeatmapUNet
from egotap_tpu_torch.models.initializers import load_imagenet_backbone
from egotap_tpu_torch.models.resnet import ResNetEncoder, S2DStemConv
from tests.test_torch_compat import randomize
from tests.test_torch_quant import CodeTape

# Eval mode, relative to each pyramid level's max: f32 computes the same
# convolutions and BatchNorms summed in another order (XLA vs oneDNN;
# read up to 1.2e-6 at resnet50); bf16 rounds every conv output on both
# sides in different places (the budget of tests/test_torch_heatmap_net.py).
EVAL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# Training mode, each block fed JAX's output of the block before (a
# whole trunk's outputs are ill-conditioned: batch statistics over a few
# values a channel, 8 at layer4 of a (2, 64, 64) batch, divide the
# summation-order noise by a small deviation in every block, and the
# port's f32 layer4 then reads 2.5e-3 of its max, bf16 0.5). One block:
# f32 summation order through its BatchNorms (read up to 3.4e-6 of the
# max), bf16 its conv outputs rounded in different places (read up to
# 6.7e-3); the running statistics are means and variances of those (read
# up to 5.0e-6 and 6.3e-4 absolute).
BLOCK_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
STATS_TOL = {"float32": 5e-5, "bfloat16": 5e-3}
# int8 in training mode, every code held to JAX's: f32 summation order
# (read up to 1.2e-6 of a level's max, 4.8e-7 absolute in the running
# statistics)
INT8_TRAIN_TOL = 1e-5


def jax_variables(model, *shapes, seed=0, **kwargs):
    """Variables of ``model`` for inputs of ``shapes`` without running its
    init: kernels N(0, 1 / fan_in), then `randomize`'s BatchNorm."""
    tree = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           *[jnp.zeros(s) for s in shapes], **kwargs))
    rng = np.random.default_rng(seed)

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                out[k] = (rng.standard_normal(v.shape, np.float32)
                          / np.float32(np.sqrt(fan_in)))
            else:
                out[k] = np.full(v.shape, 1.0 if k in ("scale", "var")
                                 else 0.0, np.float32)
        return out

    return randomize({col: fill(t) for col, t in tree.items()}, seed)


def _rel(got, ref):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _image(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _encoder(v, name, **kwargs):
    enc = ResNetEncoder(name, **kwargs)
    enc.load_state_dict(resnet_state_dict(v, name), strict=True)
    return enc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["resnet50", "resnet101"])
def test_bottleneck_encoder_matches_jax(name, dtype):
    x = _image(0, 2, 64, 64, 3)
    model = JaxEncoder(name)
    v = jax_variables(model, (1, 64, 64, 3))
    ref = model.apply(v, jnp.asarray(x, getattr(jnp, dtype)), train=False)
    enc = _encoder(v, name).eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert [tuple(g.shape[1:]) for g in got] == [
        (64, 64, 3), (32, 32, 64), (16, 16, 256), (8, 8, 512), (4, 4, 1024),
        (2, 2, 2048)]
    for level, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == getattr(torch, dtype)
        assert _rel(g, r) <= EVAL_TOL[dtype], level


def _running(state):
    return {k: v for k, v in state.items() if "running" in k}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["resnet50", "resnet101"])
def test_bottleneck_encoder_trains_like_jax(name, dtype):
    """Training mode, per-view batch statistics (bn_views 2): the stem on
    the trunk's run, then every block on JAX's output of the block
    before, with its running statistics."""
    x = _image(1, 4, 64, 64, 3)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    model = JaxEncoder(name, bn_views=2)
    v = jax_variables(model, (1, 64, 64, 3), seed=1)
    ref, upd = model.apply(v, jnp.asarray(x, jdt), train=True,
                           mutable=["batch_stats"])
    want = resnet_state_dict({"params": v["params"],
                              "batch_stats": upd["batch_stats"]}, name)
    before = resnet_state_dict(v, name)
    enc = _encoder(v, name, bn_views=2).train()
    layer0 = enc(torch.from_numpy(x).to(tdt))[1]
    assert _rel(layer0, ref[1]) <= BLOCK_TOL[dtype]
    for key in ("bn1.running_mean", "bn1.running_var"):
        np.testing.assert_allclose(enc.state_dict()[key], want[key],
                                   atol=STATS_TOL[dtype], err_msg=key)
    enc = _encoder(v, name, bn_views=2).train()
    h = flax_nn.max_pool(ref[1], (3, 3), (2, 2), [(1, 1), (1, 1)])
    for li, depth in enumerate(RESNET_SPECS[name][1], start=1):
        for bi in range(depth):
            blk = f"layer{li}_{bi}"
            stride = 2 if (li > 1 and bi == 0) else 1
            out, new = JaxBottleneck(
                (64, 128, 256, 512)[li - 1], stride, bi == 0,
                bn_views=2).apply({"params": v["params"][blk],
                                   "batch_stats": v["batch_stats"][blk]},
                                  h, train=True, mutable=["batch_stats"])
            got = getattr(enc, f"layer{li}")[bi](
                torch.from_numpy(np.array(h, np.float32)).to(tdt))
            assert _rel(got, out) <= BLOCK_TOL[dtype], blk
            mine = _running(getattr(enc, f"layer{li}")[bi].state_dict())
            for key, value in mine.items():
                np.testing.assert_allclose(value, _jax_running(
                                               new["batch_stats"], key),
                                           atol=STATS_TOL[dtype],
                                           err_msg=f"{blk}.{key}")
                assert not torch.equal(value, before[
                    f"layer{li}.{bi}.{key}"]), f"{blk}.{key}"
            h = out


def _jax_running(stats, key):
    """A block's JAX running statistic by the port's key (``bn2.
    running_var``, ``downsample.1.running_mean``)."""
    module, leaf = key.rsplit(".", 1)
    module = module.replace("downsample.1", "downsample_1")
    return np.asarray(stats[module][{"running_mean": "mean",
                                     "running_var": "var"}[leaf]],
                      np.float32)


def test_int8_bottleneck_matches_jax(monkeypatch):
    """QConv (dynamic scales: 128+ input channels quantized, 64-127 in
    float) then eval BatchNorm, unfolded, as JAX's Bottleneck; every int8
    code array held to JAX's (`CodeTape`), so the levels agree to float
    rounding."""
    x = _image(2, 2, 32, 32, 3)
    model = JaxEncoder("resnet50", quant=True)
    v = jax_variables(model, (1, 32, 32, 3), seed=2)
    tape = CodeTape(monkeypatch)
    ref = model.apply(v, jnp.asarray(x), train=False)
    enc = _encoder(v, "resnet50", quant=True).eval()
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    tape.check_all_used()
    for level, (g, r) in enumerate(zip(got, ref)):
        assert _rel(g, r) <= EVAL_TOL["float32"], level


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_int8_training_mode_matches_jax(monkeypatch, name):
    """With quant in training mode JAX runs the unfolded QConv + batch
    statistics BatchNorm (`egotap_tpu/models/resnet.py:72-90`), also for
    the basic blocks it folds in eval mode, and updates the running
    statistics; the port did eval-mode folded blocks."""
    x = _image(3, 4, 32, 32, 3)
    model = JaxEncoder(name, quant=True, bn_views=2)
    v = jax_variables(model, (1, 32, 32, 3), seed=3)
    tape = CodeTape(monkeypatch)
    ref, upd = model.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    enc = _encoder(v, name, quant=True, bn_views=2).train()
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    tape.check_all_used()
    for level, (g, r) in enumerate(zip(got, ref)):
        assert _rel(g, r) <= INT8_TRAIN_TOL, level
    want = resnet_state_dict({"params": v["params"],
                              "batch_stats": upd["batch_stats"]}, name)
    for key, value in enc.state_dict().items():
        if "running" in key:
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       atol=INT8_TRAIN_TOL, err_msg=key)


class _Launches:
    """Stands in for kernel D's wrapper inside `models.resnet`: counts the
    calls and computes the plain version."""

    def __init__(self, monkeypatch):
        self.count = 0
        real = resnet.fused_layer1_int8

        def launch(*args):
            self.count += 1
            return real(*args)

        monkeypatch.setattr(resnet, "fused_layer1_int8", launch)


@pytest.mark.parametrize("name,train,launches", [
    ("resnet18", False, 1),          # JAX's gate: the one case it fuses
    ("resnet18", True, 0),           # training mode
    ("resnet50", False, 0),          # Bottleneck layer1: 64 input channels
])
def test_fused_layer1_gate(monkeypatch, name, train, launches):
    """Kernel D runs only where JAX fuses layer1 (`resnet.py:318-320`:
    quant, fused_layer1, not train, basic blocks, one group)."""
    calls = _Launches(monkeypatch)
    enc = ResNetEncoder(name, quant=True, fused_layer1=True).train(train)
    with torch.no_grad():
        pyramid = enc(torch.randn(2, 32, 32, 3))
    assert calls.count == launches
    assert pyramid[2].shape[-1] == 64 * resnet.feature_expansion(name)


def test_s2d_stem_matches_jax():
    """JAX's S2DStemConv and the plain stem: the same stored weight."""
    x = _image(4, 2, 64, 64, 3)
    model = JaxS2DStem(64, 3)
    v = jax_variables(model, (1, 64, 64, 3), seed=4)
    ref = model.apply(v, jnp.asarray(x))
    stem = S2DStemConv(3, 64)
    stem.load_state_dict({"weight": torch.from_numpy(
        np.asarray(v["params"]["kernel"]).transpose(3, 2, 0, 1).copy())})
    plain = torch.nn.Conv2d(3, 64, 7, 2, 3, bias=False)
    plain.load_state_dict(stem.state_dict())
    with torch.no_grad():
        got = stem(torch.from_numpy(x))
        want = plain(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1)
    assert _rel(got, ref) <= EVAL_TOL["float32"]
    assert _rel(got, want.numpy()) <= EVAL_TOL["float32"]


def test_s2d_stem_encoder_matches_jax():
    x = _image(5, 2, 64, 64, 3)
    model = JaxEncoder("resnet18", stem_s2d=True)
    v = jax_variables(model, (1, 64, 64, 3), seed=5)
    ref = model.apply(v, jnp.asarray(x), train=False)
    enc = _encoder(v, "resnet18", stem_s2d=True).eval()
    assert isinstance(enc.conv1, S2DStemConv)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    for level, (g, r) in enumerate(zip(got, ref)):
        assert _rel(g, r) <= EVAL_TOL["float32"], level


def test_mono_resnet50_heatmap_net_matches_jax():
    """views 1: fs = 4, the decoder at 4x resnet18's widths with the
    258 * fs skip (about 121M parameters); the bridge's keys and bits
    equal the JAX exporter's."""
    maps, image = 15, 64
    x = _image(6, 2, 1, image, image, 3)
    model = JaxHeatmapUNet(num_output_maps=maps, model_name="resnet50",
                           views=1)
    v = jax_variables(model, (1, 1, image, image, 3), seed=6)
    ref = np.asarray(model.apply(v, jnp.asarray(x), train=False))
    want = export_heatmap_net(v, "resnet50")
    keys = list(want)
    picked = {k: want[k] for k in (
        "after_backbone.layer3_1x1.0.weight",
        "backbone.backbone.backbone.layer4.2.conv3.weight",
        "backbone.backbone.layer1.1.0.bn3.running_var")}
    del want                         # one copy of the weights at a time
    sd = heatmap_net_state_dict(v, "resnet50")
    assert list(sd) == keys
    for key, value in picked.items():
        np.testing.assert_array_equal(sd[key].numpy(), value)
    assert sd["after_backbone.layer3_1x1.0.weight"].shape == (
        258 * 4, 256 * 4, 1, 1)
    net = HeatmapUNet(maps, "resnet50", views=1).eval()
    net.load_state_dict(sd, strict=True)
    del sd
    assert 115e6 < sum(p.numel() for p in net.parameters()) < 125e6
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, image // 4, image // 4, maps)
    assert _rel(got, ref) <= EVAL_TOL["float32"]


def test_imagenet_backbone_strict_load(tmp_path):
    """A torchvision resnet50 state_dict (the reference exporter's trunk
    keys, written by the test) strict-loads into the trunk."""
    v = jax_variables(JaxEncoder("resnet50"), (1, 32, 32, 3), seed=7)
    w = _TorchWriter({"params": {"backbone": v["params"]},
                      "batch_stats": {"backbone": v["batch_stats"]}})
    _export_resnet(w, "backbone", "", "resnet50")
    tv = {k: torch.from_numpy(np.array(a)) for k, a in w.out.items()}
    tv["fc.weight"] = torch.randn(1000, 2048)        # torchvision's head
    tv["fc.bias"] = torch.randn(1000)
    torch.save(tv, tmp_path / "resnet50.pth")
    net = HeatmapUNet(15, "resnet50")
    load_imagenet_backbone(net, str(tmp_path / "resnet50.pth"))
    trunk = net.backbone.backbone.backbone.state_dict()
    assert sorted(trunk) == sorted(tv)
    for k in ("layer3.5.bn2.running_mean", "layer1.0.downsample.0.weight"):
        assert torch.equal(trunk[k], tv[k])
