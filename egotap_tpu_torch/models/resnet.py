"""ResNet feature-pyramid encoder (NHWC) with the torchvision layer split.

Counterpart of `egotap_tpu/models/resnet.py`. The reference re-slices a
torchvision ResNet into a 5-level pyramid (model/net_architecture.py:
53-85), with expansion e = 1 (resnet18/34, `BasicBlock`) or 4
(resnet50/101, `Bottleneck`):
    layer0: conv1+bn1+relu     -> (H/2,  64)
    layer1: maxpool + layer1   -> (H/4,  64 * e)
    layer2..layer4             -> (H/8, 128 * e), (H/16, 256 * e),
                                  (H/32, 512 * e)

Submodule names are torchvision's (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv1``, ``bn3``, ``downsample.0`` ...), so the
state_dict keys are the reference's and a torchvision ``.pth``
strict-loads. Convolutions and max-pooling stay PyTorch / cuDNN calls,
as the JAX package leaves them to XLA.

``groups`` G > 1 builds G weight-independent trunks as one grouped net
(input channels 3G, every width times G: the fused nets of
`heatmap_net.FusedHeatmapUNet`). ``stem_s2d``: the stem as
`S2DStemConv`, the same stored weight computed by space-to-depth.

int8 (``quant``, `egotap_tpu/models/resnet.py`):
  * in eval mode a `BasicBlock` folds BatchNorm into its convs and runs
    each as `quantized_conv` on the folded f32 weights, except a conv
    with fewer than 128 input channels and no static scale, which stays
    a float conv in the compute dtype (`BasicBlock._folded_inference`);
  * a `Bottleneck`, and a `BasicBlock` in training mode, run each conv
    as a `QConv` (quantized as above, unfolded) followed by BatchNorm
    (`egotap_tpu/models/resnet.py:72-90`, `:127-150`);
  * the 3-channel stem is always a float conv;
  * ``fused_layer1`` runs the whole of layer1 as kernel D
    (`ops/fused_layer1.py`, per-image scales) in eval mode, for a
    basic-block net of one group, as JAX gates it (`resnet.py:318-320`).

Training mode: BatchNorm takes batch statistics, per view with
``bn_views`` V (row i of the folded batch is view i % V,
`models/layers.py:batch_norm_train`), also with ``quant``.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from egotap_tpu_torch.models.layers import BN_EPS, batch_norm, conv_nhwc
from egotap_tpu_torch.ops.fused_layer1 import (fold_bn, fused_layer1_int8,
                                               pack_blocks)
from egotap_tpu_torch.ops.quant import (QConv, WeightCache, conv_nhwc_float,
                                        quantize_weights, quantized_conv)
from egotap_tpu_torch.utils import profiling

RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


def feature_expansion(model_name: str) -> int:
    kind, _ = RESNET_SPECS[model_name]
    return 1 if kind == "basic" else 4


class _QConvParams(QConv):
    """A `QConv` (same keys) whose eval-mode int8 form its `BasicBlock`
    computes BN-folded: `BasicBlock.prequantize` caches the folded bias
    and int8 weights here. Its own forward runs in training mode only,
    on the unfolded weights (JAX `_QConvParams` / `QConv`)."""

    cached = ("w_q", "w_scale", "folded_bias")

    def prequantize(self) -> None:
        """Nothing: the block fills the cache with folded weights."""


def _conv(cin: int, cout: int, kernel: int, stride: int, groups: int = 1,
          quant=None) -> nn.Conv2d:
    """A bias-free conv: ``quant`` is None (float) or the int8 class."""
    if quant is None:
        return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False,
                         groups=groups)
    if groups > 1:
        raise NotImplementedError("int8 grouped convs: no model has one")
    return quant(cin, cout, kernel, stride, kernel // 2, bias=False)


def _apply(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` on NHWC x: a `QConv` runs itself, a float conv in x's
    dtype."""
    return conv(x) if isinstance(conv, QConv) else conv_nhwc(x, conv)


class _Block(nn.Module):
    """What both block kinds share: the downsample branch, the train- or
    eval-mode BatchNorm over ``bn_views``, the residual."""

    expansion = 1

    def _downsample(self, cin: int, cout: int, stride: int, groups: int,
                    quant) -> None:
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                _conv(cin, cout, 1, stride, groups, quant),
                nn.BatchNorm2d(cout, eps=BN_EPS))

    def _bn(self, y: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
        return batch_norm(y, bn, self.training, self.bn_views)

    def _unit(self, x: torch.Tensor, conv: nn.Conv2d,
              bn: nn.BatchNorm2d) -> torch.Tensor:
        return self._bn(_apply(x, conv), bn)

    def _residual(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        identity = x
        if self.downsample is not None:
            identity = self._unit(x, *self.downsample)
        return torch.relu(out + identity)


class BasicBlock(_Block):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 quant: bool = False, bn_views: int = 1, groups: int = 1):
        super().__init__()
        self.quant = quant
        self.bn_views = bn_views
        q = _QConvParams if quant else None
        self.conv1 = _conv(cin, features, 3, stride, groups, q)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv2 = _conv(features, features, 3, 1, groups, q)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)
        self._downsample(cin, features, stride, groups, q)

    def _pairs(self):
        pairs = [(self.conv1, self.bn1), (self.conv2, self.bn2)]
        if self.downsample is not None:
            pairs.append((self.downsample[0], self.downsample[1]))
        return pairs

    @torch.no_grad()
    def prequantize(self) -> None:
        """Fold BN and quantize the folded weights once (the JAX path does
        both inline on every call, with the same result)."""
        if self.quant:
            for conv, bn in self._pairs():
                w, conv.folded_bias = _fold(conv, bn)
                conv.w_q, conv.w_scale = quantize_weights(w)

    def _folded_conv(self, inp: torch.Tensor, conv: _QConvParams,
                     bn: nn.BatchNorm2d) -> torch.Tensor:
        a_scale = conv.calib_or_static(inp)
        stride, pad = conv.stride[0], conv.padding[0]
        if a_scale is None and inp.shape[-1] < 128:
            profiling.count("int8.float_convs")
            w, c = _fold(conv, bn)
            out = conv_nhwc_float(inp, w.to(inp.dtype), stride, pad)
            return out + c.to(out.dtype)
        if conv.w_q is None:
            self.prequantize()
        return quantized_conv(inp, conv.w_q, conv.w_scale, stride, pad,
                              conv.folded_bias, a_scale)

    def _folded_inference(self, x: torch.Tensor) -> torch.Tensor:
        """BN-folded int8 block (JAX `BasicBlock._folded_inference`)."""
        out = torch.relu(self._folded_conv(x, self.conv1, self.bn1))
        out = self._folded_conv(out, self.conv2, self.bn2)
        identity = x
        if self.downsample is not None:
            identity = self._folded_conv(x, *self.downsample)
        return torch.relu(out + identity.to(out.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant and not self.training:
            return self._folded_inference(x)
        out = torch.relu(self._unit(x, self.conv1, self.bn1))
        return self._residual(x, self._unit(out, self.conv2, self.bn2))


class Bottleneck(_Block):
    """torchvision's Bottleneck (v1.5: the stride on the 3x3 conv), widths
    ``features`` -> ``features`` -> 4 ``features``; int8 as `QConv` +
    BatchNorm, unfolded (JAX `Bottleneck`)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 quant: bool = False, bn_views: int = 1, groups: int = 1):
        super().__init__()
        self.bn_views = bn_views
        q = QConv if quant else None
        out = features * self.expansion
        self.conv1 = _conv(cin, features, 1, 1, groups, q)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv2 = _conv(features, features, 3, stride, groups, q)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv3 = _conv(features, out, 1, 1, groups, q)
        self.bn3 = nn.BatchNorm2d(out, eps=BN_EPS)
        self._downsample(cin, out, stride, groups, q)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self._unit(x, self.conv1, self.bn1))
        out = torch.relu(self._unit(out, self.conv2, self.bn2))
        return self._residual(x, self._unit(out, self.conv3, self.bn3))


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    return fold_bn(conv.weight, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var, BN_EPS)


def max_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max-pool with 1-pixel -inf padding, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class S2DStemConv(nn.Conv2d):
    """The 7x7 stride-2 stem computed by space-to-depth (JAX
    `S2DStemConv`): x rearranged to (H/2, W/2, 4C) phases and the stored
    (F, C, 7, 7) weight re-indexed into an equivalent (F, 4C, 4, 4) one,
    ``K4[f, (du*2+dv)*C + c, ai, aj] = W[f, c, 2ai+du-1, 2aj+dv-1]``
    (zero out of range), padding ((2, 1), (2, 1)). Every product pairs
    the same pixel with the same tap, summed in another order. The
    parameter is nn.Conv2d's ``weight`` (same key as the plain stem). An
    odd height or width runs the plain conv."""

    def __init__(self, in_channels: int = 3, features: int = 64):
        super().__init__(in_channels, features, 7, 2, 3, bias=False)

    def s2d_weight(self) -> torch.Tensor:
        f, c = self.weight.shape[:2]
        w = F.pad(self.weight, (1, 0, 1, 0))            # tap i at row i + 1
        w = w.reshape(f, c, 4, 2, 4, 2)                 # (f, c, ai, du, aj, dv)
        return w.permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC x -> NHWC output, in x's dtype."""
        if x.shape[1] % 2 or x.shape[2] % 2:
            return conv_nhwc(x, self)
        y = torch.cat([x[:, du::2, dv::2] for du in range(2)
                       for dv in range(2)], dim=-1)     # (B, H/2, W/2, 4C)
        y = F.pad(y.permute(0, 3, 1, 2), (2, 1, 2, 1))
        out = F.conv2d(y, self.s2d_weight().to(x.dtype))
        return out.permute(0, 2, 3, 1)


class ResNetEncoder(WeightCache, nn.Module):
    """Returns [input, layer0, layer1, layer2, layer3, layer4] like the
    reference's Encoder_Block.forward (net_architecture.py:75-85).

    quant: int8 blocks; fused_layer1 (with quant): layer1 as kernel D in
    eval mode, with the same parameters; bn_views: the views interleaved
    in the batch, for per-view training statistics; groups: G fused
    trunks; stem_s2d: the space-to-depth stem."""

    cached = ("layer1_wq", "layer1_ws", "layer1_bias")

    def __init__(self, model_name: str = "resnet18", quant: bool = False,
                 fused_layer1: bool = False, bn_views: int = 1,
                 groups: int = 1, stem_s2d: bool = False):
        super().__init__()
        self.quant = quant
        self.bn_views = bn_views
        self.fused_layer1 = fused_layer1
        self._init_cache()
        kind, depths = RESNET_SPECS[model_name]
        self.kind, self.groups = kind, groups
        block = BasicBlock if kind == "basic" else Bottleneck
        g = groups
        if quant and g > 1:
            raise NotImplementedError("int8 grouped convs: no model has one")
        self.conv1 = (S2DStemConv(3, 64) if stem_s2d and g == 1 else
                      nn.Conv2d(3 * g, 64 * g, 7, 2, 3, bias=False, groups=g))
        self.bn1 = nn.BatchNorm2d(64 * g, eps=BN_EPS)
        cin = 64 * g
        for li, (width, depth) in enumerate(zip((64, 128, 256, 512), depths),
                                            start=1):
            blocks = []
            for bi in range(depth):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(block(cin, width * g, stride, quant, bn_views,
                                    g))
                cin = width * g * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        # torchvision's classification head: in the checkpoints, never run
        # (a grouped trunk has no checkpoint)
        if g == 1:
            self.fc = nn.Linear(512 * block.expansion, 1000)

    def prequantize(self) -> None:
        if self.quant and self.fused_layer1 and self.kind == "basic":
            self.layer1_wq, self.layer1_ws, self.layer1_bias = pack_blocks(
                self.layer1, BN_EPS)

    def _fused_layer1(self, x: torch.Tensor) -> torch.Tensor:
        """Kernel D on layer1's folded, per-image-quantized blocks (JAX
        `ResNetEncoder`, resnet.py:318-337). On the card it raises when
        grad mode is on and x requires grad (the kernel has no
        backward): run the encoder under ``torch.no_grad()``."""
        if self.layer1_wq is None:
            self.prequantize()
        return fused_layer1_int8(x.contiguous(), self.layer1_wq,
                                 self.layer1_ws, self.layer1_bias)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.conv1, S2DStemConv):
            return self.conv1(x)
        return conv_nhwc(x, self.conv1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        layer0 = torch.relu(batch_norm(self._stem(x), self.bn1,
                                       self.training, self.bn_views))
        out = max_pool_nhwc(layer0)
        feats = []
        for li in range(1, 5):
            if (li == 1 and self.quant and self.fused_layer1
                    and not self.training and self.kind == "basic"
                    and self.groups == 1 and out.shape[-1] == 64):
                out = self._fused_layer1(out)
            else:
                out = getattr(self, f"layer{li}")(out)
            feats.append(out)
        return [x, layer0, *feats]
