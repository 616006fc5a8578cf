"""ResNet feature-pyramid encoder (NHWC) with the torchvision layer split.

Counterpart of `egotap_tpu/models/resnet.py` for the basic-block nets
(resnet18, resnet34). The reference re-slices a torchvision ResNet into a
5-level pyramid (model/net_architecture.py:53-85):
    layer0: conv1+bn1+relu     -> (H/2,  64)
    layer1: maxpool + layer1   -> (H/4,  64)
    layer2..layer4             -> (H/8, 128), (H/16, 256), (H/32, 512)

Submodule names are torchvision's (``conv1``, ``bn1``,
``layer{1..4}.{i}.conv1``, ``downsample.0`` ...), so the state_dict keys
are the reference's. Convolutions and max-pooling stay PyTorch / cuDNN
calls, as the JAX package leaves them to XLA.

int8 inference (``quant``, `egotap_tpu/models/resnet.py`): every block
folds BatchNorm into its convs and runs each as `quantized_conv` on the
folded f32 weights, except a conv with fewer than 128 input channels and
no static scale, which stays a float conv in the compute dtype
(`BasicBlock._folded_inference`); the 3-channel stem always does.
``fused_layer1`` runs the whole of layer1 as kernel D
(`ops/fused_layer1.py`, per-image scales). Bottleneck nets (resnet50/101)
and the space-to-depth stem are not ported.

Training mode (the frozen stage-1 nets of the stage-2 training step):
BatchNorm takes batch statistics, per view with ``bn_views`` V (row i of
the folded batch is view i % V, `models/layers.py:batch_norm_train`).
The int8 encoder is inference-only and ignores the flag, as in JAX
(`egotap_tpu/models/resnet.py:76`).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from egotap_tpu_torch.models.layers import BN_EPS, batch_norm, conv_nhwc
from egotap_tpu_torch.ops.fused_layer1 import (fold_bn, fused_layer1_int8,
                                               pack_blocks)
from egotap_tpu_torch.ops.quant import (Calibrated, WeightCache,
                                        conv_nhwc_float, quantize_weights,
                                        quantized_conv)

RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


def feature_expansion(model_name: str) -> int:
    kind, _ = RESNET_SPECS[model_name]
    return 1 if kind == "basic" else 4


class _QConvParams(WeightCache, Calibrated, nn.Conv2d):
    """An nn.Conv2d (same keys) whose BN-folded int8 form the block
    computes, with the calibration plumbing at the conv's path (JAX
    `_QConvParams`); `BasicBlock.prequantize` caches the folded bias and
    int8 weights here."""

    cached = ("w_q", "w_scale", "folded_bias")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._init_calibration()
        self._init_cache()


def _conv(cin: int, cout: int, kernel: int, stride: int,
          quant: bool = False) -> nn.Conv2d:
    conv = _QConvParams if quant else nn.Conv2d
    return conv(cin, cout, kernel, stride, kernel // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 quant: bool = False, bn_views: int = 1):
        super().__init__()
        self.quant = quant
        self.bn_views = bn_views
        self.conv1 = _conv(cin, features, 3, stride, quant)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv2 = _conv(features, features, 3, 1, quant)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(
                _conv(cin, features, 1, stride, quant),
                nn.BatchNorm2d(features, eps=BN_EPS))

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
        if self.quant:
            return self._folded_inference(x)

        def bn(y, mod):
            return batch_norm(y, mod, self.training, self.bn_views)
        out = torch.relu(bn(conv_nhwc(x, self.conv1), self.bn1))
        out = bn(conv_nhwc(out, self.conv2), self.bn2)
        identity = x
        if self.downsample is not None:
            identity = bn(conv_nhwc(x, self.downsample[0]), self.downsample[1])
        return torch.relu(out + identity)


def _fold(conv: nn.Conv2d, bn: nn.BatchNorm2d):
    return fold_bn(conv.weight, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var, BN_EPS)


def max_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max-pool with 1-pixel -inf padding, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class ResNetEncoder(WeightCache, nn.Module):
    """Returns [input, layer0, layer1, layer2, layer3, layer4] like the
    reference's Encoder_Block.forward (net_architecture.py:75-85).

    quant: int8 inference blocks; fused_layer1 (with quant): layer1 as
    kernel D, with the same parameters; bn_views: the views interleaved
    in the batch, for per-view training statistics."""

    cached = ("layer1_wq", "layer1_ws", "layer1_bias")

    def __init__(self, model_name: str = "resnet18", quant: bool = False,
                 fused_layer1: bool = False, bn_views: int = 1):
        super().__init__()
        self.quant = quant
        self.bn_views = bn_views
        self.fused_layer1 = fused_layer1
        self._init_cache()
        kind, depths = RESNET_SPECS[model_name]
        if kind != "basic":
            raise NotImplementedError(
                f"{model_name}: Bottleneck ResNets are not ported yet")
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        cin = 64
        for li, (width, depth) in enumerate(zip((64, 128, 256, 512), depths),
                                            start=1):
            blocks = []
            for bi in range(depth):
                stride = 2 if (li > 1 and bi == 0) else 1
                blocks.append(BasicBlock(cin, width, stride, quant, bn_views))
                cin = width
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        # torchvision's classification head: in the checkpoints, never run
        self.fc = nn.Linear(512, 1000)

    def prequantize(self) -> None:
        if self.quant and self.fused_layer1:
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

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        layer0 = torch.relu(batch_norm(
            conv_nhwc(x, self.conv1), self.bn1,
            self.training and not self.quant, self.bn_views))
        out = max_pool_nhwc(layer0)
        feats = []
        for li in range(1, 5):
            if (li == 1 and self.quant and self.fused_layer1
                    and out.shape[-1] == 64):
                out = self._fused_layer1(out)
            else:
                out = getattr(self, f"layer{li}")(out)
            feats.append(out)
        return [x, layer0, *feats]
