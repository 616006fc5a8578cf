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
calls, as the JAX package leaves them to XLA. Bottleneck nets
(resnet50/101), the space-to-depth stem and the int8 paths are not
ported yet.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from egotap_tpu_torch.models.layers import BN_EPS, batch_norm_eval, conv_nhwc

RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


def feature_expansion(model_name: str) -> int:
    kind, _ = RESNET_SPECS[model_name]
    return 1 if kind == "basic" else 4


def _conv(cin: int, cout: int, kernel: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.conv2 = _conv(features, features, 3, 1)
        self.bn2 = nn.BatchNorm2d(features, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or cin != features:
            self.downsample = nn.Sequential(
                _conv(cin, features, 1, stride),
                nn.BatchNorm2d(features, eps=BN_EPS))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(batch_norm_eval(conv_nhwc(x, self.conv1), self.bn1))
        out = batch_norm_eval(conv_nhwc(out, self.conv2), self.bn2)
        identity = x
        if self.downsample is not None:
            identity = batch_norm_eval(conv_nhwc(x, self.downsample[0]),
                                       self.downsample[1])
        return torch.relu(out + identity)


def max_pool_nhwc(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 max-pool with 1-pixel -inf padding, NHWC."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)


class ResNetEncoder(nn.Module):
    """Returns [input, layer0, layer1, layer2, layer3, layer4] like the
    reference's Encoder_Block.forward (net_architecture.py:75-85)."""

    def __init__(self, model_name: str = "resnet18"):
        super().__init__()
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
                blocks.append(BasicBlock(cin, width, stride))
                cin = width
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        # torchvision's classification head: in the checkpoints, never run
        self.fc = nn.Linear(512, 1000)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        layer0 = torch.relu(batch_norm_eval(conv_nhwc(x, self.conv1),
                                            self.bn1))
        out = max_pool_nhwc(layer0)
        feats = []
        for li in range(1, 5):
            out = getattr(self, f"layer{li}")(out)
            feats.append(out)
        return [x, layer0, *feats]
