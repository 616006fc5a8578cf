"""Reference-parity weight initialization.

Counterpart of `egotap_tpu/models/initializers.py:apply_reference_init`.
The reference re-initializes networks after construction
(model/network_utils.py:37-58, 69-82):
  * Conv/Linear weights: kaiming normal, fan_in, a=0; biases zero. This
    covers everything with a Conv/Linear child, the Grid-ViT and the PU
    cells included.
  * BatchNorm2d: weight ~ U[0.02, 1.0], bias 0. BatchNorm1d is not
    matched by the reference's classname check and keeps torch's
    defaults (weight 1, bias 0).
  * With --init_ImageNet the stage-1 ResNet trunk keeps its own weights
    and only the decoder is re-initialized (network_utils.py:76-80):
    ``skip_prefixes``. `load_imagenet_backbone` puts a torchvision
    resnet ``.pth`` into the trunk.
Every draw comes from the ``generator`` passed in.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


@torch.no_grad()
def apply_reference_init(module: nn.Module, generator: torch.Generator,
                         skip_prefixes: Sequence[str] = ()) -> nn.Module:
    """Re-draw conv and linear weights (kaiming normal, fan_in), zero
    their biases, and draw BatchNorm2d weights from U[0.02, 1] with zero
    biases, in place, in module order. Submodules whose name is one of
    ``skip_prefixes`` or lies under one (``"backbone"`` covers
    ``backbone.backbone.backbone.conv1``) are left as they are. Returns
    ``module``."""
    for name, m in module.named_modules():
        if any(name == p or name.startswith(p + ".") for p in skip_prefixes):
            continue
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * math.sqrt(2.0 / fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(torch.empty(m.weight.shape).uniform_(
                0.02, 1.0, generator=generator))
            m.bias.zero_()
    return module


def load_imagenet_backbone(net: nn.Module, pth_path: str) -> nn.Module:
    """Load a torchvision resnet state_dict (``.pth``, e.g.
    resnet18-f37072fd.pth) into a `HeatmapUNet`'s trunk, running
    statistics included (`egotap_tpu/models/initializers.py:
    load_imagenet_backbone`). The trunk has torchvision's names, so the
    keys load as they are (strict). Returns ``net``."""
    state = torch.load(pth_path, map_location="cpu", weights_only=True)
    net.backbone.backbone.backbone.load_state_dict(state, strict=True)
    return net
