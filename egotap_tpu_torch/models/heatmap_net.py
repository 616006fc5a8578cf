"""Stage-1 stereo heatmap estimator: shared ResNet encoder + UNet decoder.

Counterpart of `egotap_tpu/models/heatmap_net.py` (`HeatmapUNet`,
`FusedHeatmapUNet`, `fuse_heatmap_variables`, `split_views`).
`HeatmapUNet` is the reference's ``HeatMap_UnrealEgo_Shared``
(model/net_architecture.py:25-173):
  * both views are folded into the batch for one encoder pass;
  * the decoder concatenates the two views' pyramids channel-wise
    (view-major) at every scale, then runs 3 x (bilinear-up x2
    [align_corners, kernel A] -> 1x1 skip conv -> concat -> 3x3 conv) and
    a final 1x1 conv to ``num_output_maps * views`` channels;
  * every width follows ``feature_expansion(model_name) * views`` (fs):
    the layer3 skip conv's odd 258 * fs channels are kept;
  * ``quant``: int8 inference convs throughout (`ops/quant.py`, the JAX
    ``quant`` field), the final 1x1 conv a `QConv` with a bias;
  * training mode: the encoder's BatchNorm takes per-view batch
    statistics (``bn_views = views``: the fold puts view v of sample b at
    row b*V + v, `egotap_tpu/models/heatmap_net.py:64-68`).

Layout: NHWC. Keys follow the reference checkpoint: the ResNet under
``backbone.backbone.backbone.*``, re-registered (same tensors) under
``backbone.backbone.layer{0..4}.*`` as the reference's Encoder_Block does,
and the decoder under ``after_backbone.*``.

`FusedHeatmapUNet` runs several weight-independent HeatmapUNets (pos and
rot) as one grouped net on the same input, with JAX's module names
(``backbone``, ``layer4_1x1`` ..., ``conv_heatmap_g{g}``); it has no
reference counterpart. `fuse_heatmap_variables` builds its state_dict
from the separate nets'.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence

import torch
from torch import nn

from egotap_tpu_torch.models.layers import ConvReLU, conv_nhwc
from egotap_tpu_torch.models.resnet import ResNetEncoder, feature_expansion
from egotap_tpu_torch.ops.quant import QConv
from egotap_tpu_torch.ops.upsample import upsample2x_align_corners


def _merge_views(feat: torch.Tensor, batch: int, views: int) -> torch.Tensor:
    """(B*V, h, w, c) -> (B, h, w, V*c), view-major channel order."""
    _, h, w, c = feat.shape
    feat = feat.reshape(batch, views, h, w, c).permute(0, 2, 3, 1, 4)
    return feat.reshape(batch, h, w, views * c)


class _EncoderBlock(nn.Module):
    """The reference's Encoder_Block registrations (net_architecture.py:
    53-73): the trunk as ``backbone`` plus aliases of its stages."""

    def __init__(self, model_name: str, quant: bool, views: int):
        super().__init__()
        trunk = ResNetEncoder(model_name, quant, bn_views=views)
        self.backbone = trunk
        self.layer0 = nn.Sequential(trunk.conv1, trunk.bn1, nn.ReLU())
        self.layer1 = nn.Sequential(nn.MaxPool2d(3, 2, 1), trunk.layer1)
        self.layer2, self.layer3, self.layer4 = (trunk.layer2, trunk.layer3,
                                                 trunk.layer4)

    def forward(self, x: torch.Tensor):
        return self.backbone(x)


class _SharedBackbone(nn.Module):
    def __init__(self, model_name: str, quant: bool, views: int):
        super().__init__()
        self.backbone = _EncoderBlock(model_name, quant, views)

    def forward(self, x: torch.Tensor):
        return self.backbone(x)


class _Decoder(nn.Module):
    def __init__(self, num_output_maps: int, fs: int, views: int,
                 quant: bool):
        super().__init__()
        q = quant
        self.layer1_1x1 = ConvReLU(64 * fs, 64 * fs, 1, 0, q)
        self.layer2_1x1 = ConvReLU(128 * fs, 128 * fs, 1, 0, q)
        self.layer3_1x1 = ConvReLU(256 * fs, 258 * fs, 1, 0, q)
        self.layer4_1x1 = ConvReLU(512 * fs, 512 * fs, 1, 0, q)
        self.conv_up1 = ConvReLU(256 * fs + 64 * fs, 256 * fs, 3, 1, q)
        self.conv_up2 = ConvReLU(512 * fs + 128 * fs, 256 * fs, 3, 1, q)
        self.conv_up3 = ConvReLU(512 * fs + 258 * fs, 512 * fs, 3, 1, q)
        self.conv_heatmap = (QConv if q else nn.Conv2d)(
            256 * fs, num_output_maps * views, 1)

    def forward(self, layer1, layer2, layer3, layer4):
        x = upsample2x_align_corners(self.layer4_1x1(layer4))
        x = torch.cat([x, self.layer3_1x1(layer3)], dim=-1)
        x = self.conv_up3(x)

        x = upsample2x_align_corners(x)
        x = torch.cat([x, self.layer2_1x1(layer2)], dim=-1)
        x = self.conv_up2(x)

        x = upsample2x_align_corners(x)
        x = torch.cat([x, self.layer1_1x1(layer1)], dim=-1)
        x = self.conv_up1(x)
        if isinstance(self.conv_heatmap, QConv):
            return self.conv_heatmap(x)
        return conv_nhwc(x, self.conv_heatmap)


class HeatmapUNet(nn.Module):
    """Weight-shared stereo encoder + channel-concat UNet decoder.

    num_output_maps: per-view output channels; model_name: resnet18 |
    resnet34 | resnet50 | resnet101; views: 2 = stereo, 1 = mono;
    quant: int8 convs."""

    def __init__(self, num_output_maps: int, model_name: str = "resnet18",
                 views: int = 2, quant: bool = False):
        super().__init__()
        self.views = views
        fs = feature_expansion(model_name) * views
        self.backbone = _SharedBackbone(model_name, quant, views)
        self.after_backbone = _Decoder(num_output_maps, fs, views, quant)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, V, H, W, 3) -> heatmaps (B, H/4, W/4, maps*V)."""
        b, v = images.shape[0], images.shape[1]
        if v != self.views:
            raise ValueError(f"expected {self.views} views, got {v}")
        flat = images.reshape((b * v,) + tuple(images.shape[2:]))
        pyramid = self.backbone(flat)
        _, _, layer1, layer2, layer3, layer4 = [
            _merge_views(f, b, v) for f in pyramid]
        return self.after_backbone(layer1, layer2, layer3, layer4)


def _merge_views_grouped(feat: torch.Tensor, batch: int, views: int,
                         groups: int) -> torch.Tensor:
    """(B*V, h, w, G*c) -> (B, h, w, G*(V*c)): per group, view-major,
    group blocks contiguous for the next grouped conv."""
    _, h, w, gc = feat.shape
    c = gc // groups
    feat = feat.reshape(batch, views, h, w, groups, c)
    feat = feat.permute(0, 2, 3, 4, 1, 5)
    return feat.reshape(batch, h, w, groups * views * c)


def _concat_grouped(parts: Sequence[torch.Tensor], groups: int
                    ) -> torch.Tensor:
    """[A (..., G*a), B (..., G*b)] -> (..., G*(a+b)) with blocks
    [g0: a, b | g1: a, b | ...]."""
    shards = []
    for g in range(groups):
        for p in parts:
            c = p.shape[-1] // groups
            shards.append(p[..., g * c:(g + 1) * c])
    return torch.cat(shards, dim=-1)


class FusedHeatmapUNet(nn.Module):
    """len(out_maps) weight-independent HeatmapUNets of ``model_name`` as
    one grouped-conv pass on the same stereo input (JAX
    `FusedHeatmapUNet`, `egotap_tpu/models/heatmap_net.py:111-192`): the
    RGB replicated per group, a grouped trunk (its train-mode BatchNorm
    over the whole folded batch, as in JAX), grouped view merges, skip
    convs and concats, then one 1x1 head per net. Output channels:
    [net 0's maps * V | net 1's ...], the concatenated stack of the
    separate nets."""

    def __init__(self, out_maps: Sequence[int], model_name: str = "resnet18",
                 views: int = 2):
        super().__init__()
        self.out_maps, self.views = tuple(out_maps), views
        g = len(self.out_maps)
        fs = feature_expansion(model_name) * views
        self.backbone = ResNetEncoder(model_name, groups=g)
        self.layer1_1x1 = ConvReLU(64 * fs * g, 64 * fs * g, 1, 0, groups=g)
        self.layer2_1x1 = ConvReLU(128 * fs * g, 128 * fs * g, 1, 0, groups=g)
        self.layer3_1x1 = ConvReLU(256 * fs * g, 258 * fs * g, 1, 0, groups=g)
        self.layer4_1x1 = ConvReLU(512 * fs * g, 512 * fs * g, 1, 0, groups=g)
        self.conv_up1 = ConvReLU((256 + 64) * fs * g, 256 * fs * g, 3, 1,
                                 groups=g)
        self.conv_up2 = ConvReLU((512 + 128) * fs * g, 256 * fs * g, 3, 1,
                                 groups=g)
        self.conv_up3 = ConvReLU((512 + 258) * fs * g, 512 * fs * g, 3, 1,
                                 groups=g)
        for i, maps in enumerate(self.out_maps):
            setattr(self, f"conv_heatmap_g{i}",
                    nn.Conv2d(256 * fs, maps * views, 1))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, V, H, W, 3) -> (B, H/4, W/4, sum(out_maps) * V)."""
        b, v = images.shape[0], images.shape[1]
        g = len(self.out_maps)
        flat = images.reshape((b * v,) + tuple(images.shape[2:]))
        pyramid = self.backbone(torch.cat([flat] * g, dim=-1))
        layer1, layer2, layer3, layer4 = [
            _merge_views_grouped(f, b, v, g) for f in pyramid[2:]]
        x = upsample2x_align_corners(self.layer4_1x1(layer4))
        x = self.conv_up3(_concat_grouped([x, self.layer3_1x1(layer3)], g))
        x = upsample2x_align_corners(x)
        x = self.conv_up2(_concat_grouped([x, self.layer2_1x1(layer2)], g))
        x = upsample2x_align_corners(x)
        x = self.conv_up1(_concat_grouped([x, self.layer1_1x1(layer1)], g))
        per = x.shape[-1] // g
        return torch.cat([
            conv_nhwc(x[..., i * per:(i + 1) * per],
                      getattr(self, f"conv_heatmap_g{i}"))
            for i in range(g)], dim=-1)


def fuse_heatmap_variables(states: Sequence[Dict[str, torch.Tensor]]
                           ) -> "collections.OrderedDict[str, torch.Tensor]":
    """The state_dict of a `FusedHeatmapUNet` made of the given
    `HeatmapUNet` state_dicts (JAX `fuse_heatmap_variables`): conv
    weights and biases concatenated on the output axis (0 in PyTorch's
    layout), BatchNorm tensors on axis 0, each net's 1x1 head kept as
    ``conv_heatmap_g{i}``. The trunk comes from its canonical keys
    (``backbone.backbone.backbone.*``; the aliases and torchvision's
    ``fc`` are left out), ``num_batches_tracked`` from the first net."""
    canon, dec = "backbone.backbone.backbone.", "after_backbone."
    out = collections.OrderedDict()
    for key, value in states[0].items():
        if key.startswith(canon) and not key.startswith(canon + "fc."):
            name = "backbone." + key[len(canon):]
        elif (key.startswith(dec)
              and not key.startswith(dec + "conv_heatmap.")):
            name = key[len(dec):]
        else:
            continue
        parts = [sd[key] for sd in states]
        out[name] = parts[0] if value.dim() == 0 else torch.cat(parts)
    for i, sd in enumerate(states):
        for leaf in ("weight", "bias"):
            out[f"conv_heatmap_g{i}.{leaf}"] = sd[f"{dec}conv_heatmap.{leaf}"]
    return out


def split_views(heatmap_cat: torch.Tensor, views: int) -> List[torch.Tensor]:
    """The per-view channel blocks of a stack (JAX `split_views`, torch
    ``chunk`` along the channel axis, here the last)."""
    if heatmap_cat.shape[-1] % views:
        raise ValueError(f"{heatmap_cat.shape[-1]} channels do not split "
                         f"into {views} views")
    return list(heatmap_cat.chunk(views, dim=-1))
