"""Stage-1 stereo heatmap estimator: shared ResNet encoder + UNet decoder.

Counterpart of `egotap_tpu/models/heatmap_net.py:HeatmapUNet`
(reference ``HeatMap_UnrealEgo_Shared``, model/net_architecture.py:25-173):
  * both views are folded into the batch for one encoder pass;
  * the decoder concatenates the two views' pyramids channel-wise
    (view-major) at every scale, then runs 3 x (bilinear-up x2
    [align_corners, kernel A] -> 1x1 skip conv -> concat -> 3x3 conv) and
    a final 1x1 conv to ``num_output_maps * views`` channels;
  * the odd 258-channel width of the layer3 skip conv is kept.

Layout: NHWC. Keys follow the reference checkpoint: the ResNet under
``backbone.backbone.backbone.*``, re-registered (same tensors) under
``backbone.backbone.layer{0..4}.*`` as the reference's Encoder_Block does,
and the decoder under ``after_backbone.*``.
"""

from __future__ import annotations

import torch
from torch import nn

from egotap_tpu_torch.models.layers import ConvReLU, conv_nhwc
from egotap_tpu_torch.models.resnet import ResNetEncoder, feature_expansion
from egotap_tpu_torch.ops.upsample import upsample2x_align_corners


def _merge_views(feat: torch.Tensor, batch: int, views: int) -> torch.Tensor:
    """(B*V, h, w, c) -> (B, h, w, V*c), view-major channel order."""
    _, h, w, c = feat.shape
    feat = feat.reshape(batch, views, h, w, c).permute(0, 2, 3, 1, 4)
    return feat.reshape(batch, h, w, views * c)


class _EncoderBlock(nn.Module):
    """The reference's Encoder_Block registrations (net_architecture.py:
    53-73): the trunk as ``backbone`` plus aliases of its stages."""

    def __init__(self, model_name: str):
        super().__init__()
        trunk = ResNetEncoder(model_name)
        self.backbone = trunk
        self.layer0 = nn.Sequential(trunk.conv1, trunk.bn1, nn.ReLU())
        self.layer1 = nn.Sequential(nn.MaxPool2d(3, 2, 1), trunk.layer1)
        self.layer2, self.layer3, self.layer4 = (trunk.layer2, trunk.layer3,
                                                 trunk.layer4)

    def forward(self, x: torch.Tensor):
        return self.backbone(x)


class _SharedBackbone(nn.Module):
    def __init__(self, model_name: str):
        super().__init__()
        self.backbone = _EncoderBlock(model_name)

    def forward(self, x: torch.Tensor):
        return self.backbone(x)


class _Decoder(nn.Module):
    def __init__(self, num_output_maps: int, fs: int, views: int):
        super().__init__()
        self.layer1_1x1 = ConvReLU(64 * fs, 64 * fs, 1, 0)
        self.layer2_1x1 = ConvReLU(128 * fs, 128 * fs, 1, 0)
        self.layer3_1x1 = ConvReLU(256 * fs, 258 * fs, 1, 0)
        self.layer4_1x1 = ConvReLU(512 * fs, 512 * fs, 1, 0)
        self.conv_up1 = ConvReLU(256 * fs + 64 * fs, 256 * fs, 3, 1)
        self.conv_up2 = ConvReLU(512 * fs + 128 * fs, 256 * fs, 3, 1)
        self.conv_up3 = ConvReLU(512 * fs + 258 * fs, 512 * fs, 3, 1)
        self.conv_heatmap = nn.Conv2d(256 * fs, num_output_maps * views, 1)

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
        return conv_nhwc(x, self.conv_heatmap)


class HeatmapUNet(nn.Module):
    """Weight-shared stereo encoder + channel-concat UNet decoder.

    num_output_maps: per-view output channels; model_name: resnet18 |
    resnet34; views: 2 = stereo, 1 = mono."""

    def __init__(self, num_output_maps: int, model_name: str = "resnet18",
                 views: int = 2):
        super().__init__()
        self.views = views
        fs = feature_expansion(model_name) * views
        self.backbone = _SharedBackbone(model_name)
        self.after_backbone = _Decoder(num_output_maps, fs, views)

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
