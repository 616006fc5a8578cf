"""Heatmap -> per-joint embedding encoders.

Counterpart of `egotap_tpu/models/encoders.py`:
  * `GridViTEncoder`: Grid-ViT patch encoder + FC stack (reference
    ``PatchedHeatmapFeatureExtractorViT``, net_architecture.py:320-415);
  * `LimbFCEncoder`: per-limb FC encoder (reference
    ``HeatmapFeatureExtractorFC``, net_architecture.py:249-274);
  * `ConvHeatmapEncoder` and `HeatmapDecoder`: the legacy whole-stack
    conv encoder and the vestigial reconstruction decoder (reference
    ``HeatmapFeatureExtractor`` / ``HeatmapDecoder``,
    net_architecture.py:276-317, 417-464), which no shipped config
    builds. Their keys are the JAX module names (``conv1.conv``,
    ``fc1.bn``, ``deconv1``, ``deconv_bn1``); the flattened grid is
    NHWC-ordered, as in JAX.
``quant`` makes the ViT's projections and every FC block int8
(`egotap_tpu/models/encoders.py:29-44`, `:116-125`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from egotap_tpu_torch.models.layers import (BN_EPS, ConvBlock, FCBlock,
                                            batch_norm, leaky_relu)
from egotap_tpu_torch.models.vit import PATCH, GridViT


class GridViTEncoder(nn.Module):
    """Pre-patchified (B, N, P*P, C*16*16) tokens -> (B, N*hidden)."""

    def __init__(self, num_tiles: int, hidden_size: int = 128,
                 channels: int = 1, vit_hidden: int = 1024,
                 vit_layers: int = 3, heatmap_size: int = 64,
                 quant: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.vit = GridViT(num_tiles, channels, vit_hidden, vit_layers,
                           heatmap_size=heatmap_size, quant=quant)
        tokens = (heatmap_size // PATCH) ** 2
        self.fc1 = FCBlock(tokens * vit_hidden, 2048, quant)
        self.fc2 = FCBlock(2048, 512, quant)
        self.fc3 = FCBlock(512, hidden_size, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n = x.shape[0], x.shape[1]
        z = self.vit(x).reshape(b * n, -1)
        z = self.fc3(self.fc2(self.fc1(z)))
        return z.reshape(b, n * self.hidden_size)


class LimbFCEncoder(nn.Module):
    """(B, M, C*H*W) limb rows -> (B, M*hidden)."""

    def __init__(self, in_features: int, hidden_size: int = 128,
                 quant: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.fc1 = FCBlock(in_features, 2048, quant)
        self.fc2 = FCBlock(2048, 512, quant)
        self.fc3 = FCBlock(512, hidden_size, quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, m = x.shape[0], x.shape[1]
        z = self.fc3(self.fc2(self.fc1(x.reshape(b * m, -1))))
        return z.reshape(b, m * self.hidden_size)


class ConvHeatmapEncoder(nn.Module):
    """(B, H, W, C) heatmap stack -> (B, hidden): 3 stride-2 `ConvBlock`s
    (32, 64, 128 channels) and 3 `FCBlock`s (JAX `ConvHeatmapEncoder`,
    the reference's non-indep semantics)."""

    def __init__(self, in_channels: int, hidden_size: int = 128,
                 heatmap_size: int = 64):
        super().__init__()
        cin = in_channels
        for i, feats in enumerate((32, 64, 128), start=1):
            setattr(self, f"conv{i}", ConvBlock(cin, feats, 4, 2, 1))
            cin = feats
        self.fc1 = FCBlock((heatmap_size // 8) ** 2 * 128, 2048)
        self.fc2 = FCBlock(2048, 512)
        self.fc3 = FCBlock(512, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv3(self.conv2(self.conv1(x)))
        return self.fc3(self.fc2(self.fc1(x.reshape(x.shape[0], -1))))


class HeatmapDecoder(nn.Module):
    """(B, hidden) latent -> (B, H, W, num_heatmap): 3 `FCBlock`s to an
    (H/8, W/8, 128) grid, then 3 x (4x4 stride-2 transposed conv,
    BatchNorm, LeakyReLU 0.2) (JAX `HeatmapDecoder`). Flax's
    ``ConvTranspose(padding="SAME")`` pads the dilated input by 2 on each
    side and does not flip its kernel: the same as ``ConvTranspose2d(k=4,
    s=2, p=1)`` with the kernel flipped (`compat.from_jax` flips it)."""

    def __init__(self, in_features: int, num_heatmap: int,
                 heatmap_size: int = 64):
        super().__init__()
        self.grid = heatmap_size // 8
        self.fc1 = FCBlock(in_features, 512)
        self.fc2 = FCBlock(512, 2048)
        self.fc3 = FCBlock(2048, self.grid ** 2 * 128)
        cin = 128
        for i, feats in enumerate((64, 32, num_heatmap), start=1):
            setattr(self, f"deconv{i}", nn.ConvTranspose2d(cin, feats, 4, 2, 1))
            setattr(self, f"deconv_bn{i}", nn.BatchNorm2d(feats, eps=BN_EPS))
            cin = feats

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        z = self.fc3(self.fc2(self.fc1(z)))
        x = z.reshape(z.shape[0], self.grid, self.grid, 128)
        for i in range(1, 4):
            deconv = getattr(self, f"deconv{i}")
            y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                                   deconv.weight.to(x.dtype),
                                   deconv.bias.to(x.dtype), 2, 1)
            x = leaky_relu(batch_norm(y.permute(0, 2, 3, 1),
                                      getattr(self, f"deconv_bn{i}"),
                                      self.training))
        return x
