"""Heatmap -> per-joint embedding encoders.

Counterpart of `egotap_tpu/models/encoders.py`:
  * `GridViTEncoder`: Grid-ViT patch encoder + FC stack (reference
    ``PatchedHeatmapFeatureExtractorViT``, net_architecture.py:320-415);
  * `LimbFCEncoder`: per-limb FC encoder (reference
    ``HeatmapFeatureExtractorFC``, net_architecture.py:249-274).
``quant`` makes the ViT's projections and every FC block int8
(`egotap_tpu/models/encoders.py:29-44`, `:116-125`).
"""

from __future__ import annotations

import torch
from torch import nn

from egotap_tpu_torch.models.layers import FCBlock
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
