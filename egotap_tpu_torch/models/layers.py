"""Shared layers, NHWC, eval-mode semantics of the reference's factories.

Counterpart of `egotap_tpu/models/layers.py` (reference
model/network_utils.py:91-148):
  * `ConvReLU` — Conv2d + ReLU (the UNet decoder's ``convrelu``),
  * `FCBlock`  — Linear + BatchNorm1d + LeakyReLU(0.2) (``make_fc_layer``),
  * `MLPDecoder` — the pose heads (a single Linear in the PU config).

Modules keep the reference's ``state_dict`` key layout (``conv``/``0``,
``fc``, ``bn``, ``pose_fcs.0``), so reference ``.pth`` files and the JAX
variables carried across by `compat.from_jax` strict-load into them.

Precision follows the JAX modules: matmuls and convolutions run in the
input's dtype (weights cast to it), BatchNorm and LayerNorm compute in
f32 and cast back. Only eval-mode BatchNorm is ported; training BN
(per-view statistics, unbiased running variance) belongs to the training
slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
LEAKY_SLOPE = 0.2


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def linear(x: torch.Tensor, mod: nn.Linear) -> torch.Tensor:
    """``mod`` applied in x's dtype (flax ``nn.Dense(dtype=x.dtype)``)."""
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    return F.linear(x, mod.weight.to(x.dtype), b)


def conv_nhwc(x: torch.Tensor, mod: nn.Conv2d) -> torch.Tensor:
    """``mod`` on an NHWC tensor, in x's dtype.

    The NCHW view of a contiguous NHWC tensor is channels-last in memory,
    so cuDNN runs its NHWC kernels and no layout copy is made."""
    b = None if mod.bias is None else mod.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), mod.weight.to(x.dtype), b,
                 mod.stride, mod.padding)
    return y.permute(0, 2, 3, 1)


def batch_norm_eval(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm
                    ) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis, in f32, cast back
    (`egotap_tpu/models/layers.py:TorchBatchNorm`, running averages)."""
    inv = torch.rsqrt(bn.running_var.float() + BN_EPS) * bn.weight.float()
    y = (x.float() - bn.running_mean.float()) * inv + bn.bias.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm in f32, cast back to x's dtype (flax LayerNorm with a
    bf16 ``dtype`` computes its statistics and affine in f32)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(),
                     ln.bias.float(), ln.eps)
    return y.to(x.dtype)


class ConvReLU(nn.Sequential):
    """Conv2d + ReLU; keys ``0.weight`` / ``0.bias`` like the reference's
    ``nn.Sequential(nn.Conv2d, nn.ReLU)``."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__(nn.Conv2d(in_channels, features, kernel_size,
                                   padding=padding), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(conv_nhwc(x, self[0]))


class FCBlock(nn.Module):
    """Linear + BatchNorm1d + LeakyReLU(0.2) on (rows, features)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.fc = nn.Linear(in_features, features)
        self.bn = nn.BatchNorm1d(features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu(batch_norm_eval(linear(x, self.fc), self.bn))


class MLPDecoder(nn.Module):
    """FCBlocks + a final Linear (reference ``MLPDecoder``,
    net_architecture.py:179-212); with ``hidden=()`` a single Linear."""

    def __init__(self, in_features: int, out_features: int,
                 hidden: Sequence[int] = ()):
        super().__init__()
        dims = [in_features, *hidden]
        layers = [FCBlock(a, b) for a, b in zip(dims[:-1], dims[1:])]
        self.pose_fcs = nn.ModuleList(layers + [nn.Linear(dims[-1],
                                                          out_features)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.pose_fcs[:-1]:
            x = block(x)
        return linear(x, self.pose_fcs[-1])
