"""Seeded weights and inputs, drawn on the device in a few large calls.

`draw_state` fills a module built on the meta device (the reference's, so
the keys are the reference checkpoints' layout) with values drawn from one
seed: one uniform and one normal draw on the device for all tensors,
sliced and scaled per tensor. Two styles:

  * ``serve``: the seeded random weights a serving test uses: uniform
    +-1/sqrt(fan_in) for conv and linear weights, N(0, 0.02) for the ViT's
    token and position embeddings, uniform +-0.05 for every other
    parameter, BatchNorm near identity with non-trivial running
    statistics (weight U(0.9, 1.1), mean N(0, 0.05), variance U(0.8, 1.2)),
    LayerNorm weights 1;
  * ``train``: the reference's initialisation of a lifter before
    training: kaiming-normal (fan_in) conv and linear weights, zero
    biases, N(0, 1) position embeddings, default BatchNorm and LayerNorm
    (weight 1, bias 0, mean 0, variance 1), zero mask token.

The values depend on the seed and the shapes alone, not on the device's
other work.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
from torch import nn

EMBEDDINGS = ("mask_token", "cls_token", "position_embeddings")
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one purpose, derived from the run's seed."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


def _plan(module: nn.Module, style: str):
    """[(name, tensor, (kind, a, b))]: each unique tensor and how it is
    drawn: ``("u", lo, hi)`` uniform, ``("n", mean, std)`` normal, ``("c",
    value, None)`` constant."""
    bn_of, ln_of = {}, set()
    for name, m in module.named_modules(remove_duplicate=False):
        prefix = f"{name}." if name else ""
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            for leaf in ("weight", "bias", "running_mean", "running_var",
                         "num_batches_tracked"):
                bn_of[prefix + leaf] = leaf
        elif isinstance(m, nn.LayerNorm):
            ln_of.add(prefix + "weight")
    plan = []
    for name, t in list(module.named_parameters()) + list(
            module.named_buffers()):
        leaf = name.rsplit(".", 1)[-1]
        bn = bn_of.get(name)
        if bn is not None:
            if style == "serve":
                kind = {"weight": ("u", 0.9, 1.1), "bias": ("u", -0.05, 0.05),
                        "running_mean": ("n", 0.0, 0.05),
                        "running_var": ("u", 0.8, 1.2)}.get(bn, ("c", 0, None))
            else:
                kind = {"weight": ("c", 1.0, None),
                        "running_var": ("c", 1.0, None)}.get(bn,
                                                             ("c", 0, None))
        elif name in ln_of:
            kind = ("c", 1.0, None)
        elif leaf in EMBEDDINGS:
            if style == "serve":
                kind = ("n", 0.0, 0.02)
            else:
                kind = (("n", 0.0, 1.0) if leaf == "position_embeddings"
                        else ("c", 0.0, None))
        elif t.dim() >= 2 and leaf == "weight":
            fan_in = t[0].numel()
            kind = (("u", -1 / math.sqrt(fan_in), 1 / math.sqrt(fan_in))
                    if style == "serve"
                    else ("n", 0.0, math.sqrt(2.0 / fan_in)))
        else:
            kind = ("u", -0.05, 0.05) if style == "serve" else ("c", 0, None)
        plan.append((name, t, kind))
    return plan


@torch.no_grad()
def draw_state(module: nn.Module, seed: int, key: int, device,
               style: str = "serve") -> Dict[str, torch.Tensor]:
    """Materialise ``module`` (built on the meta device) on ``device`` with
    values drawn from (``seed``, ``key``); returns its state_dict, aliases
    included."""
    plan = _plan(module, style)
    module.to_empty(device=device)
    # the plan holds the meta tensors: look the new ones up by name
    live = dict(module.named_parameters())
    live.update(dict(module.named_buffers()))
    sizes = {"u": 0, "n": 0}
    for _, t, (kind, _, _) in plan:
        if kind in sizes:
            sizes[kind] += t.numel()
    g = generator(device, seed, key)
    pools = {"u": torch.rand(sizes["u"], generator=g, device=device),
             "n": torch.randn(sizes["n"], generator=g, device=device)}
    at = {"u": 0, "n": 0}
    for name, t, (kind, a, b) in plan:
        dst = live[name]
        if kind == "c":
            dst.fill_(a)
            continue
        n = dst.numel()
        src = pools[kind][at[kind]:at[kind] + n].view(dst.shape)
        at[kind] += n
        dst.copy_(a + (b - a) * src if kind == "u" else a + b * src)
    return module.state_dict()


def frames(batch: int, size: int, count: int, seed: int, key: int,
           device) -> List[torch.Tensor]:
    """``count`` distinct (batch, 2, size, size, 3) stereo batches of
    ImageNet-normalised float32 frames (pixels uniform in [0, 1])."""
    g = generator(device, seed, key)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    raw = torch.rand((count, batch, 2, size, size, 3), generator=g,
                     device=device)
    return list(((raw - mean) / std).unbind(0))


def poses(batch: int, joints: int, count: int, seed: int, key: int,
          device) -> List[torch.Tensor]:
    """``count`` (batch, joints, 3) ground-truth poses in cm: joints
    N(0, 30) around the head."""
    g = generator(device, seed, key)
    return list((30.0 * torch.randn((count, batch, joints, 3), generator=g,
                                    device=device)).unbind(0))
