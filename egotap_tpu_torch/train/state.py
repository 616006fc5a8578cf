"""The training state of either task.

Counterpart of `egotap_tpu/train/state.py:TrainState`: the step count,
the trained net (the stage-1 `HeatmapUNet` or the stage-2 lifter, with
its parameters and BatchNorm running statistics), the optimizer with
its state, and the frozen nets (stage 2: the stage-1 nets, whose running
statistics evolve in train-mode BatchNorm; stage 1: none). Unlike the
JAX pytree it holds modules and is updated in place. Checkpoint I/O is
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from egotap_tpu_torch.train.optim import Optimizer


@dataclasses.dataclass
class TrainState:
    step: int
    net: nn.Module                   # the net the optimizer trains
    opt: Optimizer
    frozen: Dict[str, nn.Module]     # stage 2: "heatmap", "rot_heatmap"
    # int8 twins and scales from `LifterTask.prepare_inference` (a
    # `serving.Predictor`); inference only, never part of a checkpoint
    inference: Optional[Any] = None

    @classmethod
    def create(cls, net: nn.Module, frozen: Dict[str, nn.Module],
               opt: Optimizer, device: torch.device, step: int = 0
               ) -> "TrainState":
        """Move the nets to ``device`` in eval mode (the training step
        sets training mode itself), freeze the frozen nets' parameters,
        and zero the optimizer's state for the trained net's parameters."""
        net.to(device).eval()
        for frozen_net in frozen.values():
            frozen_net.to(device).eval().requires_grad_(False)
        opt.init(dict(net.named_parameters()))
        return cls(step=step, net=net, opt=opt, frozen=frozen)
