"""The stage-2 training state.

Counterpart of `egotap_tpu/train/state.py:TrainState` for the lifter
task: the step count, the trainable lifter (parameters and BatchNorm
running statistics), the optimizer with its state, and the frozen
stage-1 nets (parameters and running statistics, which evolve in
train-mode BatchNorm). Unlike the JAX pytree it holds modules and is
updated in place. Checkpoint I/O is not ported yet.
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
    lifter: nn.Module
    opt: Optimizer
    frozen: Dict[str, nn.Module]     # "heatmap", "rot_heatmap"
    # int8 twins and scales from `LifterTask.prepare_inference` (a
    # `serving.Predictor`); inference only, never part of a checkpoint
    inference: Optional[Any] = None

    @classmethod
    def create(cls, lifter: nn.Module, frozen: Dict[str, nn.Module],
               opt: Optimizer, device: torch.device, step: int = 0
               ) -> "TrainState":
        """Move the nets to ``device`` in eval mode (the training step
        sets training mode itself), freeze the stage-1 nets' parameters,
        and zero the optimizer's state for the lifter's parameters."""
        lifter.to(device).eval()
        for net in frozen.values():
            net.to(device).eval().requires_grad_(False)
        opt.init(dict(lifter.named_parameters()))
        return cls(step=step, lifter=lifter, opt=opt, frozen=frozen)
