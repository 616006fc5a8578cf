"""The training state of either task, and checkpoint I/O.

Counterpart of `egotap_tpu/train/state.py`: `TrainState` holds the step
count, the trained net (the stage-1 `HeatmapUNet` or the stage-2 lifter,
with its parameters and BatchNorm running statistics), the optimizer
with its state, and the frozen nets (stage 2: the stage-1 nets, whose
running statistics evolve in train-mode BatchNorm; stage 1: none).
Unlike the JAX pytree it holds modules and is updated in place.

Checkpoints, in the port's own format: ``{experiment_dir}/ckpt_{tag}``
(tag an epoch, ``best``, ``nan`` or ``inf``, the reference's scheme,
model/base_model.py:64-114) holds `CKPT_FILE`, a `torch.save` of
``{step, net, opt, frozen}`` with every tensor on the CPU, so a
checkpoint saved on the card loads on the CPU. It is written to a
temporary file and renamed, and read with ``weights_only=True``. Saving
an epoch removes the previous epoch's checkpoint, as the reference does.
The int8 inference twins (``inference``) are never saved.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, Optional

import torch
from torch import nn

from egotap_tpu_torch.train.optim import Optimizer

CKPT_FILE = "state.pt"


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


def _ckpt_dir(experiment_dir: str, tag) -> str:
    return os.path.abspath(os.path.join(experiment_dir, f"ckpt_{tag}"))


def _cpu_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True)
            for k, v in module.state_dict().items()}


def save_checkpoint(experiment_dir: str, tag, state: TrainState) -> str:
    """Write ``state`` as ``ckpt_{tag}``; saving epoch N > 1 removes
    ``ckpt_{N-1}``. Returns the directory."""
    path = _ckpt_dir(experiment_dir, tag)
    os.makedirs(path, exist_ok=True)
    payload = {"step": int(state.step),
               "net": _cpu_state_dict(state.net),
               "opt": state.opt.state_dict(),
               "frozen": {k: _cpu_state_dict(m)
                          for k, m in state.frozen.items()}}
    target = os.path.join(path, CKPT_FILE)
    torch.save(payload, target + ".tmp")
    os.replace(target + ".tmp", target)
    if isinstance(tag, int) and tag > 1:
        prev = _ckpt_dir(experiment_dir, tag - 1)
        if os.path.exists(prev):
            shutil.rmtree(prev)
    return path


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The saved dict of a ``ckpt_{tag}`` directory, tensors on the CPU."""
    return torch.load(os.path.join(path, CKPT_FILE), map_location="cpu",
                      weights_only=True)


def load_checkpoint(experiment_dir: str, tag, template: TrainState,
                    restore_opt_state: bool = True) -> TrainState:
    """Restore ``ckpt_{tag}`` into ``template`` in place: the parameters
    and BatchNorm statistics are copied into the live modules (on their
    device), so the optimizer's parameter names keep pointing at them.
    With ``restore_opt_state=False`` the template's optimizer state is
    kept (evaluation must not depend on the training optimizer). Any
    int8 inference twin of the template is dropped: it holds the old
    weights. Returns the template."""
    saved = read_checkpoint(_ckpt_dir(experiment_dir, tag))
    template.net.load_state_dict(saved["net"], strict=True)
    if set(saved["frozen"]) != set(template.frozen):
        raise KeyError(f"checkpoint frozen nets {sorted(saved['frozen'])}, "
                       f"template {sorted(template.frozen)}")
    for key, net in template.frozen.items():
        net.load_state_dict(saved["frozen"][key], strict=True)
    if restore_opt_state:
        template.opt.load_state_dict(saved["opt"])
    template.step = int(saved["step"])
    template.inference = None
    return template


def checkpoint_exists(experiment_dir: str, tag) -> bool:
    return os.path.isfile(os.path.join(_ckpt_dir(experiment_dir, tag),
                                       CKPT_FILE))
