"""Bridges between a port state and the reference's files.

Counterpart of `egotap_tpu/compat/export.py:216-414` and
`egotap_tpu/train/state.py:76-127`:
  * `export_reference_checkpoints` writes the reference's
    ``{tag}_net_{Name}.pth`` files (model/base_model.py:64-82 naming)
    from a port `TrainState`: ``HeatMap`` for a stage-1 state,
    ``AutoEncoder``, ``HeatMap`` and ``RotHeatMap`` for a stage-2 one.
    The port's modules carry the reference's keys (the Encoder_Block
    aliases, the unused ``backbone.fc``, ``cls_token`` and ``pooler``,
    ``num_batches_tracked``), so a file is the module's ``state_dict``
    as f32 CPU tensors (int64 step counters) in the module's key order.
    An alias key shares storage with its canonical tensor, and
    ``torch.save`` writes that storage once, where JAX's export writes a
    copy a key: compare files key by key, not byte by byte.
  * `load_reference_optimizer` installs a reference torch Adam / AdamW
    ``optimizer.state_dict()`` (``{tag}_optim_i.pth``) into the port's
    `train.optim.Optimizer`, and `resume_step_from_scheduler` gives the
    training step a torch scheduler's ``state_dict`` stands at. The port
    reads the learning rate at the optimizer's own count, which is
    torch's step: JAX's `load_reference_optimizer` installs the same
    count into its schedule (``schedule_count`` defaults to ``count``),
    and the port keeps no separate schedule count (ROADMAP.md section
    3, "Differences by design").
  * `merge_partial_weights` / `load_partial_weights`: the reference's
    cross-experiment transfer (model/base_model.py:150-162), a
    substring filter over the ``state_dict`` keys and a non-strict load;
    a key missing from the source or of another shape keeps the
    target's value. The keys are the reference's torch keys
    (``pos_heatmap_encoder.vit...``), as the reference matched them; the
    JAX package matches substrings of its flax paths
    (``pos_encoder/vit/...``) instead.
A reference ``.pth`` strict-loads into the port's modules as it stands
(`serving.Predictor.from_reference_checkpoints`), so the JAX package's
converter (`compat/convert.py`) has no counterpart here.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from egotap_tpu_torch.train.optim import Optimizer
from egotap_tpu_torch.train.state import TrainState, read_checkpoint

StateDict = Dict[str, torch.Tensor]


def reference_state_dict(module: nn.Module) -> "collections.OrderedDict":
    """``module``'s state_dict as the reference saves it: every key in
    the module's order, floating tensors as f32 CPU copies, integer
    tensors (``num_batches_tracked``) as they are."""
    out = collections.OrderedDict()
    for k, v in module.state_dict().items():
        v = v.detach().to("cpu", copy=True)
        out[k] = v.float() if v.is_floating_point() else v
    return out


def export_reference_checkpoints(state: TrainState, out_dir: str,
                                 tag: str = "best") -> List[str]:
    """Write the reference-layout ``{tag}_net_*.pth`` files of ``state``
    under ``out_dir``; returns their paths."""
    os.makedirs(out_dir, exist_ok=True)
    nets = ([("AutoEncoder", state.net), ("HeatMap", state.frozen["heatmap"]),
             ("RotHeatMap", state.frozen["rot_heatmap"])] if state.frozen
            else [("HeatMap", state.net)])
    written = []
    for name, net in nets:
        path = os.path.join(out_dir, f"{tag}_net_{name}.pth")
        torch.save(reference_state_dict(net), path)
        written.append(path)
    return written


def strip_module_prefix(state: StateDict) -> StateDict:
    """Remove DataParallel's ``module.`` prefixes (reference
    model/base_model.py:164-171)."""
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in state.items()}


def load_reference_optimizer(opt: Optimizer, net: nn.Module,
                             optim_sd: Dict, sched_sd: Optional[Dict] = None,
                             lr_policy: str = "lambda",
                             iters_per_epoch: int = 1) -> Tuple[int, int]:
    """Install a torch Adam / AdamW ``optimizer.state_dict()`` of ``net``
    into ``opt`` (an initialised Adam or AdamW `Optimizer` over
    ``net.named_parameters()``): the moments by position in
    ``named_parameters()`` order (torch's ``parameters()`` order, aliases
    registered once), zero moments for a parameter without torch state
    (never given a gradient), and ``opt.count`` the torch step, which
    must be the same for every parameter. Returns (count, the training
    step of ``sched_sd`` by `resume_step_from_scheduler`, or count when
    no scheduler is given)."""
    if opt.kind not in ("adam", "adamw"):
        raise ValueError(f"a torch Adam state cannot resume {opt.kind!r}")
    names = [n for n, _ in net.named_parameters()]
    order = [i for g in optim_sd["param_groups"] for i in g["params"]]
    if len(order) != len(names):
        raise ValueError(f"optimizer has {len(order)} parameters, the net "
                         f"{len(names)}")
    steps = set()
    with torch.no_grad():
        for name, idx in zip(names, order):
            st = optim_sd["state"].get(idx)
            for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                mine = opt.trees[field][name]
                if st is None:
                    mine.zero_()
                    continue
                theirs = st[key]
                if tuple(theirs.shape) != tuple(mine.shape):
                    raise ValueError(f"moment shape of {name}: "
                                     f"{tuple(theirs.shape)} vs "
                                     f"{tuple(mine.shape)}")
                mine.copy_(theirs)
            if st is not None:
                steps.add(int(torch.as_tensor(st["step"]).item()))
    if len(steps) > 1:
        raise ValueError(f"non-uniform torch Adam steps: {sorted(steps)}")
    opt.count = steps.pop() if steps else 0
    step = (opt.count if sched_sd is None else resume_step_from_scheduler(
        sched_sd, lr_policy, iters_per_epoch))
    return opt.count, step


def resume_step_from_scheduler(sched_sd: Dict, lr_policy: str,
                               iters_per_epoch: int) -> int:
    """The training step a torch scheduler's ``state_dict`` stands at:
    ``last_epoch`` counts ``scheduler.step()`` calls, once an epoch for
    'lambda', 'step' and 'exponent' (reference train.py:224), once an
    iteration for 'cos_anneal*' (train.py:129-130)."""
    last = int(sched_sd["last_epoch"])
    if lr_policy in ("lambda", "step", "exponent"):
        return last * iters_per_epoch
    return last


def merge_partial_weights(target: nn.Module, source: StateDict,
                          parts: Iterable[str]) -> List[str]:
    """Load into ``target`` the entries of ``source`` whose key contains
    any of ``parts`` and whose shape is the target's; returns the keys
    loaded, in the target's order."""
    parts = list(parts)
    mine = target.state_dict()
    picked = collections.OrderedDict()
    for k, v in mine.items():
        src = source.get(k)
        if (any(p in k for p in parts) and src is not None
                and tuple(src.shape) == tuple(v.shape)):
            picked[k] = src
    target.load_state_dict(picked, strict=False)
    return list(picked)


def load_partial_weights(target: nn.Module, checkpoint_path: str,
                         parts: Iterable[str]) -> List[str]:
    """`merge_partial_weights` from a checkpoint: a port ``ckpt_{tag}``
    directory (its trained net) or a reference ``.pth`` (DataParallel
    prefixes stripped)."""
    if os.path.isdir(checkpoint_path):
        source = read_checkpoint(checkpoint_path)["net"]
    else:
        source = strip_module_prefix(torch.load(
            checkpoint_path, map_location="cpu", weights_only=True))
    return merge_partial_weights(target, source, parts)
