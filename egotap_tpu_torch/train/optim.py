"""Optimizers and learning-rate schedules, written by hand.

Counterpart of `egotap_tpu/train/optim.py` (reference model/network.py:
35-118), with the semantics of the optax transformations it chains:
  * ``Adam``: L2 weight decay added to the gradient (torch Adam, optax
    ``add_decayed_weights`` before ``scale_by_adam``), eps ``opt_eps``;
  * ``AdamW``: decoupled decay (``optax.adamw``), eps ``opt_eps``;
  * ``SGD``: coupled decay, no momentum (``optax.sgd``);
  * ``stage1=True``: torch-default Adam, eps 1e-8, coupled decay, as the
    reference builds the stage-1 optimizer (heatmap_shared_model.py:70-74).
Adam keeps ``mu``/``nu`` per parameter, bias-corrects both with the
update count and adds eps outside the square root (``scale_by_adam``);
the schedule is read at the count before the update, so the first update
takes ``lr(0)``. The learned-LR optimizers (DAdam, DSGD, DAdaGrad,
Prodigy) are not ported yet.

Schedules: 'lambda' (linear decay stepped per epoch), 'step',
'exponent', 'cos_anneal' (per iteration) and 'cos_anneal_warmup' (linear
warmup over ``niter`` epochs of iterations, then cosine to zero; HF
get_cosine_schedule_with_warmup), with the JAX package's step counting.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from egotap_tpu_torch.core.config import Config

Params = Dict[str, torch.Tensor]
B1, B2 = 0.9, 0.999


def make_schedule(cfg: Config, iters_per_epoch: int) -> Callable[[int], float]:
    """lr(step). 'lambda', 'step' and 'exponent' change once per epoch
    (torch schedulers stepped at the end of an epoch); 'cos_anneal*'
    follow the global step."""
    base, policy = cfg.lr, cfg.lr_policy
    ipe = max(1, iters_per_epoch)
    if policy not in ("lambda", "step", "exponent", "cos_anneal",
                      "cos_anneal_warmup"):
        raise NotImplementedError(f"lr policy {policy}")

    def sched(step: int) -> float:
        epoch = step // ipe
        if policy == "lambda":
            factor = 1.0 - max(0.0, epoch + cfg.epoch_count - cfg.niter) \
                / float(cfg.niter_decay + 1)
            return base * max(0.0, factor)   # clamped past the last epoch
        if policy == "step":
            return base * 0.5 ** (epoch // cfg.lr_decay_iters_step)
        if policy == "exponent":
            return base * 0.95 ** epoch
        if policy == "cos_anneal":
            t_max = max(1, (cfg.niter + cfg.niter_decay) * ipe)
            return base * 0.5 * (1 + math.cos(math.pi * min(step, t_max)
                                              / t_max))
        warmup = cfg.niter * ipe
        if step < warmup:
            return base * step / max(1, warmup)
        total = (cfg.niter + cfg.niter_decay) * ipe
        progress = (step - warmup) / max(1, total - warmup)
        return base * max(0.0, 0.5 * (1.0 + math.cos(
            math.pi * min(progress, 1.0))))

    return sched


class Optimizer:
    """One of the port's optimizers over a dict of named parameters.

    ``init(params)`` zeroes the state; ``step(params, grads)`` updates
    the parameters in place from ``grads`` (a parameter whose gradient is
    None is left alone and keeps its state, as the JAX parameter trees
    hold only the parameters the forward uses). State: ``count`` (the
    updates made) and, for Adam, ``mu`` and ``nu`` by parameter name."""

    def __init__(self, kind: str, schedule: Callable[[int], float],
                 eps: float = 1e-8, weight_decay: float = 0.0):
        if kind not in ("adam", "adamw", "sgd"):
            raise ValueError(f"optimizer kind {kind!r}")
        self.kind, self.schedule = kind, schedule
        self.eps, self.weight_decay = eps, weight_decay
        self.count = 0
        self.mu: Params = {}
        self.nu: Params = {}

    def init(self, params: Params) -> None:
        self.count = 0
        if self.kind != "sgd":
            self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
            self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def step(self, params: Params, grads: Dict[str, Optional[torch.Tensor]]
             ) -> None:
        names = [n for n in params if grads.get(n) is not None]
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        lr = self.schedule(self.count)
        self.count += 1
        wd = self.weight_decay
        if wd and self.kind != "adamw":                  # coupled (L2)
            g = torch._foreach_add(g, p, alpha=wd)
        if self.kind == "sgd":
            torch._foreach_add_(p, g, alpha=-lr)
            return
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, g, g, value=1 - B2)
        update = torch._foreach_div(mu, 1 - B1 ** self.count)
        denom = torch._foreach_sqrt(
            torch._foreach_div(nu, 1 - B2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        if wd and self.kind == "adamw":                  # decoupled
            torch._foreach_add_(update, p, alpha=wd)
        torch._foreach_add_(p, update, alpha=-lr)


def make_optimizer(cfg: Config, iters_per_epoch: int,
                   stage1: bool = False) -> Optimizer:
    """The optimizer of `egotap_tpu/train/optim.py:make_optimizer`."""
    sched = make_schedule(cfg, iters_per_epoch)
    if stage1:
        return Optimizer("adam", sched, 1e-8, cfg.weight_decay)
    kind = {"Adam": "adam", "AdamW": "adamw", "SGD": "sgd"}.get(
        cfg.optimizer_type)
    if kind is None:
        if cfg.optimizer_type in ("DAdam", "DSGD", "DAdaGrad", "Prodigy"):
            raise NotImplementedError(
                f"optimizer {cfg.optimizer_type}: the learned-LR optimizers "
                "are not ported yet (ROADMAP.md section 1, item 2)")
        raise NotImplementedError(f"optimizer {cfg.optimizer_type}")
    return Optimizer(kind, sched, cfg.opt_eps, cfg.weight_decay)
