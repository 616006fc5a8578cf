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
takes ``lr(0)``.

The learned-LR optimizers (reference network.py:79-116: the
dadaptation / prodigyopt packages at lr 1.0 under the schedule) run at
``lr(step) / cfg.lr`` (JAX's ``_relative``) and learn a step size ``d``
from global sums over every parameter the step updates (one f32 scalar
each, kept on the parameters' device, so a step never waits for the
card):
  * ``DAdam``: ``optax.contrib.dadapt_adamw`` (decoupled decay; the
    reference's coupled ``decouple=False`` variant is not available, and
    ``make_optimizer`` warns, as JAX's does);
  * ``Prodigy``: ``optax.contrib.prodigy`` with ``safeguard_warmup=True``,
    ``estim_lr_coef=cfg.d_coef``, decoupled decay, ``params0`` a copy of
    the parameters taken at `Optimizer.init`;
  * ``DSGD`` / ``DAdaGrad``: the JAX package's own ``dadapt_sgd`` /
    ``dadapt_adagrad`` (coupled decay, ``cfg.growth_rate``).
One difference by design: where DAdam's or Prodigy's d-estimate divides
by zero (an all-zero gradient sum: DAdam's first step under
``cos_anneal_warmup``, whose lr is 0 there), optax's estimate is NaN and
every later update with it; the port keeps the previous estimate on that
step, and every other step is optax's.

Schedules: 'lambda' (linear decay stepped per epoch), 'step',
'exponent', 'cos_anneal' (per iteration) and 'cos_anneal_warmup' (linear
warmup over ``niter`` epochs of iterations, then cosine to zero; HF
get_cosine_schedule_with_warmup), with the JAX package's step counting.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, Dict, List, Optional

import torch

from egotap_tpu_torch.core.config import Config

Params = Dict[str, torch.Tensor]
B1, B2 = 0.9, 0.999
SB2 = B2 ** 0.5              # DAdam's and Prodigy's beta3
D0 = 1e-6                    # every learned-LR optimizer's initial d


def _cpu_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


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


# per kind: the per-parameter state trees, and the scalar estimates with
# their initial values (the JAX / optax state fields of the same names;
# the update count is ``count`` for all)
_STATE = {
    "adam": (("mu", "nu"), {}),
    "adamw": (("mu", "nu"), {}),
    "sgd": ((), {}),
    "dadam": (("exp_avg", "exp_avg_sq", "grad_sum"),
              {"estim_lr": D0, "numerator_weighted": 0.0}),
    "prodigy": (("exp_avg", "exp_avg_sq", "grad_sum", "params0"),
                {"estim_lr": D0, "numerator_weighted": 0.0}),
    "dsgd": (("s",), {"d": D0, "g0_norm": 0.0, "grad_sum_sq": 0.0}),
    "dadagrad": (("s", "a_sq"), {"d": D0, "weighted_sum": 0.0}),
}


def _sum(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The sum of every element of ``tensors``, one f32 scalar."""
    return torch.stack([t.sum() for t in tensors]).sum()


def _dot(a: List[torch.Tensor], b: List[torch.Tensor]) -> torch.Tensor:
    return _sum(torch._foreach_mul(a, b))


def _l1(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(torch._foreach_norm(tensors, 1)).sum()


def _d_estimate(numerator, denominator, previous):
    """numerator / denominator, or ``previous`` where the denominator is
    zero (optax's NaN; see the module docstring)."""
    return torch.where(denominator > 0, numerator / denominator, previous)


class Optimizer:
    """One of the port's optimizers over a dict of named parameters.

    ``kind``: adam, adamw, sgd, dadam, prodigy, dsgd or dadagrad.
    ``schedule(count)`` is the learning rate (the learned-LR kinds take
    the relative one, lr(step) / base). ``init(params)`` zeroes the
    state; ``step(params, grads)`` updates the parameters in place from
    ``grads`` (a parameter whose gradient is None is left alone, keeps
    its state and is left out of the global sums, as the JAX parameter
    trees hold only the parameters the forward uses). State: ``count``
    (the updates made), the per-parameter ``trees`` by field and
    parameter name (Adam's ``mu`` / ``nu``), and the learned-LR kinds'
    f32 ``scalars`` (``estimate`` is their d; ``d_hat``, not part of the
    state, is the last step's own estimate, before the largest of it and
    the previous d is taken)."""

    def __init__(self, kind: str, schedule: Callable[[int], float],
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 growth_rate: float = float("inf"), d_coef: float = 1.0):
        if kind not in _STATE:
            raise ValueError(f"optimizer kind {kind!r}")
        self.kind, self.schedule = kind, schedule
        self.eps, self.weight_decay = eps, weight_decay
        self.growth_rate, self.d_coef = growth_rate, d_coef
        self.count = 0
        names, _ = _STATE[kind]
        self.trees: Dict[str, Params] = {n: {} for n in names}
        self.scalars: Dict[str, torch.Tensor] = {}
        self.d_hat: Optional[torch.Tensor] = None

    @property
    def mu(self) -> Params:
        return self.trees["mu"]

    @property
    def nu(self) -> Params:
        return self.trees["nu"]

    @property
    def estimate(self) -> torch.Tensor:
        """A learned-LR optimizer's step-size estimate d."""
        return self.scalars["d" if "d" in self.scalars else "estim_lr"]

    def init(self, params: Params) -> None:
        self.count = 0
        names, scalars = _STATE[self.kind]
        self.trees = {n: {k: torch.zeros_like(p) for k, p in params.items()}
                      for n in names}
        if "params0" in self.trees:                 # a copy, never a view
            self.trees["params0"] = {k: p.detach().clone()
                                     for k, p in params.items()}
        device = next(iter(params.values())).device if params else "cpu"
        self.scalars = {n: torch.tensor(v, dtype=torch.float32,
                                        device=device)
                        for n, v in scalars.items()}

    def state_dict(self) -> Dict[str, object]:
        """``count``, each tree by parameter name and each scalar, as CPU
        copies (a checkpoint saved on the card loads on the CPU)."""
        out: Dict[str, object] = {"count": self.count}
        out.update({f: {n: _cpu_copy(t) for n, t in tree.items()}
                    for f, tree in self.trees.items()})
        out.update({f: _cpu_copy(t) for f, t in self.scalars.items()})
        return out

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Copy a `state_dict` into this optimizer's state, in place and
        on its device; the parameter names must be the same."""
        for field, mine in self.trees.items():
            theirs = state[field]
            if set(mine) != set(theirs):
                raise KeyError(f"optimizer {field}: parameter names differ: "
                               f"{sorted(set(mine) ^ set(theirs))[:5]}")
            for n, t in theirs.items():
                mine[n].copy_(t)
        for field, mine in self.scalars.items():
            mine.copy_(state[field])
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, params: Params, grads: Dict[str, Optional[torch.Tensor]]
             ) -> None:
        names = [n for n in params if grads.get(n) is not None]
        p = [params[n] for n in names]
        g = [grads[n] for n in names]
        lr = self.schedule(self.count)
        self.count += 1
        trees = {f: [tree[n] for n in names] for f, tree in self.trees.items()}
        update = getattr(self, "_adam" if self.kind == "adamw"
                         else "_" + self.kind)
        update(p, g, lr, trees)

    def _adam(self, p, g, lr, trees):
        wd = self.weight_decay
        if wd and self.kind != "adamw":                  # coupled (L2)
            g = torch._foreach_add(g, p, alpha=wd)
        mu, nu = trees["mu"], trees["nu"]
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

    def _sgd(self, p, g, lr, trees):
        if self.weight_decay:
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        torch._foreach_add_(p, g, alpha=-lr)

    def _bias_corrected(self, lr: float) -> torch.Tensor:
        """estim_lr * lr * bc, the step of DAdam and Prodigy."""
        bc = (1 - B2 ** self.count) ** 0.5 / (1 - B1 ** self.count)
        return self.scalars["estim_lr"] * lr * bc

    def _dadam(self, p, g, lr, trees):
        """`optax.contrib.dadapt_adamw`, one update."""
        sc = self.scalars
        ea, eas, gs = trees["exp_avg"], trees["exp_avg_sq"], trees["grad_sum"]
        dlr = self._bias_corrected(lr)
        denom = torch._foreach_sqrt(eas)
        torch._foreach_add_(denom, self.eps)
        numerator_acum = _dot(g, torch._foreach_div(gs, denom))
        torch._foreach_mul_(ea, B1)
        torch._foreach_add_(ea, torch._foreach_mul(g, (1 - B1) * dlr))
        torch._foreach_mul_(eas, B2)
        torch._foreach_addcmul_(eas, g, g, value=1 - B2)
        torch._foreach_mul_(gs, SB2)
        torch._foreach_add_(gs, torch._foreach_mul(g, (1 - SB2) * dlr))
        sc["numerator_weighted"] = (SB2 * sc["numerator_weighted"]
                                    + (1 - SB2) * dlr * numerator_acum)
        self.d_hat = _d_estimate(sc["numerator_weighted"],
                                 (1 - SB2) * _l1(gs), sc["estim_lr"])
        sc["estim_lr"] = torch.maximum(sc["estim_lr"], self.d_hat)
        denom = torch._foreach_sqrt(eas)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(ea, denom)
        if self.weight_decay:                            # decoupled
            torch._foreach_add_(update, torch._foreach_mul(
                p, self.weight_decay * dlr))
        torch._foreach_sub_(p, update)

    def _prodigy(self, p, g, lr, trees):
        """`optax.contrib.prodigy` with ``safeguard_warmup=True``, one
        update."""
        sc = self.scalars
        ea, eas, gs = trees["exp_avg"], trees["exp_avg_sq"], trees["grad_sum"]
        estim_lr = sc["estim_lr"]
        dlr = self._bias_corrected(lr)
        dg = torch._foreach_mul(g, estim_lr)
        numerator_acum = _dot(g, torch._foreach_sub(trees["params0"], p))
        torch._foreach_mul_(ea, B1)
        torch._foreach_add_(ea, torch._foreach_mul(dg, 1 - B1))
        torch._foreach_mul_(eas, B2)
        torch._foreach_addcmul_(eas, dg, dg, value=1 - B2)
        torch._foreach_mul_(gs, SB2)
        torch._foreach_add_(gs, torch._foreach_div(
            torch._foreach_mul(dg, estim_lr), D0))
        sc["numerator_weighted"] = (SB2 * sc["numerator_weighted"]
                                    + estim_lr / D0 * dlr * numerator_acum)
        self.d_hat = _d_estimate(self.d_coef * sc["numerator_weighted"],
                                 _l1(gs), estim_lr)
        sc["estim_lr"] = estim_lr = torch.maximum(estim_lr, self.d_hat)
        denom = torch._foreach_sqrt(eas)
        torch._foreach_add_(denom, estim_lr * self.eps)
        update = torch._foreach_div(torch._foreach_mul(ea, dlr), denom)
        if self.weight_decay:                            # decoupled
            torch._foreach_add_(update, torch._foreach_mul(
                p, self.weight_decay * dlr))
        torch._foreach_sub_(p, update)

    def _growth(self, d_hat: torch.Tensor) -> None:
        self.d_hat = d_hat
        d = self.scalars["d"]
        self.scalars["d"] = torch.maximum(
            d, torch.minimum(d_hat, d * self.growth_rate))

    def _dsgd(self, p, g, lr, trees):
        """The JAX package's `dadapt_sgd`, one update."""
        sc = self.scalars
        if self.weight_decay:                            # coupled
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        gnorm = _dot(g, g).sqrt()
        if self.count == 1:                              # the first update
            sc["g0_norm"] = torch.clamp(gnorm, min=1e-12)
        lam = sc["d"] * lr / sc["g0_norm"]
        s = trees["s"]
        torch._foreach_add_(s, torch._foreach_mul(g, lam))
        sc["grad_sum_sq"] = sc["grad_sum_sq"] + lam * lam * gnorm * gnorm
        s_norm = _dot(s, s).sqrt()
        self._growth((s_norm * s_norm - sc["grad_sum_sq"])
                     / (2.0 * torch.clamp(s_norm, min=1e-12)))
        torch._foreach_add_(p, torch._foreach_mul(g, -lam))

    def _dadagrad(self, p, g, lr, trees):
        """The JAX package's `dadapt_adagrad`, one update."""
        sc = self.scalars
        if self.weight_decay:                            # coupled
            g = torch._foreach_add(g, p, alpha=self.weight_decay)
        s, a_sq = trees["s"], trees["a_sq"]
        torch._foreach_addcmul_(a_sq, g, g)
        denom = torch._foreach_sqrt(a_sq)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_add_(denom, 1e-12)
        lam = sc["d"] * lr
        torch._foreach_add_(s, torch._foreach_mul(g, lam))
        g_weighted = _sum(torch._foreach_div(torch._foreach_mul(g, g), denom))
        sc["weighted_sum"] = sc["weighted_sum"] + lam * lam * g_weighted
        s_weighted = _sum(torch._foreach_div(torch._foreach_mul(s, s), denom))
        self._growth((s_weighted - sc["weighted_sum"])
                     / (2.0 * torch.clamp(s_weighted.sqrt(), min=1e-12)))
        torch._foreach_add_(p, torch._foreach_div(
            torch._foreach_mul(g, -lam), denom))


def make_optimizer(cfg: Config, iters_per_epoch: int,
                   stage1: bool = False) -> Optimizer:
    """The optimizer of `egotap_tpu/train/optim.py:make_optimizer`."""
    sched = make_schedule(cfg, iters_per_epoch)
    if stage1:
        return Optimizer("adam", sched, 1e-8, cfg.weight_decay)
    kind = {"Adam": "adam", "AdamW": "adamw", "SGD": "sgd"}.get(
        cfg.optimizer_type)
    if kind is not None:
        return Optimizer(kind, sched, cfg.opt_eps, cfg.weight_decay)
    kind = {"DAdam": "dadam", "Prodigy": "prodigy", "DSGD": "dsgd",
            "DAdaGrad": "dadagrad"}.get(cfg.optimizer_type)
    if kind is None:
        raise NotImplementedError(f"optimizer {cfg.optimizer_type}")
    if kind == "dadam" and cfg.weight_decay and not cfg.decouple:
        warnings.warn(
            "DAdam is optax.contrib.dadapt_adamw (decoupled weight decay); "
            "the reference's default --decouple=False coupled variant is not "
            "available: decay semantics diverge for weight_decay > 0",
            stacklevel=2)
    base = cfg.lr
    return Optimizer(kind, lambda step: sched(step) / base, cfg.opt_eps,
                     cfg.weight_decay, growth_rate=cfg.growth_rate,
                     d_coef=cfg.d_coef)
