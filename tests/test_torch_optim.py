"""The port's hand-written optimizers and schedules
(egotap_tpu_torch.train.optim) against the JAX package's optax
transformations: the traces of the five schedules, and five updates of
Adam (coupled decay; stage-1 and stage-2 eps), AdamW and SGD on a seeded
random tree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.train.optim import make_optimizer as jax_make_optimizer
from egotap_tpu.train.optim import make_schedule as jax_make_schedule
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.train.optim import make_optimizer, make_schedule

IPE = 3

SCHEDULES = {
    "lambda": dict(niter=2, niter_decay=3, epoch_count=1),
    "step": dict(lr_decay_iters_step=2),
    "exponent": {},
    "cos_anneal": dict(niter=2, niter_decay=3),
    "cos_anneal_warmup": dict(niter=1, niter_decay=4),
}


@pytest.mark.parametrize("policy", sorted(SCHEDULES))
def test_schedule_trace_matches_jax(policy):
    """lr(step) for every step of the run and a few past its end. The
    JAX schedule runs in float64 here: in float32 its cosine near the end
    of the run cancels (1 + cos(pi x) near 0), the port's float64 does
    not."""
    fields = dict(lr=3e-4, lr_policy=policy, **SCHEDULES[policy])
    ours = make_schedule(Config(**fields), IPE)
    ref = jax_make_schedule(JaxConfig(**fields), IPE)
    steps = range(0, (fields.get("niter", 0) + fields.get("niter_decay", 4)
                      + 2) * IPE)
    with jax.enable_x64(True):
        want = np.array([float(ref(jnp.asarray(s))) for s in steps])
    got = np.array([ours(s) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if policy == "cos_anneal_warmup":
        assert got[0] == 0.0 and got[IPE] == pytest.approx(3e-4)


def test_unported_optimizers_raise():
    for name in ("DAdam", "DSGD", "DAdaGrad", "Prodigy"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_optimizer(Config(optimizer_type=name), 1)


def _tree(rng):
    shapes = {"conv": (3, 3, 4, 5), "dense": (6, 7), "bias": (7,)}
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


@pytest.mark.parametrize("kind,fields", [
    ("stage1", dict(weight_decay=0.1)),
    ("Adam", dict(optimizer_type="Adam", weight_decay=0.1)),
    ("Adam_nodecay", dict(optimizer_type="Adam")),
    ("AdamW", dict(optimizer_type="AdamW", weight_decay=0.05)),
    ("SGD", dict(optimizer_type="SGD", weight_decay=0.1)),
])
def test_updates_match_optax(kind, fields):
    """Five updates from the same parameters and gradients under the
    cos_anneal_warmup schedule (lr 0 at step 0); parameters and moments
    within 1e-6."""
    fields = dict(lr=1e-2, lr_policy="cos_anneal_warmup", niter=1,
                  niter_decay=3, **fields)
    stage1 = kind == "stage1"
    tx = jax_make_optimizer(JaxConfig(**fields), 2, stage1=stage1)
    opt = make_optimizer(Config(**fields), 2, stage1=stage1)
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = tx.init(jp)
    opt.init(tp)
    for _ in range(5):
        grads = {k: v * rng.uniform(0.01, 10) for k, v in _tree(rng).items()}
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in
                                     grads.items()}, jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in grads.items()})
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert opt.count == 5
    adam = [s for s in jax.tree.leaves(jstate, is_leaf=lambda s: hasattr(
        s, "mu")) if hasattr(s, "mu")]
    if kind != "SGD":
        (adam,) = adam
        assert int(adam.count) == opt.count
        for name in ("mu", "nu"):
            for k in params:
                ref = np.asarray(getattr(adam, name)[k])
                np.testing.assert_allclose(
                    getattr(opt, name)[k].numpy(), ref, rtol=1e-6,
                    atol=1e-6 * np.abs(ref).max(), err_msg=f"{name} {k}")


def test_parameter_without_gradient_is_left_alone():
    """A parameter the forward does not use (None gradient) keeps its
    value and its moments, also under decoupled decay."""
    opt = make_optimizer(Config(optimizer_type="AdamW", weight_decay=0.1,
                                lr_policy="exponent"), 1)
    p = {"used": torch.ones(3), "unused": torch.ones(3)}
    opt.init(p)
    opt.step(p, {"used": torch.ones(3), "unused": None})
    assert torch.equal(p["unused"], torch.ones(3))
    assert not opt.mu["unused"].any() and opt.mu["used"].all()
    assert (p["used"] < 1).all()
