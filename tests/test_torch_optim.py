"""The port's hand-written optimizers and schedules
(egotap_tpu_torch.train.optim) against the JAX package's optax
transformations: the traces of the five schedules, five updates of Adam
(coupled decay; stage-1 and stage-2 eps), AdamW and SGD on a seeded
random tree, and five updates of each learned-LR optimizer (DAdam,
Prodigy, DSGD, DAdaGrad) against JAX's `make_optimizer`."""

import warnings

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


def test_unknown_optimizer_raises():
    with pytest.raises(NotImplementedError, match="RMSprop"):
        make_optimizer(Config(optimizer_type="RMSprop"), 1)


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


# ---- the learned-LR optimizers ----------------------------------------
#
# Five updates from the same parameters, with gradients of a quadratic
# (each made from JAX's parameters, plus noise) so that the estimate d
# grows (Prodigy's needs more steps than five to leave its 1e-6). Both
# sides compute in f32, but the port takes lr(step) / base and DAdam's
# and Prodigy's bias correction sqrt(1 - 0.999^k) / (1 - 0.9^k) in
# float64, where optax computes 1 - 0.999^k in f32 and loses 3 of its 7
# digits to the cancellation: the scalar estimates read up to 1.6e-5
# relative (DAdam), the parameters 2e-7 of their max.
LEARNED_ATOL, ESTIMATE_RTOL = 1e-6, 1e-4
LEARNED = {"DAdam": "estim_lr", "Prodigy": "estim_lr", "DSGD": "d",
           "DAdaGrad": "d"}


def _learned_run(fields, zero_first=False, patch_nan=False, steps=5):
    """(port optimizer, port params, JAX params, JAX state) after
    ``steps`` updates. ``zero_first``: an all-zero first gradient.
    ``patch_nan``: where JAX's estimate turns NaN, put the previous one
    back (what the port keeps) before the next update."""
    tx = jax_make_optimizer(JaxConfig(**fields), 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        opt = make_optimizer(Config(**fields), 2)
    rng = np.random.default_rng(1)
    params = _tree(rng)
    target = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate = tx.init(jp)
    opt.init(tp)
    update = jax.jit(tx.update)
    field = LEARNED[fields["optimizer_type"]]
    for i in range(steps):
        noise = _tree(rng)
        grads = {k: (np.asarray(jp[k]) - target[k] + 0.1 * noise[k])
                 * (0.0 if zero_first and i == 0 else 1.0) for k in params}
        before = getattr(jstate, field)
        updates, jstate = update({k: jnp.asarray(v) for k, v in
                                  grads.items()}, jstate, jp)
        if patch_nan and np.isnan(getattr(jstate, field)):
            jstate = jstate._replace(**{field: before})
            # Prodigy's update divides by the new estimate: NaN where the
            # port's is 0 (a zero gradient moves nothing)
            updates = jax.tree.map(jnp.nan_to_num, updates)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        opt.step(tp, {k: torch.from_numpy(v.astype(np.float32))
                      for k, v in grads.items()})
    return opt, tp, jp, jstate


def _assert_learned_match(opt, tp, jp, jstate, kind):
    for k in tp:
        ref = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].numpy(), ref, rtol=0,
                                   atol=LEARNED_ATOL * np.abs(ref).max(),
                                   err_msg=k)
    assert opt.estimate is opt.scalars[LEARNED[kind]]
    for field, got in opt.scalars.items():
        want = float(getattr(jstate, field))
        assert float(got) == pytest.approx(want, rel=ESTIMATE_RTOL), field
    count = "count" if "count" in jstate._fields else "step"
    assert opt.count == int(getattr(jstate, count))


@pytest.mark.parametrize("policy", ["lambda", "cos_anneal_warmup"])
@pytest.mark.parametrize("wd", [0.0, 0.05], ids=["nodecay", "decay"])
@pytest.mark.parametrize("kind", sorted(LEARNED))
def test_learned_lr_matches_jax(kind, wd, policy):
    """Parameters and scalar estimates after five updates against JAX's
    `make_optimizer`. DAdam under cos_anneal_warmup (lr 0 at step 0):
    JAX's estimate is NaN after the first update and its parameters NaN
    after the second; the port keeps the previous estimate on that step
    and equals JAX with that estimate put back in its state."""
    fields = dict(optimizer_type=kind, lr=0.5, lr_policy=policy, niter=1,
                  niter_decay=3, weight_decay=wd, decouple=True)
    nan_step = kind == "DAdam" and policy == "cos_anneal_warmup"
    if nan_step:
        _, _, jp, jstate = _learned_run(fields)
        assert np.isnan(float(jstate.estim_lr))
        assert all(np.isnan(np.asarray(v)).all() for v in jp.values())
    opt, tp, jp, jstate = _learned_run(fields, patch_nan=nan_step)
    _assert_learned_match(opt, tp, jp, jstate, kind)
    assert all(torch.isfinite(v).all() for v in tp.values())
    if kind != "Prodigy":
        assert float(opt.estimate) > 1e-6          # d grew


def test_prodigy_d_coef_matches_jax():
    fields = dict(optimizer_type="Prodigy", lr=0.5, lr_policy="lambda",
                  niter=1, niter_decay=3, d_coef=0.3)
    _assert_learned_match(*_learned_run(fields), "Prodigy")


@pytest.mark.parametrize("kind", ["DAdam", "Prodigy"])
def test_zero_denominator_keeps_the_estimate(kind):
    """An all-zero first gradient leaves DAdam's and Prodigy's gradient
    sums zero: optax divides 0 by 0 and its estimate stays NaN (Prodigy's
    parameters too); the port keeps the initial estimate there, moves
    nothing, and then equals optax with the estimate put back (ROADMAP.md
    section 3, differences by design)."""
    fields = dict(optimizer_type=kind, lr=0.5, lr_policy="lambda",
                  niter=1, niter_decay=3)
    opt, tp, jp, jstate = _learned_run(fields, zero_first=True, steps=1)
    assert np.isnan(float(jstate.estim_lr))
    assert float(opt.estimate) == pytest.approx(1e-6)
    start = _tree(np.random.default_rng(1))
    assert all(np.array_equal(tp[k].numpy(), start[k]) for k in tp)
    _assert_learned_match(*_learned_run(fields, zero_first=True,
                                        patch_nan=True), kind)


@pytest.mark.parametrize("kind", sorted(LEARNED))
def test_learned_lr_state_dict_round_trip(kind):
    """Two updates, `state_dict`, a fresh optimizer loads it, three more:
    bit for bit the uninterrupted five; Prodigy's params0 is a copy."""
    cfg = Config(optimizer_type=kind, lr=0.5, lr_policy="cos_anneal_warmup",
                 niter=1, niter_decay=3, weight_decay=0.01, decouple=True)
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [{k: torch.from_numpy(v) for k, v in _tree(rng).items()}
             for _ in range(5)]

    def fresh(tp):
        opt = make_optimizer(cfg, 2)
        opt.init(tp)
        return opt
    ref = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = fresh(ref)
    for g in grads:
        opt.step(ref, g)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    first = fresh(tp)
    if kind == "Prodigy":
        assert all(first.trees["params0"][k].data_ptr() != tp[k].data_ptr()
                   for k in tp)
    for g in grads[:2]:
        first.step(tp, g)
    saved = first.state_dict()
    second = fresh({k: v.clone() for k, v in tp.items()})
    second.load_state_dict(saved)
    for g in grads[2:]:
        second.step(tp, g)
    for k in tp:
        assert torch.equal(tp[k], ref[k]), k
    for field, tree in opt.trees.items():
        for k in tree:
            assert torch.equal(second.trees[field][k], tree[k]), (field, k)
    for field, v in opt.scalars.items():
        assert torch.equal(second.scalars[field], v), field
    assert second.count == 5


def test_dadam_coupled_decay_warns():
    """DAdam with weight decay but not ``decouple`` warns, as JAX does:
    its decay is decoupled either way."""
    with pytest.warns(UserWarning, match="decouple"):
        make_optimizer(Config(optimizer_type="DAdam", weight_decay=0.1), 1)
