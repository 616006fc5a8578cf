"""The port's stage-2 task (egotap_tpu_torch.train.tasks.LifterTask)
against the JAX package's `LifterTask`, at a small size: UnrealEgo with
15 heatmaps of 16 x 16 (64 x 64 stereo RGB, resnet18 frozen nets), the
full-width Grid-ViT (1024 x 3 layers) over 36 tokens, hidden 8 (PU
hidden 32), batch 2, AdamW with decoupled decay under cos_anneal_warmup;
and the LSTM tree walk under Prodigy.

The JAX state is carried into the port by `compat.from_jax.
task_state_from_jax` (weights, running statistics, step and Adam
moments), and both sides take the same steps on the same seeded batches
with the frozen nets running (train-mode BatchNorm, per-view
statistics). Budgets: docs/PARITY_TABLE.md, "Backward path".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.train.tasks import LifterTask as JaxLifterTask
from egotap_tpu_torch.compat.from_jax import (heatmap_net_state_dict,
                                              lifter_state_dict,
                                              task_state_from_jax)
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.serving import Predictor
from egotap_tpu_torch.train.tasks import LifterTask
from tests.test_torch_compat import heatmap_vars

LOSS_RTOL = 1e-4       # per-step losses (PARITY_TABLE "Backward path")
# cos_sim is a sum of 15 bone cosines, which at random weights cancels to
# a small fraction of its range (a sum of 0.57 read 2.9e-4 relative, from
# f32 pose noise of 2e-6 of max|pose| on 0.4 cm bones): its rtol is taken
# against the largest value the term can have, |lambda| x 15 bones
LOSS_SCALE = {"pose": None, "cos_sim": 0.01 * 0.1 * 15}
STATE_ATOL = 1e-4      # params, lifter BN stats, frozen nets' running stats
# bf16: the port keeps the PU state and the attention scores in f32 where
# the JAX CPU path rounds them to bf16 (ROADMAP.md section 3, "bf16 PU
# chain" and "bf16 attention"); the losses of one step differ by that
BF16_LOSS_RTOL = 3e-2
IPE = 2                # iterations per epoch: lr 0, then warm up, then cosine
# Adam moves a parameter by up to lr a step whatever the size of its
# gradient, so f32 noise in a near-zero gradient becomes a parameter error
# of a sizeable share of lr: 3e-6 of noise in the heatmap stack (the
# frozen nets' f32 difference) flips leaky-ReLU kinks and moves the
# lifter's gradient by up to 4e-3 of its max, port against port. With lr
# 1e-3 three steps read 2.0e-4 in fc2's weight; lr 1e-4 keeps them within
# the budgets, and a fault of the step's semantics still moves parameters
# by the order of lr a step.
LR = 1e-4
# Prodigy's estim_lr and numerator_weighted after three steps: sums over
# every parameter of gradient x parameter moves, with optax's f32 bias
# correction (tests/test_torch_optim.py)
PRODIGY_RTOL = 1e-3
FIELDS = dict(model="egotap_autoencoder", num_heatmap=15,
              num_rot_heatmap=15, heatmap_type="sin", skel_layer="PU",
              ae_hidden_size=8, load_size_heatmap=(16, 16), batch_size=2,
              optimizer_type="AdamW", lr_policy="cos_anneal_warmup",
              lr=LR, weight_decay=1e-2, niter=1, niter_decay=2,
              lambda_mpjpe=0.1, lambda_cos_sim=-0.01)


def _configs(**kw):
    fields = {**FIELDS, **kw}
    return (Config(**fields).derive(),
            JaxConfig(patched_heatmap_ae=True, **fields).derive())


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_rgb": rng.standard_normal((2, 2, 64, 64, 3)).astype(
                np.float32),
             "gt_local_pose": (10 * rng.standard_normal((2, 16, 3))).astype(
                np.float32)} for _ in range(n)]


def _snapshot(state):
    return jax.tree.map(np.array, state)


@pytest.fixture(scope="module")
def jax_run():
    """Four JAX f32 steps from a seeded state: the state before each
    step and after the last, and each step's losses."""
    _, jcfg = _configs()
    task = JaxLifterTask(jcfg)
    state = task.init_state(jax.random.PRNGKey(0), IPE,
                            heatmap_vars=heatmap_vars(15, 64),
                            rot_heatmap_vars=heatmap_vars(30, 64))
    batches = _batches(4)
    states, losses = [_snapshot(state)], []
    for b in batches:
        state, loss = task.train_step(
            state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append({k: float(v) for k, v in loss.items()})
        states.append(_snapshot(state))
    return task, batches, states, losses


def _check_state(port, ref):
    """The port's state against a JAX state snapshot."""
    assert port.step == int(ref.step)
    assert port.opt.count == int(ref.step)
    want = lifter_state_dict({"params": ref.params,
                              "batch_stats": ref.batch_stats})
    got = port.net.state_dict()
    for k, v in want.items():
        if not k.endswith("num_batches_tracked"):
            err = float((got[k].float() - v).abs().max())
            assert err <= STATE_ATOL, (k, err)
    for key, net in port.frozen.items():
        want = heatmap_net_state_dict(ref.frozen[key])
        got = net.state_dict()
        for k, v in want.items():
            if k.endswith(("running_mean", "running_var")):
                err = float((got[k] - v).abs().max())
                assert err <= STATE_ATOL, (key, k, err)
            elif not k.endswith("num_batches_tracked"):   # never trained
                assert torch.equal(got[k], v), (key, k)


def _check_losses(loss, ref, rtol=LOSS_RTOL):
    assert sorted(loss) == sorted(ref)
    for k in ref:
        got, want = float(loss[k]), float(ref[k])
        scale = LOSS_SCALE[k] or abs(want)
        assert abs(got - want) <= rtol * scale, (k, got, want)


def _run_port(state, task, batches, ref_losses):
    for b, ref in zip(batches, ref_losses):
        state, loss = task.train_step(state, b)
        _check_losses(loss, ref)
    return state


def test_trajectory_matches_jax(jax_run):
    """Three f32 steps from the carried initial state: every loss, then
    the lifter's parameters and BN statistics, the frozen nets' running
    statistics (and their untouched parameters)."""
    _, batches, states, losses = jax_run
    cfg, _ = _configs()
    state = task_state_from_jax(states[0], cfg, IPE, device="cpu")
    frozen0 = {k: {n: t.clone() for n, t in net.state_dict().items()}
               for k, net in state.frozen.items()}
    state = _run_port(state, LifterTask(cfg, device="cpu"), batches[:3],
                      losses[:3])
    _check_state(state, states[3])
    moved = [n for n, t in state.frozen["heatmap"].state_dict().items()
             if n.endswith("running_mean")
             and not torch.equal(t, frozen0["heatmap"][n])]
    assert moved                      # the frozen nets' statistics evolve
    assert not any(m.training for net in (state.net, *state.frozen.values())
                   for m in net.modules())


def test_continuation_matches_jax(jax_run):
    """Two JAX steps, then the state carried into the port (Adam moments
    and count included) and two more steps on both sides."""
    _, batches, states, losses = jax_run
    cfg, _ = _configs()
    state = task_state_from_jax(states[2], cfg, IPE, device="cpu")
    assert state.opt.count == 2 and any(m.abs().max() > 0
                                        for m in state.opt.nu.values())
    state = _run_port(state, LifterTask(cfg, device="cpu"), batches[2:],
                      losses[2:])
    _check_state(state, states[4])


def test_lstm_prodigy_trajectory_matches_jax():
    """skel_layer "LSTM" (the Config default: the tree walk) under
    Prodigy: three f32 steps from a JAX state carried by
    `task_state_from_jax` (the LSTM weights and Prodigy's fields), every
    loss, then the state and Prodigy's scalars (PRODIGY_RTOL)."""
    cfg, jcfg = _configs(skel_layer="LSTM", optimizer_type="Prodigy",
                         d_coef=2.0)
    task = JaxLifterTask(jcfg)
    state = task.init_state(jax.random.PRNGKey(1), IPE,
                            heatmap_vars=heatmap_vars(15, 64),
                            rot_heatmap_vars=heatmap_vars(30, 64))
    batches = _batches(3, seed=2)
    port = task_state_from_jax(_snapshot(state), cfg, IPE, device="cpu")
    assert torch.equal(port.opt.trees["params0"][
        "skel_sequential_layer.lstm.weight_hh_l1"],
        port.net.skel_sequential_layer["lstm"].weight_hh_l1)
    port_task = LifterTask(cfg, device="cpu")
    for b in batches:
        state, ref = task.train_step(
            state, {k: jnp.asarray(v) for k, v in b.items()})
        port, loss = port_task.train_step(port, b)
        _check_losses(loss, ref)
    _check_state(port, _snapshot(state))
    for field, got in port.opt.scalars.items():
        want = float(getattr(state.opt_state, field))
        assert float(got) == pytest.approx(want, rel=PRODIGY_RTOL), field


def test_bf16_step_matches_jax(jax_run):
    """One step in bf16 (use_amp) from the same state: the losses agree
    to the known bf16 difference of the PU chain and the attention."""
    jax_task, batches, states, _ = jax_run
    cfg, jcfg = _configs(use_amp=True)
    jtask = JaxLifterTask(jcfg)
    jtask.tx = jax_task.tx
    _, ref = jtask.train_step(jax.tree.map(jnp.asarray, states[1]),
                              {k: jnp.asarray(v) for k, v in
                               batches[1].items()})
    state = task_state_from_jax(states[1], cfg, IPE, device="cpu")
    _, loss = LifterTask(cfg, device="cpu").train_step(state, batches[1])
    _check_losses(loss, ref, BF16_LOSS_RTOL)


def test_eval_step_matches_jax(jax_run):
    """f32 eval step (running statistics) on a state after training:
    pose and per-sample metrics."""
    jax_task, batches, states, _ = jax_run
    ref = jax_task.eval_step(jax.tree.map(jnp.asarray, states[3]),
                             {k: jnp.asarray(v) for k, v in
                              batches[0].items()})
    cfg, _ = _configs()
    state = task_state_from_jax(states[3], cfg, IPE, device="cpu")
    out = LifterTask(cfg, device="cpu").eval_step(state, batches[0])
    pose, want = out["pred_pose"].numpy(), np.asarray(ref["pred_pose"])
    assert np.abs(pose - want).max() <= 1e-5 * np.abs(want).max()
    for k, rtol in (("mpjpe", 1e-5), ("pa_mpjpe", 1e-4)):
        got, want = out["metrics"][k].numpy(), np.asarray(ref["metrics"][k])
        assert np.abs(got - want).max() <= rtol * np.abs(want).max(), k


def test_gt_heatmap_step_matches_jax(jax_run):
    """use_gt_heatmap: the lifter reads the ground-truth heatmaps and the
    frozen nets do not run (their statistics stay)."""
    jax_task, _, states, _ = jax_run
    cfg, jcfg = _configs(use_gt_heatmap=True)
    rng = np.random.default_rng(7)
    batch = {f"gt_{kind}_{side}": rng.uniform(0, 1, (2, 16, 16, n)).astype(
                np.float32)
             for kind, n in (("heatmap", 15), ("limb_heatmap", 30))
             for side in ("left", "right")}
    batch["gt_local_pose"] = _batches(1)[0]["gt_local_pose"]
    jtask = JaxLifterTask(jcfg)
    jtask.tx = jax_task.tx
    _, ref = jtask.train_step(jax.tree.map(jnp.asarray, states[1]),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    state = task_state_from_jax(states[1], cfg, IPE, device="cpu")
    stats = state.frozen["heatmap"].state_dict()
    _, loss = LifterTask(cfg, device="cpu").train_step(state, batch)
    _check_losses(loss, ref)
    for k, v in state.frozen["heatmap"].state_dict().items():
        assert torch.equal(v, stats[k]), k


def test_int8_eval_step_is_the_predictor_forward():
    """prepare_inference builds the int8 twins on the `Predictor`'s
    machinery and calibrates them; the eval step's pose equals the
    forward of a `Predictor` holding the same weights and scales, bit for
    bit, and the trainable state is left as it was."""
    cfg, _ = _configs(use_amp=True, int8_heatmap_inference=True,
                      int8_lifter_inference=True)
    task = LifterTask(cfg, device="cpu")
    state = task.init_state(seed=3, iters_per_epoch=IPE)
    before = {k: v.clone() for k, v in state.net.state_dict().items()}
    batch = _batches(1, seed=4)[0]
    calib = [{"input_rgb": b["input_rgb"] + 0.1} for b in _batches(2, 5)]
    prepared = task.prepare_inference(state, calib)
    assert prepared.inference._has_static_scales()
    out = task.eval_step(prepared, batch)
    pred = Predictor(cfg, state.frozen["heatmap"].state_dict(),
                     state.frozen["rot_heatmap"].state_dict(),
                     state.net.state_dict(), bf16=True, device="cpu")
    copied = 0
    for net, twin in zip(pred.nets, prepared.inference.nets):
        mods = dict(net.named_modules())
        for name, m in twin.named_modules():
            if getattr(m, "a_scale", None) is not None:
                mods[name].a_scale = m.a_scale.clone()
                copied += 1
    assert copied
    want = torch.from_numpy(pred(batch["input_rgb"]))
    assert torch.equal(out["pred_pose"], want)
    assert out["metrics"]["mpjpe"].shape == (2,)
    assert state.inference is None
    for k, v in state.net.state_dict().items():
        assert torch.equal(v, before[k]), k
