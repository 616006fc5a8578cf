"""The port's stage-1 task (egotap_tpu_torch.train.tasks.HeatmapTask)
against the JAX package's `HeatmapTask`, on the joint preset
(`unrealego_heatmap_joint`) at a small size: 16 x 16 heatmaps (64 x 64
stereo RGB, resnet18), batch 2, f32 unless stated.

Each side renders its own targets from the same seeded raw batches
(`make_device_preprocess`), the JAX state is carried into the port by
`compat.from_jax.task_state_from_jax` (weights, running statistics, step
and Adam moments), and both take the same steps. The limb preset is
`tests/test_torch_heatmap_task_limb.py`, which imports the helpers here.

Tolerances, each with its reason:
  * First-step gradients: 1e-4 relative L2 over all parameters (read
    6.1e-6 here, 6.9e-6 on the limb preset). The JAX
    state's biases and BatchNorm affine are drawn non-zero (`randomize`):
    with the reference init's zero biases many ReLU inputs sit exactly on
    the kink, where f32 rounding picks the side. A ReLU input within
    rounding of 0 still takes either side in either framework now and
    then (about one batch in two at this size reads 2e-4 to 7e-3, in the
    port or in JAX, each time against an f64 gradient that agrees with
    the other side); the message of a failure gives both against f64.
  * Losses: rtol 1e-4 at every step (docs/PARITY_TABLE.md; read 3.4e-6).
  * LR 3e-6: stage-1 Adam (eps 1e-8) moves every weight by about lr a
    step whatever its gradient. At the preset's lr 1e-3 the first step
    takes the loss from 2.3 to 2.7e4 (a chaotic trajectory that amplifies
    f32 noise past any tolerance); 1e-4 read 3.4e-4 in the third step's
    loss and 1e-5 read 1.6e-4 in a layer4 running variance.
  * Parameters and running statistics: 1e-4 absolute (PARITY_TABLE;
    read 9.0e-6).
    That budget alone cannot see a fault of the step at this lr, so the
    moves are held too: an entry whose gradient is f32 noise may flip the
    sign of its update (a move up to 2 lr a step away), but at most
    MOVED_OFF of all entries may move more than 0.1 lr away from JAX's
    (read 4.4e-6 of them; 2.5e-4 on another seeded state); a wrong bias
    correction or eps moves every entry by the order of lr.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.core.config import PRESETS as JAX_PRESETS
from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.data.pipeline import make_device_preprocess as jax_preprocess
from egotap_tpu.train.tasks import HeatmapTask as JaxHeatmapTask
from egotap_tpu_torch.compat.from_jax import (heatmap_net_state_dict,
                                              task_state_from_jax)
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.data.pipeline import make_device_preprocess
from egotap_tpu_torch.train.tasks import HeatmapTask, net_gradients
from tests.test_torch_compat import randomize
from tests.test_torch_device_render import raw_batch

GRAD_TOL = 1e-4        # first-step gradients, relative L2
LOSS_RTOL = 1e-4       # per-step losses
STATE_ATOL = 1e-4      # parameters and running statistics
MOVED_OFF = 1e-3       # share of entries whose 3-step move is > 0.1 lr off
LR = 3e-6
IPE = 2                # iterations per epoch ('lambda': lr flat here)
# bf16: XLA's and PyTorch's CPU bf16 convolutions round differently (the
# bf16 heatmap net's outputs differ in most elements, ROADMAP.md section
# 3), and JAX's bf16 upsample rounds its row pass to bf16 where the
# port's rounds once: the losses of one step differ by that (read 3.1e-3)
BF16_LOSS_RTOL = 2e-2


def configs(preset, **kw):
    fields = {**dict(load_size_heatmap=(16, 16), batch_size=2, use_amp=False,
                     lr=LR), **kw}
    return (Config.from_preset(preset, **fields),
            JaxConfig(**{**JAX_PRESETS[preset], **fields}).derive())


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _snapshot(state):
    return jax.tree.map(np.array, state)


@functools.lru_cache(maxsize=None)
def jax_run(preset, steps=4):
    """JAX f32 steps from a seeded state with non-zero biases and
    BatchNorm affine: the state before each step and after the last, each
    step's losses, the first step's gradients, and the raw batches."""
    _, jcfg = configs(preset)
    task = JaxHeatmapTask(jcfg)
    state = task.init_state(jax.random.PRNGKey(0), IPE)
    v = randomize({"params": jax.tree.map(np.asarray, state.params),
                   "batch_stats": jax.tree.map(np.asarray,
                                               state.batch_stats)}, 1)
    params = jax.tree.map(jnp.asarray, v["params"])
    state = state.replace(params=params,
                          batch_stats=jax.tree.map(jnp.asarray,
                                                   v["batch_stats"]),
                          opt_state=task.tx.init(params))
    rng = np.random.default_rng(0)
    raws = [raw_batch(rng) for _ in range(steps)]
    pre = jax_preprocess(jcfg)
    feeds = [pre(to_jax(r)) for r in raws]

    def loss_fn(params, batch):
        out, _ = task.model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            batch["input_rgb"], train=True, mutable=["batch_stats"])
        return sum(task._losses(out.astype(jnp.float32), batch).values())
    grads = jax.jit(jax.grad(loss_fn))(state.params, feeds[0])
    states, losses = [_snapshot(state)], []
    for f in feeds:
        state, loss = task.train_step(state, f)
        losses.append({k: float(v) for k, v in loss.items()})
        states.append(_snapshot(state))
    return task, raws, states, losses, _snapshot(grads)


def port_feeds(cfg, raws):
    pre = make_device_preprocess(cfg)
    return [pre(to_torch(r)) for r in raws]


def _flat(grads, names):
    return torch.cat([grads[n].double().flatten() for n in names])


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def check_first_step_gradients(preset):
    """The port's gradients (every parameter the forward uses) against
    `jax.grad` of the same loss at the same state and batch."""
    _, raws, states, _, jgrads = jax_run(preset)
    cfg, _ = configs(preset)
    task = HeatmapTask(cfg, device="cpu")
    state = task_state_from_jax(states[0], cfg, IPE, device="cpu")
    feed = port_feeds(cfg, raws[:1])[0]
    net64 = copy.deepcopy(state.net).double()
    loss, grads = task.gradients(state, feed)
    names = [n for n, g in grads.items() if g is not None]
    assert not [n for n in names if "fc." in n]      # the unused head
    assert len(names) == len(list(state.net.parameters())) - 2
    want = heatmap_net_state_dict({"params": jgrads,
                                   "batch_stats": states[0].batch_stats})
    feed64 = {k: v.double() for k, v in feed.items()
              if v.is_floating_point()}
    _, g64 = net_gradients(net64, lambda: task._losses(
        net64(feed64["input_rgb"]), feed64))
    got, ref, f64 = (_flat(g, names) for g in (grads, want, g64))
    gap = _rel(got, ref)
    assert gap <= GRAD_TOL, (gap, "port vs f64", _rel(got, f64),
                             "jax vs f64", _rel(ref, f64))
    return loss


def check_losses(loss, ref, rtol=LOSS_RTOL):
    assert sorted(loss) == sorted(ref)
    for k in ref:
        got, want = float(loss[k]), float(ref[k])
        assert abs(got - want) <= rtol * abs(want), (k, got, want)


def check_state(port, ref, start):
    """The port's state against a JAX snapshot ``ref``: step and Adam
    count, parameters and running statistics within STATE_ATOL, and each
    parameter's move from the snapshot ``start`` (see the module's
    docstring)."""
    assert port.step == port.opt.count == int(ref.step)
    want = heatmap_net_state_dict({"params": ref.params,
                                   "batch_stats": ref.batch_stats})
    first = heatmap_net_state_dict({"params": start.params,
                                    "batch_stats": start.batch_stats})
    got = port.net.state_dict()
    params = dict(port.net.named_parameters())
    off = total = 0
    for k, v in want.items():
        if k.endswith("num_batches_tracked") or ".fc." in k:
            continue
        err = float((got[k] - v).abs().max())
        assert err <= STATE_ATOL, (k, err)
        if k in params:
            move_gap = ((got[k] - first[k]) - (v - first[k])).abs()
            off += int((move_gap > 0.1 * LR).sum())
            total += move_gap.numel()
    assert off <= MOVED_OFF * total, off / total
    assert not any(m.training for m in port.net.modules())


def run_port(state, task, feeds, ref_losses):
    for f, ref in zip(feeds, ref_losses):
        state, loss = task.train_step(state, f)
        check_losses(loss, ref)
    return state


def check_trajectory(preset):
    """Three f32 steps from the carried initial state: every loss, then
    the parameters, their moves and the running statistics."""
    _, raws, states, losses, _ = jax_run(preset)
    cfg, _ = configs(preset)
    state = task_state_from_jax(states[0], cfg, IPE, device="cpu")
    state = run_port(state, HeatmapTask(cfg, device="cpu"),
                     port_feeds(cfg, raws[:3]), losses[:3])
    check_state(state, states[3], states[0])


def check_eval_step(preset):
    """f32 eval step (running statistics, the input uncast) on a state
    after training: the heatmaps and the per-sample mse_heatmap."""
    jax_task, raws, states, _, _ = jax_run(preset)
    _, jcfg = configs(preset)
    ref = jax_task.eval_step(jax.tree.map(jnp.asarray, states[3]),
                             jax_preprocess(jcfg)(to_jax(raws[0])))
    cfg, _ = configs(preset)
    state = task_state_from_jax(states[3], cfg, IPE, device="cpu")
    out = HeatmapTask(cfg, device="cpu").eval_step(
        state, port_feeds(cfg, raws[:1])[0])
    pred, want = out["pred_heatmap"].numpy(), np.asarray(ref["pred_heatmap"])
    # f32 convolutions summed in another order (read 2.1e-6 of the max)
    assert np.abs(pred - want).max() <= 1e-5 * np.abs(want).max()
    got = out["metrics"]["mse_heatmap"].numpy()
    want = np.asarray(ref["metrics"]["mse_heatmap"])
    assert got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


PRESET = "unrealego_heatmap_joint"


def test_first_step_gradients_match_jax():
    loss = check_first_step_gradients(PRESET)
    assert sorted(loss) == ["heatmap_left", "heatmap_right"]


def test_trajectory_matches_jax():
    check_trajectory(PRESET)


def test_continuation_matches_jax():
    """Two JAX steps, then the state carried into the port (Adam moments
    and count included) and two more steps on both sides."""
    _, raws, states, losses, _ = jax_run(PRESET)
    cfg, _ = configs(PRESET)
    state = task_state_from_jax(states[2], cfg, IPE, device="cpu")
    assert state.opt.count == 2 and any(float(m.abs().max()) > 0
                                        for m in state.opt.nu.values())
    state = run_port(state, HeatmapTask(cfg, device="cpu"),
                     port_feeds(cfg, raws[2:]), losses[2:])
    check_state(state, states[4], states[2])


def test_bf16_step_matches_jax():
    """One step in bf16 (use_amp: the input cast to bf16, parameters and
    optimizer f32) from the same state: the losses agree to the known
    bf16 differences of the frameworks."""
    jax_task, raws, states, _, _ = jax_run(PRESET)
    cfg, jcfg = configs(PRESET, use_amp=True)
    jtask = JaxHeatmapTask(jcfg)
    jtask.tx = jax_task.tx
    _, ref = jtask.train_step(jax.tree.map(jnp.asarray, states[1]),
                              jax_preprocess(jcfg)(to_jax(raws[1])))
    state = task_state_from_jax(states[1], cfg, IPE, device="cpu")
    _, loss = HeatmapTask(cfg, device="cpu").train_step(
        state, port_feeds(cfg, raws[1:2])[0])
    check_losses(loss, ref, BF16_LOSS_RTOL)
    assert all(p.dtype == torch.float32 for p in state.net.parameters())


def test_eval_step_matches_jax():
    check_eval_step(PRESET)
