"""The port's data parallelism against the JAX package's, on the CPU at a
small size: the per-rank loader plans (`make_host_sharded_loader`), and
data-parallel training and evaluation over
two gloo ranks spawned by ``python -m egotap_tpu_torch.parallel.dryrun``
(a FileStore, one thread a rank): a stage-1 and a stage-2 step against
JAX's 2-device `data_parallel_setup` step (stage 2: the frozen nets'
train-mode BatchNorm under no_grad; its gradient against the port's
single process at the global batch), each with the faulty control of
per-rank BatchNorm statistics, and the test CLI's means over 2 ranks
against 1 rank's.
Budgets: docs/PARITY_TABLE.md (f32 forward 1e-5 of max; "Backward path":
losses rtol 1e-4, parameters and running statistics 1e-4)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.data import pipeline as jax_pipeline
from egotap_tpu.parallel.mesh import data_parallel_setup
from egotap_tpu.train import optim as jax_optim
from egotap_tpu.train import state as jax_state
from egotap_tpu.train.tasks import HeatmapTask as JaxHeatmapTask
from egotap_tpu.train.tasks import LifterTask as JaxLifterTask
from egotap_tpu_torch.cli import test as cli_test
from egotap_tpu_torch.compat.from_jax import (heatmap_net_state_dict,
                                              lifter_state_dict,
                                              task_state_from_jax)
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.data import pipeline
from egotap_tpu_torch.data.synthetic import generate_dataset
from egotap_tpu_torch.native import recordio
from egotap_tpu_torch.train import state as state_lib
from egotap_tpu_torch.train.tasks import LifterTask
from tests.test_torch_compat import heatmap_vars

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120             # seconds, each spawned run
LOSS_RTOL = 1e-4
STATE_ATOL = 1e-4      # parameters and running statistics after a step
GRAD_TOL = 1e-3        # gradients, relative L2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test files run in parallel processes, and
    PyTorch's default of a thread per core in each of them oversubscribes
    the cores (as tests/test_torch_loop.py does)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tmp_path(tmp_path):
    """Removed when the test ends: the runs write checkpoints."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """2 sequences x 5 frames a split (odd shard sizes over 2 ranks)."""
    path = str(tmp_path_factory.mktemp("par"))
    generate_dataset(path, "UnrealEgo", num_sequences=2, frames_per_seq=5,
                     image_size=16)
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _loader_cfgs(root, batch_size):
    fields = dict(data_dir=root, default_data_path="./SyntheticData",
                  model="heatmap_shared", num_heatmap=15, num_rot_heatmap=0,
                  heatmap_type="none", load_size_heatmap=(16, 16),
                  batch_size=batch_size, prefetch_batches=0)
    return Config(**fields).derive(), JaxConfig(**fields).derive()


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("mode,world", [("train", 2), ("test", 2),
                                        ("test", 4)])
def test_loader_plans_match_jax(root, tmp_path, packed, mode, world):
    """Each rank's indices, batch count, masks and rows equal JAX's
    `make_host_sharded_loader(host_index=r, host_count=world)`, on the
    `.npy` frames and on a packed split; a dry rank's extra batches are
    all padding."""
    if packed:
        data = str(tmp_path / "data")
        shutil.copytree(root, data)
    else:
        data = root
    cfg, jcfg = _loader_cfgs(data, world * 2)
    if packed:
        recordio.pack_split(cfg, mode)
    counts = set()
    for r in range(world):
        ours = pipeline.make_loader(cfg, mode, rank=r, world=world)
        ref = jax_pipeline.make_host_sharded_loader(
            jcfg, mode, host_index=r, host_count=world)
        assert type(ours).__name__ == type(ref).__name__
        np.testing.assert_array_equal(ours.indices, ref.indices)
        assert len(ours) == len(ref) > 0
        counts.add(len(ours))
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a["mask"], b["mask"])
            assert list(a["paths"]) == list(b["paths"])
            np.testing.assert_array_equal(a["gt_local_pose"],
                                          b["gt_local_pose"])
    assert len(counts) == 1                   # every rank in lockstep


def test_dry_shard_emits_padding(root):
    cfg, _ = _loader_cfgs(root, 8)
    n = len(pipeline.make_loader(cfg, "test", rank=0, world=1).indices)
    world = n + 1                          # one rank more than frames
    cfg, _ = _loader_cfgs(root, world)
    dry = list(pipeline.make_loader(cfg, "test", rank=n, world=world))
    assert dry and all(b["mask"].sum() == 0 and b["paths"] == []
                       for b in dry)


def _dryrun(out, *args, nproc=2):
    cmd = [sys.executable, "-m", "egotap_tpu_torch.parallel.dryrun",
           "--nproc", str(nproc), "--device", "cpu", "--out", str(out),
           "--timeout", str(WAIT), *args]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=WAIT + 30)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return run.stdout


def _load(out, name, nproc=2):
    return [torch.load(os.path.join(out, name.format(r)), weights_only=True)
            for r in range(nproc)]


def _step_run(tmp_path, cfg_fields, state, feed):
    """The 2-rank step from ``state`` on ``feed`` and its per-rank
    control: {"rank": [rank 0, rank 1], "control": [...]}."""
    state_lib.save_checkpoint(str(tmp_path / "init"), "best", state)
    np.savez(tmp_path / "batch.npz", **feed)
    _dryrun(tmp_path, "--mode", "step", "--config", json.dumps(cfg_fields),
            "--init", str(tmp_path / "init" / "ckpt_best"),
            "--batch", str(tmp_path / "batch.npz"), "--control")
    return {name: _load(tmp_path, name + "{}_0.pt")
            for name in ("rank", "control")}


def _ranks_agree(ranks):
    """Every rank holds the same net and frozen nets, bit for bit."""
    for other in ranks[1:]:
        for key in ("net",):
            for k, v in ranks[0][key].items():
                assert torch.equal(v, other[key][k]), k
        for name, sd in ranks[0]["frozen"].items():
            for k, v in sd.items():
                assert torch.equal(v, other["frozen"][name][k]), (name, k)
        assert ranks[0]["losses"] == other["losses"]


def _close(got, want, atol, keys=None):
    """The largest deviation over ``keys`` of two state_dicts (floating
    tensors only)."""
    worst = 0.0
    for k, v in want.items():
        if (keys is None or keys(k)) and v.is_floating_point():
            worst = max(worst, float((got[k].float() - v).abs().max()))
    return worst <= atol, worst


HEATMAP = dict(model="heatmap_shared", num_heatmap=15, num_rot_heatmap=0,
               heatmap_type="none", load_size_heatmap=(16, 16),
               batch_size=4, lr=1e-4, data_parallel=2)


@pytest.fixture(scope="module")
def heatmap_run(tmp_path_factory):
    """JAX's 2-device data-parallel stage-1 step from a seeded state, and
    its inputs as the port's files."""
    tmp = tmp_path_factory.mktemp("hm")
    hv = heatmap_vars(15, 64, seed=4)
    jcfg = JaxConfig(**HEATMAP).derive()
    params = jax.tree.map(jnp.asarray, hv["params"])
    task = JaxHeatmapTask(jcfg)
    task.tx = jax_optim.make_optimizer(jcfg, 1, stage1=True)
    jstate = jax_state.TrainState(
        step=jnp.asarray(0, jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, hv["batch_stats"]),
        opt_state=task.tx.init(params), frozen={})
    rng = np.random.default_rng(7)
    feed = {"input_rgb": rng.standard_normal((4, 2, 64, 64, 3)),
            "gt_heatmap_left": rng.uniform(0, 1, (4, 16, 16, 15)),
            "gt_heatmap_right": rng.uniform(0, 1, (4, 16, 16, 15))}
    feed = {k: v.astype(np.float32) for k, v in feed.items()}
    port = task_state_from_jax(jstate, Config(**HEATMAP).derive(), 1,
                               device="cpu")
    runs = _step_run(tmp, HEATMAP, port, feed)
    mesh, jstate, shard = data_parallel_setup(jcfg, jstate)
    assert mesh is not None and mesh.shape["data"] == 2
    jstate, losses = task.train_step(jstate, shard(
        {k: jnp.asarray(v) for k, v in feed.items()}))
    want = heatmap_net_state_dict(jax.device_get(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}))
    shutil.rmtree(tmp, ignore_errors=True)
    return runs, {k: float(v) for k, v in losses.items()}, want


@pytest.mark.parametrize("local_bn", [False, True])
def test_two_rank_heatmap_step_matches_jax(heatmap_run, local_bn):
    """Two gloo ranks of 2 rows each against JAX's step over 2 devices:
    losses within LOSS_RTOL, parameters and running statistics within
    STATE_ATOL, every rank the same bit for bit. The faulty control
    (``--control``: statistics per rank) must miss those limits."""
    runs, losses, want = heatmap_run
    ranks = runs["control" if local_bn else "rank"]
    if not local_bn:
        _ranks_agree(ranks)
    got = ranks[0]
    loss_ok = all(abs(got["losses"][k] - v) <= LOSS_RTOL * abs(v)
                  for k, v in losses.items())
    state_ok, worst = _close(got["net"], want, STATE_ATOL)
    if local_bn:
        assert not (loss_ok and state_ok), worst
    else:
        assert loss_ok, (got["losses"], losses)
        assert state_ok, worst


LIFTER = dict(model="egotap_autoencoder", num_heatmap=15, num_rot_heatmap=15,
              heatmap_type="sin", skel_layer="PU", ae_hidden_size=8,
              load_size_heatmap=(16, 16), batch_size=4,
              optimizer_type="AdamW", lr_policy="lambda", lr=1e-4,
              weight_decay=1e-2, niter=10, niter_decay=10,
              lambda_mpjpe=0.1, lambda_cos_sim=-0.01, data_parallel=2)


@pytest.fixture(scope="module")
def lifter_run(tmp_path_factory):
    """A seeded JAX stage-2 state carried into the port
    (`task_state_from_jax`) and a batch of 4; the port's 2-rank step and
    its control from that state, the port's single-process step at the
    global batch (losses and gradients), and JAX's 2-device
    `data_parallel_setup` step (losses, the lifter's state and the frozen
    nets' after it)."""
    tmp = tmp_path_factory.mktemp("lift")
    jcfg = JaxConfig(patched_heatmap_ae=True, **LIFTER).derive()
    task = JaxLifterTask(jcfg)
    jstate = task.init_state(jax.random.PRNGKey(3), 1,
                             heatmap_vars=heatmap_vars(15, 64, seed=5),
                             rot_heatmap_vars=heatmap_vars(30, 64, seed=6))
    cfg = Config(**{**LIFTER, "data_parallel": 0}).derive()
    state = task_state_from_jax(jax.tree.map(np.array, jstate), cfg, 1,
                                device="cpu")
    rng = np.random.default_rng(8)
    feed = {"input_rgb": rng.standard_normal((4, 2, 64, 64, 3)),
            "gt_local_pose": 10 * rng.standard_normal((4, 16, 3))}
    feed = {k: v.astype(np.float32) for k, v in feed.items()}
    runs = _step_run(tmp, LIFTER, state, feed)
    shutil.rmtree(tmp, ignore_errors=True)
    losses, grads = LifterTask(cfg, device="cpu").step_gradients(state,
                                                                 feed)
    mesh, jstate, shard = data_parallel_setup(jcfg, jstate)
    assert mesh is not None and mesh.shape["data"] == 2
    jstate, jlosses = task.train_step(jstate, shard(
        {k: jnp.asarray(v) for k, v in feed.items()}))
    jstate = jax.device_get(jstate)
    want = {"net": lifter_state_dict({"params": jstate.params,
                                      "batch_stats": jstate.batch_stats}),
            "frozen": {k: heatmap_net_state_dict(jstate.frozen[k])
                       for k in state.frozen}}
    assert set(losses) == set(jlosses)
    return runs, {k: float(v) for k, v in jlosses.items()}, grads, want


@pytest.mark.parametrize("local_bn", [False, True])
def test_two_rank_lifter_step_matches_one_process(lifter_run, local_bn):
    """Stage 2 over two gloo ranks against JAX's step over 2 devices:
    losses within LOSS_RTOL, the lifter's parameters and BN statistics
    and the frozen nets' running statistics (train-mode BatchNorm under
    no_grad, over the global batch) within STATE_ATOL, every rank the
    same bit for bit; and the lifter's gradient within GRAD_TOL
    (relative L2) of the port's one process at the global batch. The
    per-rank-statistics control must miss the frozen nets' limit."""
    runs, losses, grads, want = lifter_run
    ranks = runs["control" if local_bn else "rank"]
    got = ranks[0]

    def running(k):
        return k.endswith(("running_mean", "running_var"))
    frozen_ok = all(_close(got["frozen"][name], sd, STATE_ATOL, running)[0]
                    for name, sd in want["frozen"].items())
    if local_bn:
        assert not frozen_ok
        return
    _ranks_agree(ranks)
    assert frozen_ok
    for k, v in losses.items():
        scale = 0.01 * 0.1 * 15 if k == "cos_sim" else abs(v)
        assert abs(got["losses"][k] - v) <= LOSS_RTOL * scale, k
    flat = torch.cat([g.reshape(-1) for g in grads.values()
                      if g is not None])
    mine = torch.cat([got["grads"][k].reshape(-1) for k, g in grads.items()
                      if g is not None])
    assert float((mine - flat).norm() / flat.norm()) <= GRAD_TOL
    ok, worst = _close(got["net"], want["net"], STATE_ATOL,
                       lambda k: not k.endswith("num_batches_tracked"))
    assert ok, worst


def test_two_rank_cli_evaluate_matches_one_rank(root, tmp_path):
    """`cli.train` then `cli.test` over two gloo ranks on the synthetic
    split: one set of files (each summary entry once, the pose dump of
    every test frame), and the two ranks' test means equal one process's
    `cli.test` on the same checkpoint within 1e-6 relative."""
    argv = ["--model", "egotap_autoencoder", "--num_heatmap", "15",
            "--num_rot_heatmap", "15", "--heatmap_type", "sin",
            "--ae_hidden_size", "8", "--load_size_heatmap", "16", "16",
            "--batch_size", "4", "--niter", "1", "--niter_decay", "0",
            "--data_dir", root, "--default_data_path", "./SyntheticData",
            "--log_dir", str(tmp_path / "log"),
            "--result_dir", str(tmp_path / "res"),
            "--experiment_name", "dp", "--save_epoch_freq", "1000000",
            "--data_parallel", "2"]
    _dryrun(tmp_path / "run", "--mode", "cli", "--", *argv)
    ranks = _load(tmp_path / "run", "rank{}.pt")
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    exp = tmp_path / "log" / "dp"
    lines = [json.loads(x) for x in
             open(exp / "summary" / "metrics.jsonl")]
    entries = [(x["tag"], x["step"]) for x in lines]
    assert len(entries) == len(set(entries)) > 0
    n_test = len(pipeline.make_loader(
        Config.from_args(argv), "test", rank=0, world=1).indices)
    res = tmp_path / "res" / "dp"
    assert np.load(res / "pred_pose.npy").shape == (n_test, 16, 3)
    one, _ = cli_test.main(argv[:-2], device="cpu")
    for k, v in one.items():
        assert abs(ranks[0]["metrics"][k] - v) <= 1e-6 * abs(v), k


def test_dryrun_multichip_twin(tmp_path):
    """The twin of `__graft_entry__.py:dryrun_multichip` over two gloo
    ranks: a stage-2 training step and an eval step of the flagship
    configuration at a tiny size, each rank on its shard, then the
    tensor-parallel Predictor over ``["cpu"] * 2``; then, in the same
    ranks, the probe of the raw collectives."""
    out = _dryrun(tmp_path, "--mode", "dryrun", "probe")
    assert "dryrun rank 0/2 ok" in out and "serving_dp1xtp2" in out
    probe = json.loads(out.split("probe gloo on cpu: ")[1].splitlines()[0])
    assert set(probe.values()) == {"ok"} and len(probe) == 6


class _OtherRank:
    """A stand-in process group whose other rank holds ``other``."""

    def __init__(self, other):
        self.other = other

    def max_(self, tensors):
        for t, o in zip(tensors, self.other):
            t.copy_(torch.maximum(t, o))


def test_calibrated_scales_take_the_max_over_ranks():
    """`evaluate` syncs each static int8 activation scale of the
    inference nets to its max over the ranks (JAX
    `_sync_calibrated_scales`), in module order, and leaves modules
    without a static scale alone."""
    from egotap_tpu_torch.eval.evaluate import sync_calibrated_scales
    from egotap_tpu_torch.ops.quant import QDense
    nets = [torch.nn.Sequential(QDense(4, 4), QDense(4, 4), QDense(4, 4))]
    nets[0][0].a_scale = torch.tensor(0.5)
    nets[0][2].a_scale = torch.tensor(0.25)
    sync_calibrated_scales(nets, _OtherRank([torch.tensor(0.75),
                                             torch.tensor(0.125)]))
    assert float(nets[0][0].a_scale) == 0.75
    assert nets[0][1].a_scale is None
    assert float(nets[0][2].a_scale) == 0.25
