"""The port's training loop and CLIs (egotap_tpu_torch.train.loop,
egotap_tpu_torch.cli) on the CPU, at a small size (16 x 16 maps, 64-px
RGB, batch 4, a lifter of hidden 8), held to the assertions of the JAX
package's tests/test_train_loop.py and tests/test_watchdogs.py: the
artifacts and the removal of the previous epoch's checkpoint, the
`epoch_callback` early stop, the NaN abort and ``auto_terminate``, the
watchdog at lr 0; and beyond them the restart of an epoch after a NaN,
the resume from ``epoch_count``, ``data_parallel > 1`` refused in one
process, the profiler trace, the summary rotation, and the two-stage CLI
flow (joint, limb, lifter warm-started from both ``ckpt_best``, then
`cli.test`)."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from egotap_tpu_torch.cli import test as cli_test
from egotap_tpu_torch.cli import train as cli_train
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.data.synthetic import generate_dataset, synthetic_config
from egotap_tpu_torch.train import loop
from egotap_tpu_torch.train import state as state_lib
from egotap_tpu_torch.train.tasks import create_task
from egotap_tpu_torch.utils.profiling import TRACE_FILE


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test files run in parallel processes, and
    PyTorch's default of a thread per core in each of them oversubscribes
    the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# a checkpoint of these nets holds some 0.4-0.8 GB (parameters and Adam
# moments): each test's directory is removed when it ends, and runs that
# check no epoch checkpoint save none
QUIET = dict(save_epoch_freq=10 ** 6)


@pytest.fixture
def tmp_path(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """2 sequences x 5 frames a split: 2 training steps an epoch at batch
    4, eval batches padded."""
    path = str(tmp_path_factory.mktemp("loop"))
    generate_dataset(path, "UnrealEgo", num_sequences=2, frames_per_seq=5,
                     image_size=16)
    yield path
    shutil.rmtree(path, ignore_errors=True)


@pytest.fixture(scope="module")
def root8(tmp_path_factory):
    """1 sequence x 8 frames a split (JAX's watchdog fixture)."""
    path = str(tmp_path_factory.mktemp("wd"))
    generate_dataset(path, "UnrealEgo", num_sequences=1, frames_per_seq=8,
                     image_size=16)
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _cfg(root, tmp_path, **kw):
    base = dict(model="heatmap_shared", num_heatmap=15, num_rot_heatmap=0,
                heatmap_type="none", load_size_heatmap=(16, 16),
                batch_size=4, niter=1, niter_decay=1, lr=1e-4,
                log_dir=str(tmp_path / "log"),
                result_dir=str(tmp_path / "results"))
    base.update(kw)
    return synthetic_config(root, **base)


def test_train_main_heatmap(root, tmp_path):
    cfg = _cfg(root, tmp_path, experiment_name="smoke")
    assert loop.train_main(cfg, device="cpu") is True
    exp = cfg.experiment_dir
    for name in ("train_opt.txt", "train_opt.json", "test_result.txt",
                 os.path.join("summary", "metrics.jsonl")):
        assert os.path.exists(os.path.join(exp, name)), name
    assert state_lib.checkpoint_exists(exp, "best")
    assert state_lib.checkpoint_exists(exp, 2)
    assert not state_lib.checkpoint_exists(exp, 1)   # removed at epoch 2
    result = open(os.path.join(exp, "test_result.txt")).read()
    assert result.startswith("mse_heatmap: ")
    assert "category: 001_jumping\n" in result
    assert "category: 002_falling_down\n" in result
    tags = [json.loads(line)["tag"] for line in
            open(os.path.join(exp, "summary", "metrics.jsonl"))]
    assert tags.count("Batch/heatmap_left") == 4
    for part in ("epoch_s", "loop_s", "loader_wait_s", "val_s", "ckpt_s"):
        assert tags.count(f"Time/{part}") == 2, part
    times = {}
    for line in open(os.path.join(exp, "summary", "metrics.jsonl")):
        rec = json.loads(line)
        if rec["tag"].startswith("Time/"):
            times.setdefault(rec["step"], {})[rec["tag"][5:]] = rec["value"]
    for t in times.values():   # the epoch's span holds its parts
        assert t["loader_wait_s"] <= t["loop_s"]
        assert t["ckpt_s"] > 0 and t["val_s"] > 0
        assert t["loop_s"] + t["val_s"] + t["ckpt_s"] <= t["epoch_s"]
    assert "Validation/mse_heatmap" in tags
    assert state_lib.read_checkpoint(os.path.join(exp, "ckpt_2"))["step"] == 4


def test_epoch_callback_reports_and_early_stops(root, tmp_path):
    """External-tuner hook: per-epoch reports with metrics, a checkpoint
    path and the live state; a truthy return stops cleanly after that
    epoch."""
    cfg = _cfg(root, tmp_path, niter=2, niter_decay=2,
               experiment_name="tuner")
    reports = []

    def fake_tuner(report):
        reports.append(report)
        return report["epoch"] >= 2   # stop after epoch 2 of 4

    assert loop.train_main(cfg, epoch_callback=fake_tuner,
                           device="cpu") is True
    assert [r["epoch"] for r in reports] == [1, 2]
    for r in reports:
        assert r["bad_loss"] is False
        assert "mse_heatmap" in r["val_metrics"]
        assert r["train_losses"]
        assert r["checkpoint_path"]
    assert reports[0]["state"] is reports[1]["state"]
    assert os.path.isdir(reports[-1]["checkpoint_path"])
    # early stop still runs the final best-model test
    assert os.path.exists(os.path.join(cfg.experiment_dir, "test_result.txt"))
    assert not state_lib.checkpoint_exists(cfg.experiment_dir, 3)


def test_nan_at_epoch_one_aborts_and_tags_checkpoint(root8, tmp_path):
    # lr huge enough to overflow f32 within the first epoch
    cfg = _cfg(root8, tmp_path, niter=1, niter_decay=0, lr=1e30,
               experiment_name="nan_run", auto_terminate=False)
    assert loop.train_main(cfg, device="cpu") is False   # asks to restart
    assert (state_lib.checkpoint_exists(cfg.experiment_dir, "nan")
            or state_lib.checkpoint_exists(cfg.experiment_dir, "inf"))


def test_nan_with_auto_terminate(root8, tmp_path):
    cfg = _cfg(root8, tmp_path, niter=1, niter_decay=0, lr=1e30,
               experiment_name="nan_term", auto_terminate=True)
    assert loop.train_main(cfg, device="cpu") is True    # terminates


def test_early_convergence_watchdog(root8, tmp_path):
    # lr=0 and exactly one batch an epoch: the loss is exactly constant,
    # so the no-improvement window elapses and a restart is requested
    cfg = _cfg(root8, tmp_path, batch_size=8, niter=30, niter_decay=0,
               lr=0.0, experiment_name="stall", auto_restart=True,
               val_epoch_freq=10 ** 6, save_epoch_freq=10 ** 6,
               print_epoch_freq=10 ** 6,
               watchdog_check_iters=100, watchdog_stall_iters=10)
    assert loop.train_main(cfg, device="cpu") is False


def test_nan_in_a_later_epoch_restarts_it(root, tmp_path, monkeypatch):
    """A NaN loss at epoch 2 tags a checkpoint, reloads epoch 1's and
    runs epoch 2 again (loss_sync_every 2: the losses are read back in
    pairs); the tuner hears of it."""
    calls = []
    real = loop.create_task

    def nan_once(cfg, device):
        task = real(cfg, device)
        step = task.train_step

        def train_step(state, batch):
            state, losses = step(state, batch)
            calls.append(state.step)
            if len(calls) == 3:                  # epoch 2, first step
                losses = {k: v * float("nan") for k, v in losses.items()}
            return state, losses
        task.train_step = train_step
        return task

    monkeypatch.setattr(loop, "create_task", nan_once)
    cfg = _cfg(root, tmp_path, experiment_name="nan2", loss_sync_every=2)
    reports = []
    assert loop.train_main(cfg, epoch_callback=reports.append,
                           device="cpu") is True
    assert state_lib.checkpoint_exists(cfg.experiment_dir, "nan")
    # steps 3 and 4 ran, then epoch 2 again from epoch 1's step count
    assert calls == [1, 2, 3, 4, 3, 4]
    assert [(r["epoch"], r["bad_loss"]) for r in reports] == \
        [(1, False), (2, True), (2, False)]
    assert state_lib.read_checkpoint(
        os.path.join(cfg.experiment_dir, "ckpt_2"))["step"] == 4


def test_resume_from_epoch_count(root, tmp_path):
    """A run that stopped after epoch 1 resumes at epoch 2 from
    ``ckpt_1``: the state (step 2) is loaded and the summary kept."""
    kw = dict(experiment_name="resume", niter=1, niter_decay=0)
    assert loop.train_main(_cfg(root, tmp_path, **kw), device="cpu")
    cfg = _cfg(root, tmp_path, **{**kw, "niter_decay": 1, "epoch_count": 2})
    first = []
    loop.train_main(cfg, device="cpu", epoch_callback=lambda r: first.append(
        r["state"].step))
    assert first == [4]                           # 2 loaded + 2 trained
    tags = [json.loads(line)["tag"] for line in open(os.path.join(
        cfg.experiment_dir, "summary", "metrics.jsonl"))]
    assert tags.count("Time/epoch_s") == 2        # both runs' epochs


def test_data_parallel_is_refused(root, tmp_path):
    """data_parallel > 1 in one process (not launched by torchrun) is
    refused."""
    cfg = _cfg(root, tmp_path, data_parallel=2)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        loop.train_main(cfg, device="cpu")


def test_profile_trace_and_summary_rotation(root8, tmp_path):
    """``profile_dir`` writes a Chrome trace holding the traced step's
    ``egotap.train.step`` range, its step number as the range's argument
    ``root``, and its phases; a second run over a finished one rotates its
    summary and test result to ``_0``."""
    prof = str(tmp_path / "prof")
    kw = dict(batch_size=2, niter=1, niter_decay=0, experiment_name="prof",
              val_epoch_freq=10 ** 6, **QUIET)
    cfg = _cfg(root8, tmp_path, profile_dir=prof, profile_steps=0, **kw)
    assert loop.train_main(cfg, device="cpu")
    with open(os.path.join(prof, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    steps = [e for e in ranges if e["name"] == "egotap.train.step"]
    assert [e["args"]["root"] for e in steps] == [2]
    assert {"egotap.train.net_forward", "egotap.train.backward",
            "egotap.train.optimizer"} <= {
        e["name"] for e in ranges if e["args"].get("root") == 2}
    assert loop.train_main(_cfg(root8, tmp_path, **kw), device="cpu")
    for name in ("summary_0", "test_result_0.txt", "summary",
                 "test_result.txt"):
        assert os.path.exists(os.path.join(cfg.experiment_dir, name)), name


def _same(got, want):
    """Names of the entries of two state_dicts that differ."""
    assert sorted(got) == sorted(want)
    return [k for k in want if not torch.equal(got[k].cpu(), want[k])]


def test_two_stage_cli_flow(root, tmp_path):
    """joint, then limb, then the lifter warm-started from both stage-1
    ``ckpt_best`` through the preset's own path_to_trained_heatmap, then
    `cli.test`: the artifacts, and the lifter's frozen nets at init equal
    to the stage-1 nets bit for bit (their parameters also after
    training; their running statistics move in train-mode BN)."""
    common = ["--data_dir", root, "--default_data_path", "./SyntheticData",
              "--load_size_heatmap", "16", "16", "--batch_size", "4",
              "--niter", "1", "--niter_decay", "1",
              "--save_epoch_freq", str(QUIET["save_epoch_freq"]),
              "--log_dir", str(tmp_path / "log"),
              "--result_dir", str(tmp_path / "results")]
    stage2 = ["--preset", "egotap_unrealego", "--ae_hidden_size", "8"] + common
    for preset in ("unrealego_heatmap_joint", "unrealego_heatmap_limb"):
        cli_train.main(["--preset", preset] + common, device="cpu")
    best = {}
    for key, exp in (("heatmap", "unrealego_heatmap_shared_pos"),
                     ("rot_heatmap", "unrealego_heatmap_shared_sin")):
        best[key] = state_lib.read_checkpoint(
            str(tmp_path / "log" / exp / "ckpt_best"))["net"]

    cfg = Config.from_args(stage2)
    init = loop._init_task_state(cfg, create_task(cfg, device="cpu"), 1)
    for key, net in init.frozen.items():
        assert _same(net.state_dict(), best[key]) == []
    faulty = {k: v.clone() for k, v in best["heatmap"].items()}
    name = next(k for k in faulty if k.endswith("conv1.weight"))
    faulty[name].view(-1)[0] += 1e-3
    assert _same(init.frozen["heatmap"].state_dict(), faulty) == [name]

    states = []
    cli_train.main(stage2, device="cpu",
                   epoch_callback=lambda r: states.append(r["state"]))
    final = states[-1]
    for key, net in final.frozen.items():
        params = dict(net.named_parameters())
        assert _same({k: params[k] for k in params},
                     {k: best[key][k] for k in params}) == []
    assert all(t.device.type == "cpu" for t in final.net.state_dict().values())

    cli_test.main(stage2, device="cpu")
    results = tmp_path / "results" / "egotap_unrealego"
    detail = (results / "detail_result.txt").read_text().splitlines()
    assert detail[0] == "mpjpe pa_mpjpe " and len(detail) == 11
    cats = (results / "categorical_result.txt").read_text().splitlines()
    assert [c.split()[:3] for c in cats[2:]] == [
        ["001", "jumping", "2"], ["002", "falling_down", "2"]]
    pose = np.load(results / "pred_pose.npy")
    assert pose.shape == (10, 16, 3) and np.isfinite(pose).all()
    assert os.path.exists(tmp_path / "log" / "egotap_unrealego" /
                          "test_opt.txt")


def test_cli_test_fails_fast_without_best(root, tmp_path):
    with pytest.raises(SystemExit, match="no 'best' checkpoint"):
        cli_test.main(["--preset", "egotap_unrealego", "--data_dir", root,
                       "--log_dir", str(tmp_path / "log"),
                       "--result_dir", str(tmp_path / "results")],
                      device="cpu")
