"""Checkpoint I/O of the port (egotap_tpu_torch.train.state) for both
tasks, at a small size (16 x 16 maps, 64-px RGB, batch 4, a lifter of
hidden 8): a round trip bit for bit (parameters, BatchNorm statistics,
frozen nets, step, the optimizer's count and state: Adam's moments, or
DAdam's and Prodigy's fields and estimates with an LSTM lifter),
restoring into the live
modules, ``restore_opt_state=False``, the removal of the previous epoch,
a continuation (2 steps, save, load into a fresh state, 2 steps) equal
to 4 steps bit for bit, and the stage-1 warm start from a checkpoint
directory."""

import os
import shutil

import pytest
import torch
from torch import nn

from egotap_tpu_torch.data.pipeline import make_device_preprocess, make_loader
from egotap_tpu_torch.data.synthetic import generate_dataset, synthetic_config
from egotap_tpu_torch.eval.evaluate import to_device
from egotap_tpu_torch.train import state as state_lib
from egotap_tpu_torch.train.optim import Optimizer
from egotap_tpu_torch.train.tasks import create_task, load_heatmap_state


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test files run in parallel processes, and
    PyTorch's default of a thread per core in each of them oversubscribes
    the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PRESETS = {
    "heatmap": dict(model="heatmap_shared", num_heatmap=15,
                    num_rot_heatmap=0, heatmap_type="none", lr=1e-4),
    "lifter": dict(model="egotap_autoencoder", num_heatmap=15,
                   num_rot_heatmap=15, heatmap_type="sin", skel_layer="PU",
                   ae_hidden_size=8, optimizer_type="AdamW",
                   lr_policy="cos_anneal_warmup", niter=1, niter_decay=2,
                   weight_decay=1e-2, lr=1e-4),
}
# the learned-LR optimizers, with the LSTM walks
for _name, _fields in (("DAdam", dict(skel_layer="LSTM", decouple=True)),
                       ("Prodigy", dict(skel_layer="LSTMSplit"))):
    PRESETS[f"lifter_{_name.lower()}"] = {**PRESETS["lifter"], **_fields,
                                          "optimizer_type": _name}


@pytest.fixture
def tmp_path(tmp_path):
    """Removed when the test ends: a checkpoint of these nets holds some
    0.4-0.8 GB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt_data"))
    generate_dataset(path, "UnrealEgo", num_sequences=1, frames_per_seq=8,
                     image_size=16)
    yield path
    shutil.rmtree(path, ignore_errors=True)


def _setup(root, kind, seed=0):
    cfg = synthetic_config(root, load_size_heatmap=(16, 16), batch_size=4,
                           seed=seed, **PRESETS[kind])
    task = create_task(cfg, device="cpu")
    loader = make_loader(cfg, "train")
    pre = make_device_preprocess(cfg)
    feeds = [pre(to_device(b, task.device)) for b in loader]
    return task, task.init_state(seed, len(loader)), feeds * 2


def _tensors(state):
    """Every tensor of a state by a flat name, and the step and count."""
    out = {f"net.{k}": v for k, v in state.net.state_dict().items()}
    for key, net in state.frozen.items():
        out.update({f"{key}.{k}": v for k, v in net.state_dict().items()})
    for name, tree in state.opt.trees.items():
        out.update({f"opt.{name}.{k}": v for k, v in tree.items()})
    out.update({f"opt.{k}": v for k, v in state.opt.scalars.items()})
    return out, (state.step, state.opt.count)


def _assert_same(a, b):
    (ta, sa), (tb, sb) = _tensors(a), _tensors(b)
    assert sa == sb and sorted(ta) == sorted(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("kind", ["heatmap", "lifter", "lifter_dadam",
                                  "lifter_prodigy"])
def test_round_trip_and_continuation(root, kind, tmp_path):
    task, state, feeds = _setup(root, kind)
    for feed in feeds[:2]:
        state, _ = task.train_step(state, feed)
    exp = str(tmp_path)
    state_lib.save_checkpoint(exp, "best", state)
    assert state_lib.checkpoint_exists(exp, "best")
    saved = state_lib.read_checkpoint(os.path.join(exp, "ckpt_best"))
    assert sorted(saved) == ["frozen", "net", "opt", "step"]

    # a fresh state from another seed, restored in place
    _, fresh, _ = _setup(root, kind, seed=1)
    params = {n: p for n, p in fresh.net.named_parameters()}
    trees = {f: dict(t) for f, t in fresh.opt.trees.items()}
    loaded = state_lib.load_checkpoint(exp, "best", fresh)
    assert loaded is fresh
    _assert_same(loaded, state)
    second = "nu" if "nu" in state.opt.trees else "exp_avg_sq"
    assert state.opt.count == 2 and any(
        float(m.abs().max()) > 0 for m in state.opt.trees[second].values())
    for n, p in loaded.net.named_parameters():
        assert p is params[n]               # the live parameters, updated
    assert all(loaded.opt.trees[f][n] is t[n] for f, t in trees.items()
               for n in t)

    # two more steps on both: the continuation equals 4 straight steps
    for feed in feeds[2:4]:
        state, ref_loss = task.train_step(state, feed)
        loaded, loss = task.train_step(loaded, feed)
        for k in ref_loss:
            assert torch.equal(loss[k], ref_loss[k]), k
    _assert_same(loaded, state)


def test_restore_without_optimizer_keeps_the_template(root, tmp_path):
    task, state, feeds = _setup(root, "lifter")
    state, _ = task.train_step(state, feeds[0])
    state_lib.save_checkpoint(str(tmp_path), "best", state)
    _, fresh, _ = _setup(root, "lifter", seed=1)
    mu0 = {k: v.clone() for k, v in fresh.opt.mu.items()}
    state_lib.load_checkpoint(str(tmp_path), "best", fresh,
                              restore_opt_state=False)
    assert fresh.step == 1 and fresh.opt.count == 0
    for k, v in fresh.opt.mu.items():
        assert torch.equal(v, mu0[k])
    for k, v in state.net.state_dict().items():
        assert torch.equal(fresh.net.state_dict()[k], v), k
    fresh.inference = object()              # int8 twins hold old weights
    state_lib.load_checkpoint(str(tmp_path), "best", fresh)
    assert fresh.inference is None and fresh.opt.count == 1


def test_epoch_checkpoints_replace_the_previous(tmp_path):
    state = state_lib.TrainState.create(
        nn.Linear(3, 2), {"frozen": nn.Linear(2, 2)},
        Optimizer("adam", lambda step: 1e-3), torch.device("cpu"))
    exp = str(tmp_path)
    for epoch in (1, 2):
        state_lib.save_checkpoint(exp, epoch, state)
    assert not state_lib.checkpoint_exists(exp, 1)
    assert state_lib.checkpoint_exists(exp, 2)
    for tag in ("nan", "inf", "best"):
        state_lib.save_checkpoint(exp, tag, state)
    assert sorted(os.listdir(exp)) == ["ckpt_2", "ckpt_best", "ckpt_inf",
                                       "ckpt_nan"]
    assert os.listdir(os.path.join(exp, "ckpt_2")) == [state_lib.CKPT_FILE]
    assert not state_lib.checkpoint_exists(exp, 3)
    os.makedirs(os.path.join(exp, "ckpt_3"))       # no file: not a ckpt
    assert not state_lib.checkpoint_exists(exp, 3)
    saved = state_lib.read_checkpoint(os.path.join(exp, "ckpt_2"))
    assert all(t.device.type == "cpu" for t in saved["net"].values())


def test_heatmap_warm_start_from_a_checkpoint_directory(root, tmp_path):
    """`load_heatmap_state` reads a checkpoint directory's net (the
    directory itself, or an experiment directory's ``ckpt_best``), and
    the stage-1 task warm-starts from it."""
    task, state, feeds = _setup(root, "heatmap")
    state, _ = task.train_step(state, feeds[0])
    exp = os.path.join(str(tmp_path), "stage1")
    state_lib.save_checkpoint(exp, "best", state)
    cfg = task.cfg
    for path in (exp, os.path.join(exp, "ckpt_best")):
        net = load_heatmap_state(cfg, path)
        for k, v in state.net.state_dict().items():
            assert torch.equal(net[k], v), k
    cfg.log_dir = str(tmp_path)
    cfg.path_to_trained_heatmap = "./log/stage1"
    warm = create_task(cfg, device="cpu").init_state(5, 2)
    for k, v in state.net.state_dict().items():
        assert torch.equal(warm.net.state_dict()[k], v), k
    with pytest.raises(FileNotFoundError):
        load_heatmap_state(cfg, str(tmp_path / "missing"))
