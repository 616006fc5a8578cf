"""The training loop: epochs, watchdogs, restarts and artifacts.

Counterpart of `egotap_tpu/train/loop.py` (reference train.py:63-287):
  * a NaN/Inf loss saves a tagged checkpoint, reloads the previous epoch
    and restarts it (at epoch 1: abort, or terminate with
    ``auto_terminate``; train.py:137-164);
  * the early-convergence watchdog: during the first 3000 (heatmap) /
    8000 (pose) iterations, a loss that has not improved for 200 / 400
    iterations asks for a restart from scratch with ``auto_restart``
    (train.py:165-177);
  * per-epoch validation, the ``best`` checkpoint on the task's
    ``eval_key``, periodic checkpoints with the previous epoch's removed,
    and the final best-model test with per-category results in
    ``test_result.txt``.

Host to card: the loader's numpy batch is copied to the device, where
`make_device_preprocess` renders the targets. Losses stay on the device
and are read back every ``loss_sync_every`` steps, one ``.item()`` a
loss. Each epoch logs, in seconds, under ``Time/`` in the summary: its
wall time with validation and every checkpoint write (``epoch_s``), the
step loop (``loop_s``) and its time waiting on the loader
(``loader_wait_s``), the validation pass (``val_s``), and the checkpoint
writes, ``best`` and the epoch's own (``ckpt_s``).

Data parallelism: launched by ``torchrun`` (one process a card; or
inside a process group already joined, `parallel.mesh.init`), every rank
starts from rank 0's state, loads its shard of each split and takes the
same steps (`parallel/mesh.py`, the task's ``dp``); losses are averaged
over the ranks before they are read, so every rank takes the same
NaN/Inf and watchdog decisions. Only rank 0 writes the option file, the
summary, the checkpoints, the provenance copy and ``test_result.txt``;
the others wait for each checkpoint write.
"""

from __future__ import annotations

import contextlib
import math
import os
import shutil
import time
from typing import Dict, Optional, Tuple

import numpy as np

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import resolve_device
from egotap_tpu_torch.data.pipeline import make_device_preprocess, make_loader
from egotap_tpu_torch.eval.categories import MOTION_CATEGORIES
from egotap_tpu_torch.eval.evaluate import evaluate, to_device
from egotap_tpu_torch.parallel import mesh
from egotap_tpu_torch.train import state as state_lib
from egotap_tpu_torch.train.tasks import create_task, load_heatmap_state
from egotap_tpu_torch.utils.logging import MetricWriter
from egotap_tpu_torch.utils.profiling import step_annotation, trace

StateDict = Dict[str, object]


def load_pretrained_heatmaps(cfg: Config
                             ) -> Tuple[Optional[StateDict],
                                        Optional[StateDict]]:
    """The stage-1 nets a stage-2 run starts from, by the reference's
    sibling-directory convention (model/egotap_autoencoder_model.py:
    113-126): ``path_to_trained_heatmap`` = ``{base}/{file}`` names
    ``{base}_pos/{file}`` and ``{base}_{heatmap_type}/{file}``, each a
    ``.pth`` or, when that file is missing, the directory's port
    ``ckpt_best``. A ``./log/`` path is rewritten into ``cfg.log_dir``."""
    if cfg.path_to_trained_heatmap is None:
        return None, None
    path = cfg.path_to_trained_heatmap
    if path.startswith("./log/"):
        path = os.path.join(cfg.log_dir, path[len("./log/"):])
    base_dir, fname = os.path.split(path)
    out = []
    for suffix in ("_pos", "_" + cfg.heatmap_type):
        pth = os.path.join(base_dir + suffix, fname)
        ckpt = os.path.join(base_dir + suffix, "ckpt_best")
        if not (os.path.exists(pth) or os.path.isdir(ckpt)):
            raise FileNotFoundError(
                f"no pretrained heatmap checkpoint at {pth} or {ckpt}")
        out.append(load_heatmap_state(
            cfg, pth if os.path.exists(pth) else ckpt))
    return out[0], out[1]


def _init_task_state(cfg: Config, task, iters_per_epoch: int):
    """The seeded initial state; stage 2 loads its frozen nets by
    `load_pretrained_heatmaps`."""
    if cfg.model == "egotap_autoencoder":
        hm, rot = load_pretrained_heatmaps(cfg)
        return task.init_state(cfg.seed, iters_per_epoch, heatmap_state=hm,
                               rot_heatmap_state=rot)
    return task.init_state(cfg.seed, iters_per_epoch)


def test_model(cfg: Config, task, state, device) -> Dict[str, float]:
    metrics, _, pps = evaluate(cfg, task, state, mode="test", device=device)
    print("best test metrics:")
    for k, v in metrics.items():
        print(f"{k}: {v:.4e}")
    print(f"throughput: {pps:.1f} pairs/s")
    return metrics


def train_main(cfg: Config, epoch_callback=None, device="cuda") -> bool:
    """One training attempt on ``device`` (the card unless the caller asks
    for the CPU). Returns True when finished; False asks for a restart
    from scratch (the reference's auto-restart protocol).

    ``epoch_callback``: an external tuner's hook (reference train.py:
    63-68, 102-103, 208-211), called after each completed epoch, and on
    a NaN/Inf loss with ``bad_loss=True``, with a report dict {epoch,
    train_losses, val_metrics, bad_loss, checkpoint_path, state}
    (``state``: the live `TrainState`); a truthy return stops cleanly,
    and training goes on to the final best-model test."""
    dp = mesh.setup(cfg, device)
    dev = resolve_device(dp.device if dp is not None else device)
    main = dp is None or dp.main
    os.makedirs(cfg.experiment_dir, exist_ok=True)
    if main:
        cfg.save(os.path.join(cfg.experiment_dir, "train_opt.txt"))

    print("preparing dataset ...")
    train_loader = make_loader(cfg, "train", None, *mesh.rank_world(dp))
    iters_per_epoch = len(train_loader)
    if iters_per_epoch == 0:
        raise RuntimeError("empty training split")
    pre = make_device_preprocess(cfg)

    task = create_task(cfg, dev)
    task.dp = dp
    state = _init_task_state(cfg, task, iters_per_epoch)
    if cfg.epoch_count > 1:
        state = state_lib.load_checkpoint(cfg.experiment_dir,
                                          cfg.epoch_count - 1, state)
    if dp is not None:
        dp.broadcast_modules([state.net, *state.frozen.values()])
        print(f"data-parallel training over {dp.world} ranks "
              f"({dp.backend})")

    writer = MetricWriter(os.path.join(cfg.experiment_dir, "summary"),
                          clear=(cfg.epoch_count == 1)) if main \
        else _NullWriter()

    def save_ckpt(tag):
        nonlocal ckpt_s
        t = time.perf_counter()
        if main:
            state_lib.save_checkpoint(cfg.experiment_dir, tag, state)
        if dp is not None:
            dp.barrier()           # the others may read it next
        ckpt_s += time.perf_counter() - t

    # dataset provenance copy (reference record_dataset_information,
    # train.py:36-47)
    prov = os.path.join(cfg.data_dir, "modify_dataset_log.txt")
    if main and os.path.exists(prov):
        ds_dir = os.path.join(cfg.experiment_dir, "dataset")
        os.makedirs(ds_dir, exist_ok=True)
        shutil.copy(prov, os.path.join(ds_dir, "modify_dataset_log.txt"))

    best_metric = math.inf
    best_metrics = None
    loss_records: Dict[str, Tuple[int, float]] = {}
    heatmap = "Heatmap" in task.name
    check_itr = cfg.watchdog_check_iters or (3000 if heatmap else 8000)
    stall_threshold = cfg.watchdog_stall_iters or (200 if heatmap else 400)

    print("---------------------Start Training-----------------------")
    epoch = cfg.epoch_count
    total_itr = (cfg.epoch_count - 1) * iters_per_epoch
    while epoch <= cfg.niter + cfg.niter_decay:
        print(f"-----------------Train Epoch: {epoch}-----------------")
        restart_epoch = False
        abort = None
        stall = False
        epoch_losses: Dict[str, list] = {}
        val_metrics: Dict[str, float] = {}
        t0 = time.perf_counter()
        loader_wait = val_s = ckpt_s = 0.0  # ckpt_s: `save_ckpt`'s writes
        pending = []  # (i, step, curr_itr, device loss dict)
        tracing = contextlib.ExitStack()

        def flush_losses():
            """Read the buffered losses back: logging, the NaN/Inf
            protocol and the early-convergence watchdog, as if checked
            after every step."""
            nonlocal restart_epoch, abort, stall
            for (bi, step, curr_itr, dl) in pending:
                losses = {k: v.item() for k, v in dl.items()}
                for k, v in losses.items():
                    epoch_losses.setdefault(k, []).append(v)
                    writer.scalar(f"Batch/{k}", v, step)
                    if math.isnan(v) or math.isinf(v):
                        tag = "nan" if math.isnan(v) else "inf"
                        print(f"{k} loss is {tag.upper()}!")
                        save_ckpt(tag)
                        if epoch > 1:
                            restart_epoch = True
                        else:
                            abort = cfg.auto_terminate
                        return
                    if cfg.auto_restart and curr_itr < check_itr:
                        if k not in loss_records or v < loss_records[k][1]:
                            loss_records[k] = (curr_itr, v)
                        elif curr_itr - loss_records[k][0] > stall_threshold:
                            print(f"Early convergence detected at {bi} "
                                  f"({v:.3e}) for {k}!")
                            stall = True
                            return
            pending.clear()

        with contextlib.closing(iter(train_loader)) as batches, tracing:
            for i in range(iters_per_epoch):
                t_wait = time.perf_counter()
                batch = next(batches, None)
                loader_wait += time.perf_counter() - t_wait
                if batch is None:
                    break
                if cfg.profile_dir and epoch == cfg.epoch_count and i == 2:
                    tracing.enter_context(trace(cfg.profile_dir))
                step = (epoch - 1) * iters_per_epoch + i
                with step_annotation("train", step):
                    state, losses = task.train_step(
                        state, pre(to_device(batch, dev)))
                if i >= 2 + cfg.profile_steps:
                    tracing.close()
                pending.append((i, step, total_itr + i, losses))
                if len(pending) >= max(1, cfg.loss_sync_every):
                    flush_losses()
                if restart_epoch or abort is not None or stall:
                    break
            if not (restart_epoch or abort is not None or stall):
                flush_losses()
        loop_s = time.perf_counter() - t0
        if stall:
            writer.close()
            return False
        if (restart_epoch or abort is not None) and epoch_callback \
                is not None:
            # the reference's tuner hook hears of the bad loss
            # (train.py:102-103); a truthy return ends the attempt
            if epoch_callback({"epoch": epoch, "train_losses": {},
                               "val_metrics": {}, "bad_loss": True,
                               "checkpoint_path": None, "state": state}):
                writer.close()
                return True
        if abort is not None:
            writer.close()
            return abort
        if restart_epoch:
            state = state_lib.load_checkpoint(cfg.experiment_dir, epoch - 1,
                                              state)
            continue

        if epoch % cfg.val_epoch_freq == 0:
            print(f"-----------------Validation Epoch: {epoch}--------------")
            t_val = time.perf_counter()
            metrics, _, _ = evaluate(cfg, task, state, mode="validation",
                                     device=dev)
            val_s = time.perf_counter() - t_val
            writer.scalars("Validation", metrics, epoch)
            print(" ".join(f"{k}: {v:.4E}" for k, v in metrics.items()))
            val_metrics = metrics
            if metrics and metrics[task.eval_key] < best_metric:
                best_metric = metrics[task.eval_key]
                best_metrics = metrics
                save_ckpt("best")

        if epoch % cfg.save_epoch_freq == 0:
            save_ckpt(epoch)

        epoch_s = time.perf_counter() - t0
        writer.scalars("Time", {"epoch_s": epoch_s, "loop_s": loop_s,
                                "loader_wait_s": loader_wait,
                                "val_s": val_s, "ckpt_s": ckpt_s}, epoch)
        if epoch % cfg.print_epoch_freq == 0:
            means = {k: float(np.mean(v)) for k, v in epoch_losses.items()}
            writer.scalars("Train", means, epoch)
            print(f"(epoch: {epoch}, time: {epoch_s:.3f}s, step loop: "
                  f"{loop_s:.3f}s, loader wait: {loader_wait:.3f}s, "
                  f"validation: {val_s:.3f}s, checkpoints: {ckpt_s:.3f}s) "
                  + " ".join(f"{k}: {v:.3e}" for k, v in means.items()))

        total_itr += iters_per_epoch
        print(f"dir name: {cfg.experiment_name}")
        if epoch_callback is not None:
            ckpt = os.path.join(cfg.experiment_dir, f"ckpt_{epoch}")
            if epoch_callback({
                    "epoch": epoch,
                    "train_losses": {k: float(np.mean(v))
                                     for k, v in epoch_losses.items()},
                    "val_metrics": val_metrics, "bad_loss": False,
                    "checkpoint_path": ckpt if os.path.isdir(ckpt)
                    else None, "state": state}):
                print(f"external tuner requested stop after epoch {epoch}")
                break
        epoch += 1

    print("\ntrain finished !!!")
    print(f"best validation metrics: {best_metrics}")

    print("-----------------Test Best Model-----------------")
    if state_lib.checkpoint_exists(cfg.experiment_dir, "best"):
        state = state_lib.load_checkpoint(cfg.experiment_dir, "best", state)
    metrics_test = test_model(cfg, task, state, dev)

    lines = ["".join(f"{k}: {v:.4e}" for k, v in metrics_test.items())]
    for key, name in MOTION_CATEGORIES.items():
        cat_metrics, _, _ = evaluate(cfg, task, state, mode="test",
                                     category_id=key, device=dev)
        if cat_metrics:
            lines.append(f"category: {key}_{name}")
            lines += [f"{k}: {v}" for k, v in cat_metrics.items()]
    if main:
        with open(os.path.join(cfg.experiment_dir, "test_result.txt"),
                  "w") as f:
            f.write("\n".join(lines) + "\n")

    writer.close()
    print("-----------------All Process Finished-----------------")
    return True


class _NullWriter:
    """The summary writer of a rank that writes no files."""

    def scalar(self, *_):
        pass

    def scalars(self, *_):
        pass

    def close(self):
        pass


def run_training(cfg: Config, epoch_callback=None, device="cuda") -> None:
    """Auto-restart wrapper (reference train.py:282-287)."""
    while not train_main(cfg, epoch_callback=epoch_callback, device=device):
        pass
