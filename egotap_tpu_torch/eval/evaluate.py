"""Evaluation loop and result files.

Counterpart of `egotap_tpu/eval/evaluate.py` (reference
utils/evaluate.py:75-170 and test.py):
  * `evaluate`: a timed no-grad loop over a split; per-sample metrics
    with the padding masks; optionally the pred/gt pose dumps and the
    input path list.
  * `write_detail_result`, `write_categorical_header` and
    `append_categorical_result`: the reference's text files (test.py:
    9-18, 60-77), written as the JAX package writes them.

Timing: batches are queued without a per-batch synchronize; the first
batch (warm-up) is excluded when more than one runs, and the clock stops
at a device synchronize after the last. The metrics are read back after
the loop.

Over the task's process group (``task.dp``, `parallel/mesh.py`) each
rank evaluates its shard of the split (`data.pipeline.make_loader`);
the calibrated int8 scales are the elementwise max over the ranks (as
if calibrated on the union of their batches); the means are weighted by
each rank's count; the per-sample stats and the pose dumps are gathered
in rank order, and only rank 0 writes files; pairs/s is every rank's
timed pairs over the slowest rank's wall time.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import resolve_device
from egotap_tpu_torch.data.pipeline import make_device_preprocess, make_loader
from egotap_tpu_torch.eval.metrics import MetricAccumulator
from egotap_tpu_torch.ops.quant import Calibrated
from egotap_tpu_torch.parallel import mesh


def to_device(batch: Dict[str, np.ndarray], device: torch.device
              ) -> Dict[str, torch.Tensor]:
    """A host batch's arrays (``paths`` removed) as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items() if k != "paths"}


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate(cfg: Config, task, state, mode: str = "test",
             category_id: Optional[str] = None, save_result: bool = False,
             max_batches: Optional[int] = None, device="cuda"
             ) -> Tuple[Dict[str, float], Dict[str, list], float]:
    """Evaluate ``state`` over a split (optionally one motion category).
    Returns (mean metrics, per-sample stats, pairs/s). ``device`` must be
    the task's: the card unless the caller asks for the CPU.

    With an int8 flag on and ``cfg.calib_batches > 0``, static activation
    scales are calibrated on the first ``calib_batches`` batches
    (`LifterTask.prepare_inference`) unless ``state`` already carries
    calibrated int8 twins. With ``save_result``, writes
    ``pred_pose.npy`` and ``input_paths.pkl`` under ``cfg.results_dir``
    and ``gt_{data}_pose.npy`` beside it."""
    dev = resolve_device(device)
    if dev != task.device:
        raise ValueError(f"evaluate on {dev}, but the task runs on "
                         f"{task.device}")
    dp = task.dp
    loader = make_loader(cfg, mode, category_id, *mesh.rank_world(dp))
    if len(loader) == 0:
        suffix = f" (category {category_id})" if category_id else ""
        print(f"Evaluation dataset is empty!{suffix}")
        return {}, {}, 0.0
    pre = make_device_preprocess(cfg)
    acc = MetricAccumulator()

    int8_on = cfg.int8_heatmap_inference or cfg.int8_lifter_inference
    if hasattr(task, "prepare_inference") and state.inference is None:
        calib = None
        if int8_on and cfg.calib_batches > 0:
            calib = []
            for bi, batch in enumerate(loader):
                if bi >= cfg.calib_batches:
                    break
                calib.append({"input_rgb":
                              pre(to_device(batch, dev))["input_rgb"]})
        state = task.prepare_inference(state, calib_batches=calib)
        if calib and dp is not None:
            sync_calibrated_scales(state.inference.nets, dp)
        if int8_on:
            print("int8 inference: " + (
                f"calibrated static ({len(calib)} batches)" if calib
                else "dynamic per-call") + " activation scales")

    pred_poses, gt_poses, input_paths = [], [], []
    pending = []        # (device metrics, mask, device poses)
    n_samples = timed_samples = 0
    t_start = time.perf_counter()
    t_warm = None
    for bi, batch in enumerate(loader):
        if max_batches is not None and bi >= max_batches:
            break
        mask = batch["mask"]
        out = task.eval_step(state, pre(to_device(batch, dev)))
        n_samples += int(mask.sum())
        poses = (out.get("pred_pose"), out.get("gt_pose")) if save_result \
            else None
        pending.append((out["metrics"], mask, poses))
        if save_result:
            input_paths.extend(batch["paths"])
        if bi == 0:
            _synchronize(dev)           # warm-up boundary
            t_warm = time.perf_counter()
        else:
            timed_samples += int(mask.sum())
    _synchronize(dev)
    t_end = time.perf_counter()
    if t_warm is not None and timed_samples > 0:
        elapsed, n_timed = t_end - t_warm, timed_samples
    else:
        elapsed, n_timed = t_end - t_start, n_samples

    for metrics, mask, poses in pending:
        acc.update({k: v.cpu().numpy() for k, v in metrics.items()},
                   mask=mask)
        if poses is not None and poses[0] is not None:
            keep = mask.astype(bool)
            pred_poses.append(poses[0].cpu().numpy()[keep])
            gt_poses.append(poses[1].cpu().numpy()[keep])

    means, per_sample = acc.means(), acc.per_sample
    pairs_per_sec = n_timed / elapsed if elapsed > 0 else 0.0
    if dp is not None:
        ranks = dp.gather_objects(
            ({k: (v, acc.count) for k, v in means.items()}, per_sample,
             (n_timed, elapsed), (pred_poses, gt_poses, input_paths)))
        means = _weighted_means([r[0] for r in ranks])
        per_sample = {k: [x for r in ranks for x in r[1].get(k, [])]
                      for k in means}
        pairs_per_sec = (sum(r[2][0] for r in ranks)
                         / max(max(r[2][1] for r in ranks), 1e-9))
        pred_poses, gt_poses, input_paths = (
            [x for r in ranks for x in r[3][i]] for i in range(3))

    # nothing is written for a task without poses (HeatmapTask), as the
    # reference writes nothing then
    if save_result and pred_poses and (dp is None or dp.main):
        save_path = cfg.results_dir
        os.makedirs(save_path, exist_ok=True)
        np.save(os.path.join(save_path, "pred_pose.npy"),
                np.concatenate(pred_poses, axis=0))
        data_name = os.path.normpath(cfg.data_dir).split("/")[-1].lower()
        np.save(os.path.join(save_path, os.pardir,
                             f"gt_{data_name}_pose.npy"),
                np.concatenate(gt_poses, axis=0))
        with open(os.path.join(save_path, "input_paths.pkl"), "wb") as f:
            pickle.dump(np.asarray(input_paths, dtype=object).reshape(-1, 1),
                        f)
    return means, per_sample, pairs_per_sec


def _weighted_means(ranks) -> Dict[str, float]:
    """The global mean of each metric from every rank's {key: (mean,
    count)}; a key missing on a rank counts 0 rows there."""
    keys = list(dict.fromkeys(k for r in ranks for k in r))
    out = {}
    for k in keys:
        total = sum(r[k][0] * r[k][1] for r in ranks if k in r)
        count = sum(r[k][1] for r in ranks if k in r)
        out[k] = total / max(count, 1)
    return out


def sync_calibrated_scales(nets, dp) -> None:
    """Every static activation scale of ``nets`` becomes its max over the
    ranks (`egotap_tpu/eval/evaluate.py:_sync_calibrated_scales`): each
    rank calibrated on its own shard, and a_scale = amax / 127 is
    monotone in amax, so the max is the scale of the union of the
    ranks' batches."""
    scales = [m.a_scale for net in nets for m in net.modules()
              if isinstance(m, Calibrated) and m.a_scale is not None]
    if scales:
        dp.max_(scales)


def write_detail_result(path: str, stats: Dict[str, list]) -> None:
    """Per-frame metric table (reference test.py:9-18)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    keys = list(stats.keys())
    with open(path, "w") as f:
        f.write(" ".join(keys) + " \n")
        n = len(stats[keys[0]]) if keys else 0
        for i in range(n):
            f.write(" ".join(str(stats[k][i]) for k in keys) + " \n")


def write_categorical_header(path: str, metrics: Dict[str, float]) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(" ".join(metrics.keys()) + " \n")
        f.write(" ".join(str(v) for v in metrics.values()) + " \n")


def append_categorical_result(path: str, key: str, name: str,
                              n_batches: int,
                              metrics: Dict[str, float]) -> None:
    with open(path, "a") as f:
        f.write(f"{key} {name} {n_batches} "
                + " ".join(str(v) for v in metrics.values()) + " \n")
