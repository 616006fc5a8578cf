"""Evaluation CLI (reference test.py; counterpart of
`egotap_tpu/cli/test.py`, with its flags and presets).

    python -m egotap_tpu_torch.cli.test --preset egotap_unrealego \
        --data_dir /data/UnrealEgoData [--flag value ...]

Loads the ``best`` checkpoint, evaluates the whole test split in f32
(per-frame stats and pose dumps) and each of the 30 motion categories,
and writes ``detail_result.txt`` and ``categorical_result.txt`` under
``{result_dir}/{experiment_name}``. Runs on the CUDA card; from Python,
``main(argv, device="cpu")`` runs on the CPU. `main` returns the test
split's metrics and `evaluate`'s pairs/s. Under ``torchrun`` (or in a
process group already joined) each rank evaluates its shard and only
rank 0 writes files.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, Tuple

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import resolve_device
from egotap_tpu_torch.data.pipeline import make_loader
from egotap_tpu_torch.eval.categories import MOTION_CATEGORIES
from egotap_tpu_torch.eval.evaluate import (append_categorical_result,
                                            evaluate,
                                            write_categorical_header,
                                            write_detail_result)
from egotap_tpu_torch.parallel import mesh
from egotap_tpu_torch.train import state as state_lib
from egotap_tpu_torch.train.loop import _init_task_state
from egotap_tpu_torch.train.tasks import create_task


def main(argv=None, device="cuda") -> Tuple[Dict[str, float], float]:
    cfg = Config.from_args(argv)
    cfg.is_train = False
    cfg.use_amp = False  # the reference tests in f32 (test_options.py:15)
    dp = mesh.setup(cfg, device)
    dev = resolve_device(dp.device if dp is not None else device)
    main_rank = dp is None or dp.main
    os.makedirs(cfg.results_dir, exist_ok=True)
    if main_rank:
        cfg.save(os.path.join(cfg.experiment_dir, "test_opt.txt"))

    if not state_lib.checkpoint_exists(cfg.experiment_dir, "best"):
        raise SystemExit(
            f"no 'best' checkpoint under {cfg.experiment_dir}: train "
            f"{cfg.experiment_name!r} first")
    task = create_task(cfg, dev, dp)
    state = _init_task_state(cfg, task, iters_per_epoch=1)
    state = state_lib.load_checkpoint(cfg.experiment_dir, "best", state,
                                      restore_opt_state=False)

    print("-----------------Test Best Model-----------------")
    metrics, stats, pps = evaluate(cfg, task, state, mode="test",
                                   save_result=True, device=dev)
    if main_rank:
        write_detail_result(os.path.join(cfg.results_dir,
                                         "detail_result.txt"), stats)
    for k, v in metrics.items():
        print(f"{k}: {v:.4e}")
    print(f"throughput: {pps:.1f} pairs/s")

    cat_path = os.path.join(cfg.results_dir, "categorical_result.txt")
    if main_rank:
        write_categorical_header(cat_path, metrics)
    print("-----------------Start Category-Specific Evaluation----------")
    for key, name in MOTION_CATEGORIES.items():
        n = len(make_loader(cfg, "test", key, *mesh.rank_world(dp)))
        cat_metrics, _, _ = evaluate(cfg, task, state, mode="test",
                                     category_id=key, device=dev)
        if not cat_metrics:
            continue
        if main_rank:
            append_categorical_result(cat_path, key, name, n, cat_metrics)
        print(f"category {key}_{name}: " +
              " ".join(f"{k}: {v}" for k, v in cat_metrics.items()))

    print("-----------------All Process Finished-----------------")
    return metrics, pps


if __name__ == "__main__":
    main(sys.argv[1:])
