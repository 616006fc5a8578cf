"""Hyperparameter search (the native replacement for the reference's
dormant Ray Tune hooks, train.py:63-68, 208-211); the port's own copy of
`egotap_tpu/train/search.py`, driving the port's `train_main` on
``device`` (the card unless the caller asks for the CPU).

Random search over config-field spaces; each trial runs the normal
training loop into its own experiment directory and is scored by the best
validation value of `criteria` (the reference's ``opt.tune_criteria``).
Results land in ``{log_dir}/{experiment}_search/search_results.json``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import traceback
from typing import Any, Dict, List, Sequence

import numpy as np


def _best_validation_metric(experiment_dir: str, criteria: str) -> float:
    path = os.path.join(experiment_dir, "summary", "metrics.jsonl")
    best = math.inf
    if not os.path.exists(path):
        return best
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if rec.get("tag") == f"Validation/{criteria}":
                best = min(best, rec["value"])
    return best


def sample_overrides(space: Dict[str, Sequence[Any]], rng: np.random.Generator
                     ) -> Dict[str, Any]:
    return {k: v[rng.integers(len(v))] if not callable(v) else v(rng)
            for k, v in space.items()}


def random_search(base_cfg, space: Dict[str, Sequence[Any]],
                  num_trials: int = 8, criteria: str = "mpjpe",
                  seed: int = 0, epoch_callback=None,
                  device="cuda") -> Dict[str, Any]:
    """Run `num_trials` trainings with sampled overrides; returns the best
    trial record {overrides, score, experiment_name}.

    Scoring rides train_main's per-epoch tuner hook: every epoch report
    (val_metrics, checkpoint_path, bad_loss) updates the trial's best
    `criteria` value. An external scheduler can plug in via
    `epoch_callback(trial, report) -> bool` — a truthy return early-stops
    that trial (the trial still scores on what it reached)."""
    from egotap_tpu_torch.train.loop import train_main

    rng = np.random.default_rng(seed)
    search_dir = os.path.join(base_cfg.log_dir,
                              base_cfg.experiment_name + "_search")
    os.makedirs(search_dir, exist_ok=True)
    results: List[Dict[str, Any]] = []

    for trial in range(num_trials):
        overrides = sample_overrides(space, rng)
        cfg = dataclasses.replace(base_cfg, **overrides)
        cfg.experiment_name = f"{base_cfg.experiment_name}_search/t{trial:03d}"
        cfg = cfg.derive()
        print(f"--- trial {trial}: {overrides}")

        trial_best = [math.inf]

        def on_epoch(report, _trial=trial, _best=trial_best):
            if report.get("bad_loss"):
                return epoch_callback(_trial, report) \
                    if epoch_callback else False
            val = report.get("val_metrics") or {}
            if criteria in val:
                _best[0] = min(_best[0], float(val[criteria]))
            return epoch_callback(_trial, report) \
                if epoch_callback else False

        try:
            finished = train_main(cfg, epoch_callback=on_epoch,
                                  device=device)
        except Exception:  # a diverged trial shouldn't kill the search
            print(f"trial {trial} failed:\n{traceback.format_exc()}")
            finished = False
        score = trial_best[0]
        if math.isinf(score) and finished:
            # e.g. val_epoch_freq never hit criteria — fall back to the
            # summary file
            score = _best_validation_metric(cfg.experiment_dir, criteria)
        results.append({"trial": trial, "overrides": overrides,
                        "score": score,
                        "experiment_name": cfg.experiment_name})
        with open(os.path.join(search_dir, "search_results.json"), "w") as f:
            json.dump(results, f, indent=2, default=str)

    best = min(results, key=lambda r: r["score"])
    print(f"best trial: {best}")
    return best
