"""Pose metrics: MPJPE / PA-MPJPE (mm) and host-side running averages.

Counterpart of `egotap_tpu/eval/metrics.py` (reference
utils/evaluate.py:51-73, metrics per sample, x10 cm -> mm;
utils/util.py:79-157 for the accumulators). The batch is computed on the
device in one shot; the accumulators aggregate with exact counts on the
host, in numpy.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from egotap_tpu_torch.ops.procrustes import similarity_align
from egotap_tpu_torch.train.losses import per_sample_mpjpe

CM2MM = 10.0  # pose stored in cm; metrics reported in mm


def pose_metrics(pred: torch.Tensor, gt: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Per-sample mpjpe / pa_mpjpe in mm. pred/gt: (B, J, 3) in cm."""
    aligned = similarity_align(pred, gt)
    return {"mpjpe": per_sample_mpjpe(pred, gt) * CM2MM,
            "pa_mpjpe": per_sample_mpjpe(aligned, gt) * CM2MM}


class RunningAverage:
    """Exact streaming mean over appended batches (host side)."""

    def __init__(self) -> None:
        self.total = 0.0
        self.count = 0

    def update(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64).ravel()
        self.total += float(values.sum())
        self.count += values.size

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class MetricAccumulator:
    """Dict of RunningAverages keyed by metric name."""

    def __init__(self) -> None:
        self._avgs: Dict[str, RunningAverage] = {}
        self.per_sample: Dict[str, list] = {}

    def update(self, metrics: Dict[str, np.ndarray],
               mask: Optional[np.ndarray] = None) -> None:
        """Append a batch of per-sample metrics; `mask` drops padded rows."""
        for k, v in metrics.items():
            v = np.asarray(v)
            if mask is not None:
                v = v[np.asarray(mask).astype(bool)]
            self._avgs.setdefault(k, RunningAverage()).update(v)
            self.per_sample.setdefault(k, []).extend(v.tolist())

    def means(self) -> Dict[str, float]:
        return {k: a.mean for k, a in self._avgs.items()}

    @property
    def count(self) -> int:
        return next(iter(self._avgs.values())).count if self._avgs else 0
