"""Metric logging: JSONL always, TensorBoard when a writer imports.

The port's own copy of `egotap_tpu/utils/logging.py`, after the
reference's SummaryWriter use (train.py:14-34, 132, 178-217), including
the rotation of a finished run's summary directory when a run starts
over it (summary -> summary_0, summary_1, ...). TensorBoard event files
are written through ``tensorboardX`` when it is installed, and skipped
otherwise, as in the JAX package (`torch.utils.tensorboard` would import
TensorFlow wherever that is installed).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Dict


class MetricWriter:
    def __init__(self, log_dir: str, clear: bool = False):
        self.dir = log_dir
        if clear:
            self._rotate()
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(logdir=self.dir)

    def _rotate(self) -> None:
        """summary -> summary_N rotation (reference train.py:17-31)."""
        if not os.path.isdir(self.dir):
            return
        parent = os.path.dirname(self.dir)
        test_result = os.path.join(parent, "test_result.txt")
        if os.path.exists(test_result):
            idx = 0
            while os.path.isdir(f"{self.dir}_{idx}"):
                idx += 1
            shutil.move(self.dir, f"{self.dir}_{idx}")
            shutil.move(test_result, test_result[:-4] + f"_{idx}.txt")
        else:
            shutil.rmtree(self.dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"t": time.time(), "tag": tag, "value": float(value),
             "step": int(step)}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), step)

    def scalars(self, prefix: str, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(f"{prefix}/{k}", v, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
