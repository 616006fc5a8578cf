"""Profiling hooks on `torch.profiler` (counterpart of
`egotap_tpu/utils/profiling.py`, which wraps `jax.profiler`).

`trace` records host and card activity over a region and writes a
Chrome trace (``trace.json``, open it in chrome://tracing or Perfetto)
into ``profile_dir``; `step_annotation` names a training step's range in
that trace.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(profile_dir: str) -> Iterator[None]:
    """Trace the region into ``profile_dir/trace.json``."""
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))


def step_annotation(name: str, step: int):
    """A named range for one step (``{name}_step_{step}``) in the trace."""
    return record_function(f"{name}_step_{step}")
