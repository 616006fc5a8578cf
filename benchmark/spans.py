"""Spans around the program's layers, and the reduction of a profiler
trace to device time.

`Spans` opens a ``torch.profiler.record_function`` range around each call
of a module (a forward pre-hook opens it, a forward hook closes it) or of
a function attribute (a wrapper), from the benchmark's side: the program
is not edited. `profile` runs a callable under ``torch.profiler`` with
CPU and CUDA activities and reduces the Chrome trace it exports to a
`Trace`:

  * each device kernel with its duration and the ranges its launch was
    made in (the launch's host thread and time, found through the
    profiler's correlation id, lying inside a range's span on that
    thread);
  * the device's busy time: the union of kernel, copy and set intervals
    inside the traced window;
  * the longest idle gaps of the device, named by the innermost host
    operation running on the main thread at the gap's middle (or, when
    none runs there, on another thread, such as autograd's).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.traced"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Spans:
    """Profiler ranges named ``name`` around every call of ``module`` or of
    ``owner.attr`` while installed; `remove` takes them away."""

    def __init__(self):
        self._handles = []
        self._patched: List[Tuple[object, str, Callable]] = []

    def module(self, module: torch.nn.Module, name: str) -> None:
        open_ranges = []

        def pre(_mod, _args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            open_ranges.append(rf)

        def post(_mod, _args, _out):
            open_ranges.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def function(self, owner, attr: str, name: str) -> None:
        inner = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(name):
                return inner(*args, **kwargs)

        setattr(owner, attr, wrapped)
        self._patched.append((owner, attr, inner))

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        for owner, attr, inner in reversed(self._patched):
            setattr(owner, attr, inner)
        self._handles, self._patched = [], []


class Trace:
    """A reduced profiler trace of one traced window."""

    def __init__(self, kernels, busy_s: float, window_s: float,
                 device_ops, idle_gaps, copies: int):
        self.kernels = kernels          # [(name, seconds, frozenset(ranges))]
        self.busy_s = busy_s
        self.window_s = window_s
        self.device_ops = device_ops    # [(name, seconds)] most first
        self.idle_gaps = idle_gaps      # [(host activity, seconds)]
        self.copies = copies

    def range_s(self, *names: str) -> float:
        """Device seconds of the kernels launched inside any of ``names``."""
        want = set(names)
        return sum(s for _, s, r in self.kernels if r & want)

    def kernel_s(self, *patterns: str) -> Tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds one
        of ``patterns``."""
        hits = [s for n, s, _ in self.kernels
                if any(p in n for p in patterns)]
        return sum(hits), len(hits)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _innermost(ops, times) -> Dict[float, Optional[str]]:
    """For each of ``times`` (sorted), the name of the innermost of one
    thread's nested ``ops`` (start, end, name; sorted) running then, or
    None: one sweep with a stack of the open ops."""
    out, stack, j = {}, [], 0
    for t in times:
        while j < len(ops) and ops[j][0] <= t:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[t] = stack[-1][2] if stack else None
    return out


def _open_ranges(ranges, times) -> Dict[float, frozenset]:
    """For each of ``times`` (sorted), the names of one thread's nested
    ``ranges`` (start, end, name; sorted) open then."""
    out, stack, j = {}, [], 0
    for t in times:
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[t] = frozenset(r[2] for r in stack if r[1] >= t)
    return out


def reduce_trace(events: List[dict], top: int = 10) -> Optional[Trace]:
    """`Trace` of the Chrome-trace ``events`` of one profiled window (the
    `WINDOW` range); None when the window is not in it."""
    window = [e for e in events if e.get("name") == WINDOW
              and str(e.get("cat", "")).lower() == "user_annotation"]
    if not window:
        return None
    w = window[0]
    w0, w1, main_tid = w["ts"], w["ts"] + w["dur"], w["tid"]
    launches: Dict[int, Tuple[object, float]] = {}
    ranges = collections.defaultdict(list)       # tid -> [(start, end, name)]
    host = collections.defaultdict(list)         # tid -> its host ops
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e["tid"], e["ts"])
        if cat == "user_annotation" and e["name"] != WINDOW:
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        if cat in HOST_CATS and e["name"] != WINDOW:
            host[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    kernels, intervals, copies = [], [], 0
    by_name = collections.Counter()
    for e in device:
        a, b = e["ts"], e["ts"] + e["dur"]
        if b <= w0 or a >= w1:
            continue
        intervals.append((max(a, w0), min(b, w1)))
        seconds = e["dur"] / 1e6
        by_name[e["name"]] += seconds
        if str(e.get("cat", "")).lower() != "kernel":
            copies += 1
            continue
        corr = (e.get("args") or {}).get("correlation")
        kernels.append((e["name"], seconds, launches.get(corr)))
    open_at = {tid: _open_ranges(sorted(r), sorted(
        ts for t, ts in (v for k, v in launches.items()) if t == tid))
        for tid, r in ranges.items()}
    kernels = [(n, s, open_at.get(at[0], {}).get(at[1], frozenset())
                if at else frozenset()) for n, s, at in kernels]
    busy = _union(intervals)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, t = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    mids = sorted(0.5 * (a + b) for a, b in gaps)
    names = {tid: _innermost(sorted(ops), mids) for tid, ops in host.items()}
    idle = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = names.get(main_tid, {}).get(mid)
        if label is None:
            label = next((f"{n[mid]} (another thread)" for tid, n in
                          sorted(names.items(), key=lambda x: str(x[0]))
                          if tid != main_tid and n[mid] is not None),
                         "host (no profiled op)")
        idle[label] += (b - a) / 1e6
    return Trace(kernels, busy_s, (w1 - w0) / 1e6,
                 by_name.most_common(top), idle.most_common(top), copies)


def profile(fn: Callable[[], None]) -> Optional[Trace]:
    """Run ``fn`` (which ends in a device synchronise) under the profiler
    inside the `WINDOW` range, and reduce its trace. The exported trace
    lives in a temporary directory for the reduction only."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_trace(events)
