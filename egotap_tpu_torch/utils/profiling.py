"""Tracing inside the program, and profiling on `torch.profiler`
(counterpart of `egotap_tpu/utils/profiling.py`, which wraps
`jax.profiler`).

`span(name)` marks a phase where its work happens (the serving request
and its copies and stages, the training step and its phases, model
set-up). A span records while a torch profiler is active, or between
`enable()` and `disable()`; a set-up span (``always=True``) records
whenever it runs. Off, a span costs one check and returns a shared null
context: it allocates nothing and opens no profiler range. No span
synchronises the device.

A recorded span is a `Record`: its name, start and end in
`time.time_ns()` (the clock of the profiler's Chrome trace: an event's
``ts`` plus the trace's ``baseTimeNanoseconds`` / 1000 is that time in
µs), its id, its parent (the innermost span open on the same thread), the
root identifier and the thread. A root span (``root=`` a request's
number, a step's) sets the identifier that every span opened before it
closes shares, on any thread (autograd's too). While a profiler runs, a
span also opens a `record_function` range named ``egotap.<name>`` (exactly
``name`` with ``prefix=""``), so kernels launched inside it belong to it
in the trace.

`count(name, n)` adds ``n`` to the counter ``name`` of the innermost root
span open (None outside one), under the same rule: it records under a
profiler or between `enable()` and `disable()`, and off it costs one
check. `counters()` sums them per root span's name.

The records, spans and counts alike, sit in a buffer of `MAX_RECORDS`;
records past it are dropped and counted. `records()`, `summary()`,
`counters()`, `dropped()` and `reset()` read and clear it.

`trace` records host and card activity over a region into a Chrome trace
(``trace.json``, open it in chrome://tracing or Perfetto) in
``profile_dir``, each ``egotap.*`` range carrying its root identifier
(the training step) as its argument ``root``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"
PREFIX = "egotap."
MAX_RECORDS = 65536

_profiler_enabled = torch._C._autograd._profiler_enabled


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: Optional[int]
    thread: int


class Count(NamedTuple):
    name: str
    n: int
    root_name: Optional[str]
    root: Optional[int]


class Recorder:
    """The buffer of recorded spans and counts, the open spans of each
    thread and the root span in force (its identifier and name)."""

    def __init__(self):
        self.limit = MAX_RECORDS
        self.on = False
        self.root: Optional[int] = None
        self.root_name: Optional[str] = None
        self.ids = itertools.count()
        self.local = threading.local()
        self._lock = threading.Lock()
        self._records: List[Record] = []
        self._counts: List[Count] = []
        self._dropped = 0

    def open_spans(self) -> List[int]:
        """The ids of the spans open on the calling thread, innermost
        last."""
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def _keep(self, into: list, item) -> None:
        with self._lock:
            if len(self._records) + len(self._counts) < self.limit:
                into.append(item)
            else:
                self._dropped += 1

    def add(self, record: Record) -> None:
        self._keep(self._records, record)

    def add_count(self, count: Count) -> None:
        self._keep(self._counts, count)

    def records(self) -> List[Record]:
        with self._lock:
            return list(self._records)

    def counts(self) -> List[Count]:
        with self._lock:
            return list(self._counts)

    def dropped(self) -> int:
        return self._dropped

    def reset(self) -> None:
        with self._lock:
            self._records.clear()
            self._counts.clear()
            self._dropped = 0


_RECORDER = Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "label", "new_root", "id", "parent", "root",
                 "outer_root", "outer_root_name", "range", "start")

    def __init__(self, name: str, label: str, root: Optional[int]):
        self.name, self.label, self.new_root = name, label, root

    def __enter__(self) -> "_Span":
        rec = _RECORDER
        stack = rec.open_spans()
        self.parent = stack[-1] if stack else None
        self.id = next(rec.ids)
        stack.append(self.id)
        self.outer_root, self.outer_root_name = rec.root, rec.root_name
        if self.new_root is not None:
            rec.root, rec.root_name = self.new_root, self.name
        self.root = rec.root
        self.range = None
        self.start = time.time_ns()
        if _profiler_enabled():
            self.range = record_function(self.label)
            self.range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.time_ns()
        rec = _RECORDER
        rec.open_spans().pop()
        if self.new_root is not None:
            rec.root, rec.root_name = self.outer_root, self.outer_root_name
        rec.add(Record(self.name, self.start, end, self.id, self.parent,
                       self.root, threading.get_ident()))


def span(name: str, root: Optional[int] = None, prefix: str = PREFIX,
         always: bool = False):
    """A context manager that records the phase ``name`` when recording
    is on (or with ``always``, a set-up span); ``root``, the identifier of
    a request or step, makes it a root span."""
    if not (always or _RECORDER.on or _profiler_enabled()):
        return _OFF
    return _Span(name, prefix + name, root)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the innermost root span open,
    when recording is on."""
    rec = _RECORDER
    if rec.on or _profiler_enabled():
        rec.add_count(Count(name, int(n), rec.root_name, rec.root))


def enable() -> None:
    """Record spans also without a profiler, until `disable()`."""
    _RECORDER.on = True


def disable() -> None:
    _RECORDER.on = False


def records() -> List[Record]:
    """The recorded spans, in the order they closed."""
    return _RECORDER.records()


def dropped() -> int:
    """Spans closed and counts made while the buffer was full, since the
    last `reset`."""
    return _RECORDER.dropped()


def reset() -> None:
    """Empty the buffer (spans and counts) and zero the dropped count."""
    _RECORDER.reset()


def summary() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``; ``total_ms``, the time inside the name (a
    span nested in one of its own name counted once, as cProfile's
    cumulative time); ``self_ms``, each span's duration minus the part its
    children (spans opened inside it on its thread) cover."""
    recs = records()
    by_id = {r.id: r for r in recs}
    covered = collections.Counter()
    for r in recs:
        if r.parent in by_id:
            covered[r.parent] += r.end_ns - r.start_ns
    out: Dict[str, Dict[str, float]] = {}
    for r in recs:
        s = out.setdefault(r.name, {"count": 0, "total_ms": 0.0,
                                    "self_ms": 0.0})
        ns = r.end_ns - r.start_ns
        s["count"] += 1
        s["self_ms"] += (ns - covered[r.id]) / 1e6
        outer = by_id.get(r.parent)
        while outer is not None and outer.name != r.name:
            outer = by_id.get(outer.parent)
        if outer is None:
            s["total_ms"] += ns / 1e6
    return out


def counters() -> Dict[Optional[str], Dict[str, int]]:
    """Per root span's name (None: counted outside any root span), the sum
    of each counter."""
    out: Dict[Optional[str], Dict[str, int]] = {}
    for c in _RECORDER.counts():
        sums = out.setdefault(c.root_name, {})
        sums[c.name] = sums.get(c.name, 0) + c.n
    return out


def _annotate(path: str, recs: List[Record]) -> None:
    """Give each span's range in the Chrome trace at ``path`` its root
    identifier as the argument ``root`` (the record of the same name
    whose start lies nearest the range's)."""
    starts = collections.defaultdict(list)
    for r in sorted(recs, key=lambda r: r.start_ns):
        starts[r.name].append((r.start_ns / 1e3, r.root))
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0) / 1e3
    for e in doc.get("traceEvents", []):
        name = str(e.get("name", ""))
        mine = starts.get(name[len(PREFIX):] if name.startswith(PREFIX)
                          else name)
        if e.get("cat") != "user_annotation" or not mine:
            continue
        t = e["ts"] + base
        i = bisect.bisect_left(mine, (t,))
        near = min(mine[max(i - 1, 0):i + 1], key=lambda m: abs(m[0] - t))
        e.setdefault("args", {})["root"] = near[1]
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(profile_dir: str) -> Iterator[None]:
    """Trace the region into ``profile_dir/trace.json``."""
    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    first = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(profile_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _annotate(path, [r for r in records() if r.start_ns >= first])
