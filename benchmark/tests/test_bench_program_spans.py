"""The readers of the program's spans (source ``program_span``), on
hand-made recorder contents, and on the traced tiny runs of a serving and
a training cell."""

import math
import types

import pytest

from egotap_tpu_torch.utils import profiling
from egotap_tpu_torch.utils.profiling import Record

from benchmark import harness

from tiny import run, tiny_cell

MS = 10 ** 6
SERVE = ("h2d_ms.serve", "dispatch_ms.serve", "d2h_wait_ms.serve")
TRAIN = ("forward_host_ms.train", "backward_host_ms.train",
         "optimizer_host_ms.train")
ALL = SERVE + TRAIN + ("model_setup_s",)


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.reset()


def fill(units):
    """A set-up span of 1.5 s holding one of its own name; per request
    copy 3 ms, stage 1 5 ms, stage 2 2 ms, wait 7 ms; per step frozen
    forward 4 ms, net forward 6 ms, backward 20 ms, optimizer 3 ms."""
    ids = iter(range(10 ** 6))
    add = profiling._RECORDER.add
    outer = next(ids)
    add(Record("setup.model", 0, 1500 * MS, outer, None, None, 1))
    add(Record("setup.model", MS, 2 * MS, next(ids), outer, None, 1))
    for root, phases in (("serve.request", (("serve.h2d", 3), ("stage1", 5),
                                            ("stage2", 2), ("serve.d2h", 7))),
                         ("train.step", (("train.frozen_forward", 4),
                                         ("train.net_forward", 6),
                                         ("train.backward", 20),
                                         ("train.optimizer", 3)))):
        for u in range(units):
            rid, t = next(ids), 10 ** 4 * MS * (u + 1)
            start = t
            for name, ms in phases:
                add(Record(name, t, t + ms * MS, next(ids), rid, u, 1))
                t += ms * MS
            add(Record(root, start, t + MS, rid, None, u, 1))


def reading(name, units=4):
    return harness.load_reader(name)(types.SimpleNamespace(
        traced_units=units))


def test_readers_on_hand_made_spans():
    fill(4)
    want = {"h2d_ms.serve": 3.0, "dispatch_ms.serve": 7.0,
            "d2h_wait_ms.serve": 7.0, "forward_host_ms.train": 10.0,
            "backward_host_ms.train": 20.0, "optimizer_host_ms.train": 3.0,
            "model_setup_s": 1.5}
    for name, value in want.items():
        assert reading(name) == pytest.approx(value, rel=1e-12), name


def test_other_root_count_reads_nothing():
    fill(4)
    for name in SERVE + TRAIN:
        assert reading(name, units=5) is None, name


def test_dropped_record_reads_nothing(monkeypatch):
    fill(4)
    monkeypatch.setattr(profiling._RECORDER, "limit",
                        len(profiling.records()))
    profiling._RECORDER.add(Record("x", 0, 1, -1, None, None, 1))
    assert profiling.dropped() == 1
    for name in ALL:
        assert reading(name) is None, name


def test_absent_spans_read_nothing(monkeypatch):
    """A program without the spans: none recorded, or a profiling module
    without `summary`."""
    for name in ALL:
        assert reading(name) is None, name
    fill(4)
    monkeypatch.delattr(profiling, "summary")
    for name in ALL:
        assert reading(name) is None, name


@pytest.mark.parametrize("cell,names,root", [
    ("r18.serve-b32", SERVE, "serve.request"),
    ("r18.train2-b32", TRAIN, "train.step")])
def test_traced_tiny_run_reads_every_span(cell, names, root):
    """The phases lie inside their root span, so their sum a unit is at
    most the root's mean; set-up is read too."""
    c = tiny_cell(cell)
    metrics = run(c, trace=True)["metrics"]
    for name in names + ("model_setup_s",):
        assert math.isfinite(metrics[name]["value"]), name
        assert metrics[name]["value"] > 0, name
    s = profiling.summary()
    assert s[root]["count"] == c.traffic["trace_units"]
    mean = s[root]["total_ms"] / s[root]["count"]
    assert sum(metrics[n]["value"] for n in names) <= mean
