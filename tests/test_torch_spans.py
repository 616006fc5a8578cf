"""The program's spans (`egotap_tpu_torch/utils/profiling.py`): off they
record nothing and open no profiler range; on, a request and a training
step leave their phases under one root; the recorded times sit on the
profiler trace's clock; set-up spans always record; the buffer's bound
drops and counts; `summary`'s totals and self times. Counters add up per
root span and share the bound; an int8 request leaves its ``int8.*``
spans and counters, a bfloat16 one none; calibration is a set-up span."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from egotap_tpu_torch import ops
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.ops import pu_kernel
from egotap_tpu_torch.serving import Predictor, serving_config
from egotap_tpu_torch.train.tasks import LifterTask
from egotap_tpu_torch.utils import profiling
from egotap_tpu_torch.utils.profiling import Record

SMALL = dict(num_heatmap=4, num_rot_heatmap=4, ae_hidden_size=32,
             load_size_heatmap=(16, 16))
LIFTER = dict(model="egotap_autoencoder", num_heatmap=15, num_rot_heatmap=15,
              heatmap_type="sin", skel_layer="PU", ae_hidden_size=8,
              load_size_heatmap=(16, 16), batch_size=2,
              optimizer_type="AdamW", lr=1e-4, niter=1, niter_decay=1)
SERVE = ("serve.h2d", "stage1", "stage2", "serve.d2h")
STEP = ("train.frozen_forward", "train.net_forward", "train.backward",
        "train.optimizer")


@pytest.fixture(autouse=True)
def clean():
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


def rgb(batch=2, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, 2, size, size, 3)).astype(np.float32)


def lifter_batch():
    rng = np.random.default_rng(1)
    return {"input_rgb": rgb(),
            "gt_local_pose": (10 * rng.standard_normal((2, 16, 3))).astype(
                np.float32)}


@pytest.fixture(scope="module")
def predictor():
    return Predictor(serving_config(**SMALL), bf16=False, device="cpu")


@pytest.fixture(scope="module")
def lifter():
    task = LifterTask(Config(**LIFTER).derive(), device="cpu")
    return task, task.init_state(seed=0, iters_per_epoch=2)


def children(recs, parent):
    """The spans opened inside ``parent`` on its thread, by start."""
    return sorted((r for r in recs if r.parent == parent.id),
                  key=lambda r: r.start_ns)


def test_off_records_nothing_and_opens_no_range(monkeypatch, predictor,
                                                lifter):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with recording off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    predictor(rgb())
    task, state = lifter
    task.train_step(state, lifter_batch())
    assert profiling.records() == [] and profiling.dropped() == 0
    assert profiling.span("stage1") is profiling.span("train.step", root=3)


def test_request_holds_its_phases(predictor):
    profiling.enable()
    predictor(rgb())
    recs = profiling.records()
    (req,) = [r for r in recs if r.name == "serve.request"]
    kids = children(recs, req)
    assert tuple(r.name for r in kids) == SERVE
    assert {r.root for r in recs} == {req.root} and req.root is not None
    assert all(req.start_ns <= r.start_ns <= r.end_ns <= req.end_ns
               for r in kids)
    assert len(recs) == 5


def test_request_numbers_count_up(predictor):
    profiling.enable()
    predictor(rgb())
    predictor(rgb())
    roots = [r.root for r in profiling.records() if r.name == "serve.request"]
    assert roots[1] == roots[0] + 1


def test_step_holds_its_phases(lifter):
    task, state = lifter
    profiling.enable()
    step = state.step
    task.train_step(state, lifter_batch())
    recs = profiling.records()
    (root,) = [r for r in recs if r.name == "train.step"]
    assert root.root == step
    assert tuple(r.name for r in children(recs, root)) == STEP
    assert {r.root for r in recs} == {step}
    assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
               for r in recs)


def test_spans_sit_on_the_trace_clock(tmp_path):
    """A span's recorded start and end lie within 1 ms of its range's in
    the exported trace. A first span warms the profiler's range path up
    (its first call in a process sets itself up, for milliseconds under
    load)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("warm-up"):
            pass
        with profiling.span("probe"):
            time.sleep(0.02)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    (event,) = [e for e in doc["traceEvents"]
                if e.get("name") == "egotap.probe"]
    assert event["cat"] == "user_annotation"
    (rec,) = [r for r in profiling.records() if r.name == "probe"]
    start_us = event["ts"] + doc.get("baseTimeNanoseconds", 0) / 1e3
    assert abs(rec.start_ns / 1e3 - start_us) < 1e3
    assert abs(rec.end_ns / 1e3 - (start_us + event["dur"])) < 1e3
    assert rec.end_ns - rec.start_ns >= 20e6


def test_recompute_range_keeps_its_label():
    """`ops.plain_vjp`'s span is the kernel's `BACKWARD_LABEL` range, by
    exactly that name, in a profiler's trace."""
    from torch.profiler import profile
    x = torch.ones(3)
    with profile() as prof:
        (g,) = ops.plain_vjp(lambda t: 2 * t, (x,), (True,), torch.ones(3),
                             pu_kernel.BACKWARD_LABEL)
    assert torch.equal(g, torch.full((3,), 2.0))
    assert pu_kernel.BACKWARD_LABEL in {e.name for e in prof.events()}
    assert [r.name for r in profiling.records()] == [pu_kernel.BACKWARD_LABEL]


def test_setup_records_with_recording_off():
    Predictor(serving_config(**SMALL), bf16=False, device="cpu")
    LifterTask(Config(**LIFTER).derive(), device="cpu").init_state(
        seed=0, iters_per_epoch=2)
    recs = profiling.records()
    assert [r.name for r in recs] == ["setup.model", "setup.model"]
    assert all(r.end_ns > r.start_ns for r in recs)


def test_root_reaches_other_threads():
    """A span opened on another thread (autograd's, in a backward on the
    card) while a root span is open shares its identifier; its parent is
    the innermost span open on its own thread."""
    profiling.enable()
    with profiling.span("train.step", root=7):
        t = threading.Thread(target=lambda: profiling.span("other")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    other, step = profiling.records()
    assert (other.name, other.root, other.parent) == ("other", 7, None)
    assert other.thread != step.thread and step.root == 7
    with profiling.span("after"):
        pass
    assert profiling.records()[-1].root is None


def test_bound_drops_and_counts(monkeypatch):
    monkeypatch.setattr(profiling._RECORDER, "limit", 3)
    profiling.enable()
    for _ in range(5):
        with profiling.span("x"):
            pass
    assert len(profiling.records()) == 3 and profiling.dropped() == 2
    profiling.reset()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_summary_totals_and_self_times():
    """An outer span of 10 ms holding a child of 4 ms holding one of its
    own name of 1 ms; a lone span of 2 ms on another thread."""
    ms = 10 ** 6
    for r in (Record("inner", 3 * ms, 4 * ms, 2, 1, 5, 1),
              Record("inner", 2 * ms, 6 * ms, 1, 0, 5, 1),
              Record("outer", 0, 10 * ms, 0, None, 5, 1),
              Record("inner", 0, 2 * ms, 3, None, 5, 2)):
        profiling._RECORDER.add(r)
    s = profiling.summary()
    assert s["outer"] == {"count": 1, "total_ms": 10.0, "self_ms": 6.0}
    assert s["inner"] == {"count": 3, "total_ms": 6.0, "self_ms": 6.0}


@pytest.fixture(scope="module")
def int8_requests():
    """One int8 predictor's recordings: a request before calibration
    (dynamic scales), its calibration with recording off, a request after
    (static scales); as (records, counters) each. One intra-op thread: the
    suite runs files in parallel workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    pred = Predictor(serving_config(**SMALL), bf16=False, int8=True,
                     device="cpu")
    out = {}
    try:
        for name, step in (("dynamic", lambda: pred(rgb())),
                           ("calibrate",
                            lambda: pred.calibrate([rgb(seed=3)])),
                           ("static", lambda: pred(rgb()))):
            profiling.reset()
            if name != "calibrate":
                profiling.enable()
            step()
            profiling.disable()
            out[name] = (profiling.records(), profiling.counters())
    finally:
        profiling.disable()
        profiling.reset()
        torch.set_num_threads(threads)
    return out


def test_counters_add_up_per_root():
    profiling.enable()
    profiling.count("outside", 2)
    for root in (1, 2):
        with profiling.span("serve.request", root=root):
            profiling.count("int8.macs", 10 * root)
            with profiling.span("stage1"):
                profiling.count("int8.macs", 1)
                profiling.count("int8.products")
    with profiling.span("train.step", root=9):
        profiling.count("int8.products", 3)
    profiling.count("outside")
    assert profiling.counters() == {
        None: {"outside": 3},
        "serve.request": {"int8.macs": 32, "int8.products": 2},
        "train.step": {"int8.products": 3}}
    profiling.disable()
    profiling.count("outside")
    assert profiling.counters()[None] == {"outside": 3}


def test_counts_drop_past_the_bound(monkeypatch):
    monkeypatch.setattr(profiling._RECORDER, "limit", 3)
    profiling.enable()
    with profiling.span("x"):
        for _ in range(4):
            profiling.count("n")
    # three counts fill the buffer: the fourth and the span closing after
    # them are dropped
    assert profiling.counters() == {None: {"n": 3}}
    assert profiling.records() == [] and profiling.dropped() == 2
    profiling.reset()
    assert profiling.counters() == {} and profiling.dropped() == 0


def test_int8_request_holds_its_products(int8_requests):
    """Static scales: every quantised conv and dense of the request runs
    in ``int8.conv`` / ``int8.dense`` holding one ``int8.matmul``, each
    product counted once; a bfloat16 request records no int8 span or
    counter."""
    recs, counters = int8_requests["static"]
    (req,) = [r for r in recs if r.name == "serve.request"]
    by_id = {r.id: r for r in recs}
    calls = [r for r in recs if r.name in ("int8.conv", "int8.dense")]
    products = [r for r in recs if r.name == "int8.matmul"]
    assert all(by_id[r.parent].name in ("int8.conv", "int8.dense")
               for r in products)
    assert {r.root for r in calls + products} == {req.root}
    counts = counters["serve.request"]
    assert counts["int8.products"] == len(products) > 0
    assert counts["int8.macs"] > 0 and "int8.float_convs" not in counts
    # a ViT layer's q, k and v share one quantisation: 3 stubs, 3 products
    # more than their dense calls
    stubs = [r for r in calls if r.name == "int8.dense"
             and not any(p.parent == r.id for p in products)]
    assert len(stubs) == 3 and len(calls) == len(products) + 3
    profiling.enable()
    Predictor(serving_config(**SMALL), bf16=True, device="cpu")(rgb())
    names = {r.name for r in profiling.records()}
    assert not {n for n in names if n.startswith("int8.")}
    assert profiling.counters() == {}


def test_dynamic_scales_count_float_convs(int8_requests):
    """Before calibration the 64-channel convolutions of an int8 net run
    as float convolutions, and are counted (the stem is no int8 conv)."""
    counts = int8_requests["dynamic"][1]["serve.request"]
    # per net: layer1's 4 convolutions and layer2's first conv1 and
    # downsample read 64 channels
    assert counts["int8.float_convs"] == 2 * 6


def test_calibrate_records_without_a_profiler(int8_requests):
    recs, counters = int8_requests["calibrate"]
    assert [r.name for r in recs] == ["setup.calibrate"]
    assert recs[0].end_ns > recs[0].start_ns
    assert counters == {}
