"""The reduction of a profiler trace, on a hand-made Chrome trace."""

import torch

from benchmark import spans


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_kernels_ranges_busy_and_gaps():
    events = [
        ev("user_annotation", spans.WINDOW, 0, 100),
        ev("user_annotation", "bench.pos_net", 5, 20),
        ev("cpu_op", "aten::conv", 6, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 7, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 40, 1, tid=2, corr=3),
        ev("user_annotation", "kernel B backward", 35, 10, tid=2),
        ev("kernel", "conv_kernel", 10, 10, tid=7, corr=1),
        ev("kernel", "other_kernel", 15, 10, tid=8, corr=2),
        ev("kernel", "attention_bf16", 50, 5, tid=7, corr=3),
        ev("gpu_memcpy", "Memcpy HtoD", 60, 10, tid=7),
        ev("cpu_op", "aten::item", 70, 30),
    ]
    t = spans.reduce_trace(events)
    assert t.window_s == 100e-6
    # busy: [10, 25], [50, 55], [60, 70]
    assert abs(t.busy_s - 30e-6) < 1e-12
    assert abs(t.range_s("bench.pos_net") - 10e-6) < 1e-12
    assert abs(t.range_s("kernel B backward") - 5e-6) < 1e-12
    assert t.kernel_s("attention_") == (5e-6, 1)
    assert t.copies == 1 and len(t.kernels) == 3
    gaps = dict(t.idle_gaps)
    assert abs(gaps["aten::item"] - 30e-6) < 1e-12  # [70, 100]
    assert abs(sum(gaps.values()) - 70e-6) < 1e-12


def test_spans_open_and_close_around_modules():
    lin = torch.nn.Linear(2, 2)
    holder = type("H", (), {"step": staticmethod(lambda x: x + 1)})
    sp = spans.Spans()
    sp.module(lin, "bench.lin")
    sp.function(holder, "step", "bench.step")
    from torch.profiler import profile
    with profile() as prof:
        lin(torch.ones(1, 2))
        assert holder.step(1) == 2
    names = {e.name for e in prof.events()}
    assert {"bench.lin", "bench.step"} <= names
    sp.remove()
    assert holder.step(1) == 2 and not lin._forward_hooks
