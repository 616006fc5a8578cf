"""The int8 serving cell on the CPU: its traffic file against its driver, a
tiny run end to end with both checks, and the four int8 readers, on the
tiny run and on a hand-made trace (the CPU has no device kernels)."""

import math
import types

import pytest

from benchmark import bounds_int8, harness, spans
from benchmark import reference_int8 as Q
from benchmark.drivers import serve
from egotap_tpu_torch.utils import profiling

from tiny import run, tiny_cell

CELL = "r18-int8.serve-b32"
INT8 = ("int8_mm_ms.serve", "int8_passes_ms.serve", "int8_mm_roofline.serve",
        "int8_coverage.serve")
PEAKS = {"bf16_flops_per_s": 9.89e14, "f32_flops_per_s": 6.7e13,
         "hbm_bytes_per_s": 3.35e12}


@pytest.fixture(autouse=True)
def clean():
    """Each run of the benchmark is a process of its own; here the
    spans an earlier test's traced run left would count as this one's."""
    profiling.reset()
    yield
    profiling.reset()


def test_traffic_keys_are_the_drivers():
    cell = harness.load_cell(CELL)
    driver = harness.driver_for(cell)
    assert set(cell.traffic) - {"kind", "about"} == set(serve.TRAFFIC)
    assert issubclass(driver, serve.Driver)
    assert cell.config["int8_heatmap_inference"]
    assert {"int8_heatmap_inference", "int8_lifter_inference"} <= set(
        cell.config["program"])
    assert [m["name"] for m in cell.per_layer][-4:] == list(INT8)


def test_tiny_cell_runs_end_to_end():
    """Both checks read; in bfloat16 on the CPU each int8 module of the
    program reads against the reference's exact product the rounding of
    its bfloat16 output alone. The traced run reads the coverage (100:
    every int8 product of the configuration ran in int8); without device
    kernels the trace's three readers read nothing."""
    cell = tiny_cell(CELL)
    res = run(cell, trace=True)
    r = res["readings"]
    for name in ("heatmap_rms", "skel_rms", "pose_max", "int8_product_rms",
                 "int8_skel_rms", "int8_pose_max", "int8_scale_gap"):
        assert math.isfinite(r[name]), name
    assert 0 < r["int8_product_rms"] < 4e-3
    assert r["int8_skel_rms"] < 2e-2 and r["int8_scale_gap"] < 0.1
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(cell.limits)
    m = res["metrics"]
    assert m["int8_coverage.serve"]["value"] == pytest.approx(100.0)
    assert not {"int8_mm_ms.serve", "int8_passes_ms.serve",
                "int8_mm_roofline.serve"} & set(m)


def fake_run(units=4):
    """A traced window of ``units`` requests: per request 2 ms of products
    inside the matmul ranges (nested in their calls), 5 ms of passes in
    the calls alone and 3 ms elsewhere."""
    calls, mm = "egotap.int8.conv", "egotap.int8.matmul"
    kernels = []
    for _ in range(units):
        kernels += [("gemm", 2e-3, frozenset({calls, mm})),
                    ("quantize", 4e-3, frozenset({calls})),
                    ("dequantize", 1e-3, frozenset({"egotap.int8.dense"})),
                    ("other", 3e-3, frozenset())]
    trace = spans.Trace(kernels, 10e-3 * units, 12e-3 * units, [], [], 0)
    return types.SimpleNamespace(
        trace=trace, traced_units=units, peaks=PEAKS,
        int8_matmul=("egotap.int8.matmul",),
        int8_calls=("egotap.int8.conv", "egotap.int8.dense"),
        int8_bound_per_unit=0.5e-3, int8_macs_per_unit=10)


def test_trace_readers_on_a_hand_made_trace():
    run_ = fake_run()
    read = {n: harness.load_reader(n)(run_) for n in INT8[:3]}
    assert read["int8_mm_ms.serve"] == pytest.approx(2.0)
    assert read["int8_passes_ms.serve"] == pytest.approx(5.0)
    assert read["int8_mm_roofline.serve"] == pytest.approx(25.0)
    # a program without the int8 spans, or a card of unknown peaks
    bare = fake_run()
    bare.trace = spans.Trace([("gemm", 1e-3, frozenset())], 1, 1, [], [], 0)
    assert all(harness.load_reader(n)(bare) is None for n in INT8[:3])
    run_.peaks = None
    assert harness.load_reader("int8_mm_roofline.serve")(run_) is None


def test_products_and_their_bound():
    cell = harness.load_cell(CELL)
    products = Q.int8_products(cell.config, 32)
    assert len(products) == 78
    # conv_up1 of a net: 32 images of 64 x 64, 640 x 9 in, 512 out
    assert (32 * 64 * 64, 512, 640 * 9) in products
    m, n, k = products[0]
    assert bounds_int8.product_bound(m, n, k, PEAKS) == max(
        2 * m * n * k / bounds_int8.INT8_OPS_PER_S,
        (m * k + n * k + 4 * m * n) / PEAKS["hbm_bytes_per_s"])
