"""The controls fail the check, at the cells' own sizes, on the card: the
program's int8 path in place of the bf16 serving path, the reference lifter
with float8 operands in place of the program's lifter, and the reference
with float8 operands (or with the loss over half of each batch) in place
of the bf16 training step. Skips without a card."""

import time

import pytest
import torch

from benchmark import control, harness

SEED = 3000009001


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["r18.serve-b32", "r50.serve-b32"])
@pytest.mark.parametrize("program", ["int8_program", "fp8_lifter_program"])
def test_lower_precision_fails_the_serving_check(workload, program):
    card()
    cell = harness.load_cell(workload)
    res = harness.run_cell(cell, SEED, 1.0, False, "cuda",
                           time.perf_counter(), {},
                           program=getattr(control, program),
                           log=lambda m: None)
    assert not res["correct"], res["checks"]
    if program == "fp8_lifter_program":     # stage 2's own number fails
        assert res["checks"]["skel_rms"]["value"] > \
            res["checks"]["skel_rms"]["limit"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["control", "fault"])
def test_training_control_and_fault_fail_the_check(mode):
    card()
    cell = harness.load_cell("r18.train2-b32")
    readings = control.train_readings(cell, SEED, "cuda", mode)
    assert any(readings[k] > limit for k, limit in cell.limits.items()), \
        readings
