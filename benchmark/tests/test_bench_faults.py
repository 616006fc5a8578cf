"""A run drives the program with its timed path broken underneath, and
`correct` comes out false: an answer altered where it is produced, half
of a batch left out, the lifter on float8 operands, a training step that
leaves its state unchanged, and a step whose loss is the mean over half
of its batch. The sound runs
beside them come out true. On the CPU, at the tiny size, against each
cell's own limits; the training cell runs in float32 here (at batch 2 its
bf16 loss reads above the limit set at batch 32)."""

import pytest
import torch

import egotap_tpu_torch.serving as serving
from egotap_tpu_torch.train import optim, tasks

from benchmark import control

from tiny import run, tiny_cell


def f32_training_cell():
    cell = tiny_cell("r18.train2-b32")
    cell.config["use_amp"] = False
    return cell


def test_sound_serving_run_is_correct():
    assert run(tiny_cell("r18.serve-b32"))["correct"]


def test_sound_training_run_is_correct():
    assert run(f32_training_cell())["correct"]


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_serving_faults_are_caught(monkeypatch, fault):
    sound = serving.pose_forward

    def broken(nets, rgb, dtype):
        if fault == "half_batch":    # the second half never computed
            half = sound(nets, rgb[: (len(rgb) + 1) // 2], dtype)
            return torch.cat([half, half])[: len(rgb)]
        out = sound(nets, rgb, dtype)
        out[0, 3] = -out[0, 3]       # one joint of one answer altered
        return out

    monkeypatch.setattr(serving, "pose_forward", broken)
    res = run(tiny_cell("r18.serve-b32"))
    assert not res["correct"], res["checks"]


def test_every_answer_offset_is_caught(monkeypatch):
    sound = serving.pose_forward

    def broken(nets, rgb, dtype):
        out = sound(nets, rgb, dtype)
        return out + 0.5 * out.abs().amax()

    monkeypatch.setattr(serving, "pose_forward", broken)
    assert not run(tiny_cell("r18.serve-b32"))["correct"]


def test_stage2_in_float8_is_caught():
    # the reference lifter on float8 operands in the program's lifter's
    # place: the heatmaps and the pose pass, the lifter's features do not
    res = run(tiny_cell("r18.serve-b32"), program=control.fp8_lifter_program)
    assert not res["correct"], res["checks"]
    skel = res["checks"]["skel_rms"]
    assert skel["value"] > skel["limit"], res["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch_mean"])
def test_training_faults_are_caught(monkeypatch, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(optim.Optimizer, "step",
                            lambda self, params, grads: None)
    else:
        sound = tasks._Task._batch

        def half(self, batch):
            return {k: v[: len(v) // 2] for k, v in sound(self, batch).items()}
        monkeypatch.setattr(tasks._Task, "_batch", half)
    res = run(f32_training_cell())
    assert not res["correct"], res["checks"]
