"""The port's `evaluate` (egotap_tpu_torch.eval.evaluate) against the JAX
package's, for both tasks, on a state carried from JAX
(`compat.from_jax.task_state_from_jax`), over a synthetic test split of
10 frames at batch 4 (the last batch padded and masked): the mean
metrics, the per-sample stats and the saved pose, gt and path files,
within rtol 1e-5 (f32; docs/PARITY_TABLE.md). Small size: 16 x 16 maps,
64-px RGB, resnet18 heatmap nets, a lifter of hidden 8. The three result
writers give JAX's text for the same input."""

import os
import pickle
import types

import jax
import numpy as np
import pytest
import torch

from egotap_tpu.data.synthetic import synthetic_config as jax_synthetic_config
from egotap_tpu.eval import evaluate as jax_eval
from egotap_tpu.train.tasks import create_task as jax_create_task
from egotap_tpu_torch.compat.from_jax import task_state_from_jax
from egotap_tpu_torch.data.synthetic import generate_dataset, synthetic_config
from egotap_tpu_torch.eval import evaluate as port_eval
from egotap_tpu_torch.train.tasks import create_task
from tests.test_torch_compat import heatmap_vars


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test files run in parallel processes, and
    PyTorch's default of a thread per core in each of them oversubscribes
    the cores many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


RTOL = 1e-5
FIELDS = {
    "heatmap": dict(model="heatmap_shared", num_heatmap=15,
                    num_rot_heatmap=0, heatmap_type="none"),
    "limb": dict(model="heatmap_shared", num_heatmap=0, num_rot_heatmap=15,
                 heatmap_type="sin"),
    "lifter": dict(model="egotap_autoencoder", num_heatmap=15,
                   num_rot_heatmap=15, heatmap_type="sin", skel_layer="PU",
                   ae_hidden_size=8),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("eval_data"))
    generate_dataset(path, "UnrealEgo", num_sequences=2, frames_per_seq=5,
                     image_size=16)
    return path


def _configs(root, kind, out):
    fields = dict(load_size_heatmap=(16, 16), batch_size=4,
                  data_parallel=1, **FIELDS[kind])
    return (synthetic_config(root, result_dir=os.path.join(out, "port"),
                             **fields),
            jax_synthetic_config(root, result_dir=os.path.join(out, "jax"),
                                 patched_heatmap_ae=True, **fields))


def _jax_state(kind, jtask):
    rng = jax.random.PRNGKey(0)
    if kind == "lifter":
        return jtask.init_state(rng, 1, heatmap_vars=heatmap_vars(15, 64),
                                rot_heatmap_vars=heatmap_vars(30, 64))
    state = jtask.init_state(rng, 1)
    v = heatmap_vars(15 if kind == "heatmap" else 30, 64)   # non-zero biases
    return state.replace(params=v["params"], batch_stats=v["batch_stats"])


def _close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max()
    assert err <= RTOL * np.abs(want).max(), (name, err)


@pytest.mark.parametrize("kind", ["heatmap", "limb", "lifter"])
def test_evaluate_matches_jax(root, kind, tmp_path):
    cfg, jcfg = _configs(root, kind, str(tmp_path))
    jtask = jax_create_task(jcfg)
    jstate = _jax_state(kind, jtask)
    want, want_stats, _ = jax_eval.evaluate(jcfg, jtask, jstate, mode="test",
                                            save_result=True)
    state = task_state_from_jax(jstate, cfg, 1, device="cpu")
    task = create_task(cfg, device="cpu")
    got, stats, pps = port_eval.evaluate(cfg, task, state, mode="test",
                                         save_result=True, device="cpu")
    assert pps > 0 and list(got) == list(want) == \
        (["mpjpe", "pa_mpjpe"] if kind == "lifter" else ["mse_heatmap"])
    for k in want:
        assert abs(got[k] - want[k]) <= RTOL * abs(want[k]), k
        assert len(stats[k]) == len(want_stats[k]) == 10
        _close(stats[k], want_stats[k], k)

    ours, ref = cfg.results_dir, jcfg.results_dir
    if kind != "lifter":                    # no pose: nothing written
        assert not os.path.exists(ours)
        return
    _close(np.load(os.path.join(ours, "pred_pose.npy")),
           np.load(os.path.join(ref, "pred_pose.npy")), "pred_pose")
    gt_file = f"gt_{os.path.basename(root).lower()}_pose.npy"
    gt = np.load(os.path.join(ours, os.pardir, gt_file))
    assert gt.shape == (10, 16, 3)
    np.testing.assert_array_equal(
        gt, np.load(os.path.join(ref, os.pardir, gt_file)))
    with open(os.path.join(ours, "input_paths.pkl"), "rb") as f:
        paths = pickle.load(f)
    with open(os.path.join(ref, "input_paths.pkl"), "rb") as f:
        ref_paths = pickle.load(f)
    assert paths.shape == (10, 1) and paths.tolist() == ref_paths.tolist()

    # one motion category, and an empty one
    cat, _, _ = port_eval.evaluate(cfg, task, state, mode="test",
                                   category_id="002", device="cpu")
    ref_cat, _, _ = jax_eval.evaluate(jcfg, jtask, jstate, mode="test",
                                      category_id="002")
    for k in ref_cat:
        assert abs(cat[k] - ref_cat[k]) <= RTOL * abs(ref_cat[k]), k
    assert port_eval.evaluate(cfg, task, state, mode="test",
                              category_id="030", device="cpu") == ({}, {}, 0.0)


def test_evaluate_refuses_another_device(root, tmp_path):
    cfg, _ = _configs(root, "heatmap", str(tmp_path))
    task = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="task runs on cuda"):
        port_eval.evaluate(cfg, task, None, device="cpu")


def test_result_writers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    stats = {"mpjpe": rng.random(7).astype(np.float32).tolist(),
             "pa_mpjpe": rng.random(7).tolist()}
    metrics = {"mpjpe": 81.25, "pa_mpjpe": float(rng.random())}
    for side, mod in (("port", port_eval), ("jax", jax_eval)):
        d = tmp_path / side / "results"
        mod.write_detail_result(str(d / "detail_result.txt"), stats)
        mod.write_categorical_header(str(d / "categorical_result.txt"),
                                     metrics)
        for key, name, n in (("001", "jumping", 3), ("002", "falling", 1)):
            mod.append_categorical_result(str(d / "categorical_result.txt"),
                                          key, name, n, metrics)
        mod.write_detail_result(str(d / "empty.txt"), {})
    for name in ("detail_result.txt", "categorical_result.txt", "empty.txt"):
        ours = (tmp_path / "port" / "results" / name).read_text()
        assert ours == (tmp_path / "jax" / "results" / name).read_text()
    assert len(ours.splitlines()) == 1
    detail = (tmp_path / "port" / "results" / "detail_result.txt")
    assert len(detail.read_text().splitlines()) == 8


def test_evaluate_calibrates_int8_scales(root, tmp_path, capsys):
    """With the int8 flags and ``calib_batches``, `evaluate` calibrates
    static scales on the split's first batches (`prepare_inference`): the
    same metrics as a state prepared on those batches beforehand, which
    `evaluate` then takes as it is."""
    from egotap_tpu_torch.data.pipeline import (make_device_preprocess,
                                                make_loader)
    cfg, _ = _configs(root, "lifter", str(tmp_path))
    cfg.int8_heatmap_inference = cfg.int8_lifter_inference = True
    cfg.calib_batches = 1
    task = create_task(cfg, device="cpu")
    state = task.init_state(0, 1)
    got, stats, _ = port_eval.evaluate(cfg, task, state, mode="test",
                                       device="cpu")
    assert "calibrated static (1 batches)" in capsys.readouterr().out
    assert state.inference is None                 # the caller's state
    batch = next(iter(make_loader(cfg, "test")))
    feed = make_device_preprocess(cfg)(port_eval.to_device(batch, "cpu"))
    prepared = task.prepare_inference(state, [feed])
    assert prepared.inference._has_static_scales()
    want, _, _ = port_eval.evaluate(cfg, task, prepared, mode="test",
                                    device="cpu")
    assert got == want and np.isfinite(stats["mpjpe"]).all()
