"""The port's smaller offline pieces against the JAX package's: the
random search through the port's `train_main` on the CPU
(`train/search.py`), the image helpers (`utils/images.py`), the camera's
tensor path and calibration cache (`core/camera.py`), the skeleton's bone
helpers (`core/skeleton.py`), the unused reference losses
(`train/losses.py`) and the Welford accumulators (`eval/metrics.py`).
The cases mirror tests/test_search.py, test_utils.py, test_camera.py,
test_skeleton.py, test_misc_modules.py and test_losses_metrics.py."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from egotap_tpu.core import camera as j_camera
from egotap_tpu.core import skeleton as j_skeleton
from egotap_tpu.eval import metrics as j_metrics
from egotap_tpu.train import losses as j_losses
from egotap_tpu.train import search as j_search
from egotap_tpu.utils import images as j_images
from egotap_tpu_torch.core import camera, skeleton
from egotap_tpu_torch.data.synthetic import generate_dataset, synthetic_config
from egotap_tpu_torch.eval import metrics
from egotap_tpu_torch.train import losses, search
from egotap_tpu_torch.utils import images
from tests.test_torch_preprocess import same


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("search") / "data")
    generate_dataset(root, "UnrealEgo", num_sequences=1, frames_per_seq=5,
                     image_size=16)
    return root


def _search_config(root, tmp_path, name, niter, niter_decay):
    return synthetic_config(
        root, model="heatmap_shared", num_heatmap=15, num_rot_heatmap=0,
        heatmap_type="none", load_size_heatmap=(16, 16), batch_size=4,
        niter=niter, niter_decay=niter_decay, lr=1e-4,
        log_dir=str(tmp_path / "log"), result_dir=str(tmp_path / "results"),
        experiment_name=name)


def test_sample_overrides_match_jax():
    space = {"lr": [1e-3, 1e-4, 3e-5], "batch_size": [2, 4],
             "weight_decay": lambda rng: float(rng.uniform(0, 1e-2))}
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(4):
        same(search.sample_overrides(space, a),
             j_search.sample_overrides(space, b))


def test_best_validation_metric(tmp_path):
    d = tmp_path / "exp" / "summary"
    d.mkdir(parents=True)
    with open(d / "metrics.jsonl", "w") as f:
        for step, v in enumerate([5.0, 3.0, 4.0]):
            f.write(json.dumps({"tag": "Validation/mpjpe", "value": v,
                                "step": step}) + "\n")
        f.write("not json\n")
    for mod in (search, j_search):
        assert mod._best_validation_metric(str(tmp_path / "exp"),
                                           "mpjpe") == 3.0
        assert mod._best_validation_metric(str(tmp_path / "none"),
                                           "mpjpe") == float("inf")


def test_random_search_through_train_main(dataset, tmp_path):
    """Two trials of the port's training loop on the CPU, each scored by
    its best validation mse_heatmap; the overrides are JAX's for the same
    seed."""
    cfg = _search_config(dataset, tmp_path, "hs", 1, 0)
    space = {"lr": [1e-4, 5e-5]}
    best = search.random_search(cfg, space, num_trials=2,
                                criteria="mse_heatmap", device="cpu")
    assert 0 < best["score"] < float("inf")
    with open(tmp_path / "log" / "hs_search" / "search_results.json") as f:
        results = json.load(f)
    rng = np.random.default_rng(0)
    assert [r["overrides"] for r in results] == [
        j_search.sample_overrides(space, rng) for _ in range(2)]
    assert best == min(results, key=lambda r: r["score"])
    assert os.path.isdir(tmp_path / "log" / "hs_search" / "t001" /
                         "ckpt_best")


def test_random_search_external_tuner_early_stop(dataset, tmp_path):
    """A scheduler that stops every trial after its first epoch (of 3);
    trials still score on what they reached."""
    cfg = _search_config(dataset, tmp_path, "es", 2, 1)
    seen = []

    def scheduler(trial, report):
        seen.append((trial, report["epoch"]))
        return True

    best = search.random_search(cfg, {"lr": [1e-4, 5e-5]}, num_trials=2,
                                criteria="mse_heatmap",
                                epoch_callback=scheduler, device="cpu")
    assert best["score"] < float("inf")
    assert seen == [(0, 1), (1, 1)]


class TestImages:
    def test_match_jax(self, rng):
        x = rng.random((8, 8, 3)).astype(np.float32)
        same(images.normalize_imagenet(x), j_images.normalize_imagenet(x))
        n = images.normalize_imagenet(x)
        same(images.denormalize_imagenet(n), j_images.denormalize_imagenet(n))
        np.testing.assert_allclose(images.denormalize_imagenet(n), x,
                                   atol=1e-6)
        hm = rng.random((4, 4, 3)).astype(np.float32)
        for kw in ({}, {"is_heatmap": True}, {"is_depth": True}):
            same(images.tensor2im(n if not kw else hm, **kw),
                 j_images.tensor2im(n if not kw else hm, **kw))
        cos, sin = rng.normal(size=(2, 5, 6)).astype(np.float32)
        same(images.convert_norm_angle_to_rgb(cos, sin),
             j_images.convert_norm_angle_to_rgb(cos, sin))

    def test_heatmap_sum_clamped(self):
        hm = np.zeros((4, 4, 3), np.float32)
        hm[1, 1, :2] = 0.7, 0.9
        img = images.tensor2im(hm, is_heatmap=True)
        assert img.shape == (4, 4, 1)
        assert img[1, 1, 0] == 255 and img[0, 0, 0] == 0

    def test_save_image(self, tmp_path, rng):
        for shape in ((8, 8, 3), (8, 8, 1)):
            img = (rng.random(shape) * 255).astype(np.uint8)
            images.save_image(img, str(tmp_path / "port.png"))
            j_images.save_image(img, str(tmp_path / "jax.png"))
            assert (tmp_path / "port.png").read_bytes() == \
                (tmp_path / "jax.png").read_bytes()


def _ocam(name):
    o = camera.synthetic_calibration(name=name)
    return camera.OcamModel(pol=o.pol, invpol=o.invpol, xc=o.xc + 3.0,
                            yc=o.yc - 2.0, c=1.01, d=0.002, e=-0.003,
                            name=name)


# the tensor path in f32 against JAX's jnp path, the same operations in
# f32 in another library: pixels read up to 6.1e-5 (an f32 ulp at 512),
# rays up to 2.5e-4 over five seeds (the synthetic degree-9 polynomial
# amplifies f32 rounding ~1e6 times, tests/test_camera.py:91-94, whose
# f32-vs-f64 budgets the twin comparison below takes)
PX_ATOL, RAY_ATOL = 1e-3, 1e-3


@pytest.mark.parametrize("name", ["fisheye", "unreal_ego_pose"])
def test_camera_tensor_path_matches_jax(name, rng):
    o = _ocam(name)
    jo = j_camera.OcamModel(**{f: getattr(o, f) for f in (
        "pol", "invpol", "xc", "yc", "c", "d", "e", "width", "height",
        "radius", "name")})
    pts3 = (rng.normal(size=(32, 3)) * 20.0 + [0, 0, -40.0]).astype(
        np.float32)
    pts3[0] = [0.0, 0.0, -10.0]                # on the optical axis
    pts2 = rng.uniform(100, 900, size=(32, 2)).astype(np.float32)
    px = camera.world2cam(torch.from_numpy(pts3), o)
    ray = camera.cam2world(torch.from_numpy(pts2), o)
    assert px.dtype == ray.dtype == torch.float32
    np.testing.assert_allclose(px.numpy(), np.asarray(j_camera.world2cam(
        jnp.asarray(pts3), jo)), atol=PX_ATOL)
    np.testing.assert_allclose(ray.numpy(), np.asarray(j_camera.cam2world(
        jnp.asarray(pts2), jo)), atol=RAY_ATOL)
    np.testing.assert_allclose(px.numpy(), camera.world2cam_np(
        pts3.astype(np.float64), o), rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(ray.numpy(), camera.cam2world_np(
        pts2.astype(np.float64), o), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(px[0].numpy(), [o.xc, o.yc])


def test_calibration_cache_keyed_by_directory(tmp_path):
    """The reference's cache is keyed only by side (utils/projection.py:
    15, 52); the port's, like JAX's, by (dir, side)."""
    cache = camera.CalibrationCache()
    for i, d in enumerate(("a", "b")):
        os.makedirs(tmp_path / d)
        with open(tmp_path / d / "fisheye.calibration_left.json", "w") as f:
            json.dump(camera.calibration_to_dict(
                camera.synthetic_calibration(f=200.0 + 100 * i)), f)
    o1 = cache.get(str(tmp_path / "a"), "left")
    o2 = cache.get(str(tmp_path / "b"), "left")
    assert not np.allclose(o1.invpol, o2.invpol)
    assert cache.get(str(tmp_path / "a"), "left") is o1
    want = j_camera.CalibrationCache().get(str(tmp_path / "b"), "left")
    same(o2.invpol, want.invpol)
    cache.clear()
    assert cache.get(str(tmp_path / "a"), "left") is not o1


@pytest.mark.parametrize("preset", ["UnrealEgo", "EgoCap"])
def test_skeleton_helpers_match_jax(preset, rng):
    sk, jsk = skeleton.get_skeleton(preset), j_skeleton.get_skeleton(preset)
    sk.validate()
    assert sk.num_bones == jsk.num_bones == sk.num_joints - 1
    same(sk.parents_array(), jsk.parents_array())
    same(sk.bone_pairs(), jsk.bone_pairs())
    assert sk.limb_mask_indices == jsk.limb_mask_indices
    pose = rng.normal(size=(2, sk.num_joints, 3)).astype(np.float32)
    same(skeleton.bone_vectors(pose, sk.parents_array()),
         j_skeleton.bone_vectors(pose, jsk.parents_array()))
    np.testing.assert_array_equal(
        skeleton.bone_vectors(torch.from_numpy(pose), sk.parents_array()),
        j_skeleton.bone_vectors(pose, jsk.parents_array()))
    broken = skeleton.Skeleton("x", ("a", "b"), (0, 2), True, True)
    with pytest.raises(ValueError):
        broken.validate()


@pytest.mark.parametrize("preset", ["UnrealEgo", "EgoCap"])
def test_bone_length_loss_matches_jax(preset, rng):
    parents = skeleton.get_skeleton(preset).parents_array()
    pred, gt = rng.normal(size=(2, 3, len(parents), 3)).astype(np.float32)
    gt[:, 4] = gt[:, parents[4]]                   # a zero-length bone
    got = losses.bone_length_loss(torch.from_numpy(pred),
                                  torch.from_numpy(gt), parents)
    want = j_losses.bone_length_loss(jnp.asarray(pred), jnp.asarray(gt),
                                     parents)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_l1_regularizer_matches_jax():
    module = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.Conv2d(2, 1, 1))
    torch.manual_seed(0)
    for p in module.parameters():
        p.data.normal_()
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in module.named_parameters()}
    np.testing.assert_allclose(losses.l1_regularizer(module).item(),
                               float(j_losses.l1_regularizer(params)),
                               rtol=1e-6)
    tiny = torch.nn.Linear(1, 2)
    with torch.no_grad():
        tiny.weight.copy_(torch.tensor([[1.0], [-2.0]]))
        tiny.bias.copy_(torch.tensor([3.0, 0.0]))
    assert losses.l1_regularizer(tiny).item() == 6.0


def test_running_std_matches_jax(rng):
    vals = rng.normal(size=50)
    got, want = metrics.RunningAverageStd(), j_metrics.RunningAverageStd()
    for chunk in np.split(vals, 5):
        got.update(chunk)
        want.update(chunk)
    assert (got.mean, got.std, got.count) == (want.mean, want.std,
                                              want.count)
    assert got.std == pytest.approx(vals.std(ddof=1), rel=1e-6)
    with pytest.raises(ValueError):
        metrics.RunningAverageStd().std


def test_array_running_std_matches_jax(rng):
    got, want = metrics.ArrayRunningStd(), j_metrics.ArrayRunningStd()
    frames = rng.normal(size=(6, 4, 3))
    for f in frames:
        got.update(f)
        want.update(f)
    same(got.mean, want.mean)
    same(got.std, want.std)
    np.testing.assert_allclose(got.std, frames.std(axis=0, ddof=1),
                               rtol=1e-10)
    single = metrics.ArrayRunningStd()
    single.update(frames[0])
    with pytest.raises(ValueError):
        single.std
