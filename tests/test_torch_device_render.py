"""The port's target renderer and batch preprocess (egotap_tpu_torch.data)
and its stage-1 losses against the JAX package's, at f32 on the CPU.

Raw batches are drawn with numpy from a seed: 2D joints partly outside
the view (and one NaN), one bone of zero length in 2D and one in 3D.
The rendered maps agree within TOL: the port repeats the JAX twin's
operations in the same order, and what is left is f32 rounding (XLA
under `jit` multiplies by a constant's reciprocal where the port
divides: one ulp of a peak of 1.0 is 6e-8)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.core.skeleton import get_skeleton as jax_skeleton
from egotap_tpu.data import device_render as jdr
from egotap_tpu.data import heatmaps as jhm
from egotap_tpu.data.pipeline import make_device_preprocess as jax_preprocess
from egotap_tpu.train import losses as jlosses
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.data import device_render as dr
from egotap_tpu_torch.data import heatmaps as hm
from egotap_tpu_torch.data.pipeline import make_device_preprocess
from egotap_tpu_torch.train import losses

TOL = 1e-6          # rendered maps, pixel lengths, preprocess outputs


def raw_batch(rng, b=2, image=64, joints=16):
    """A raw batch as the loaders give it (NHWC rgb, 2D joints in
    1024-space, 3D pose and pelvis), with joints outside the view and
    zero-length bones."""
    c2d = {s: rng.uniform(-150, 1150, (b, joints, 2)).astype(np.float32)
           for s in ("left", "right")}
    c2d["left"][0, 3] = c2d["left"][0, 2]        # zero-length bone in 2D
    pose = rng.normal(0, 30, (b, joints, 3)).astype(np.float32)
    pose[-1, 4, :2] = pose[-1, 0, :2]            # zero-length bone in xy
    out = {f"input_rgb_{s}": rng.standard_normal(
               (b, image, image, 3)).astype(np.float32)
           for s in ("left", "right")}
    out.update({f"gt_camera_2d_{s}": v for s, v in c2d.items()})
    out.update({"gt_local_pose": pose,
                "gt_local_rot": rng.normal(0, 1, (b, joints, 3)).astype(
                    np.float32),
                "gt_pelvis_left": rng.normal(0, 5, (b, 3)).astype(np.float32),
                "gt_pelvis_right": rng.normal(0, 5, (b, 3)).astype(
                    np.float32),
                "mask": np.ones((b,), np.float32)})
    return out


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_constants_are_the_jax_packages():
    assert hm.GAUSSIAN_PEAK == jhm.GAUSSIAN_PEAK == 0.15915589174187972
    assert hm.COORD_SPACE == jhm.COORD_SPACE
    np.testing.assert_array_equal(hm.gaussian_kernel1d(),
                                  jhm.gaussian_kernel1d())


@pytest.mark.parametrize("res", [16, 64])
def test_joint_heatmaps_match_jax(res):
    rng = np.random.default_rng(res)
    c = rng.uniform(-150, 1150, (3, 15, 2)).astype(np.float32)
    c[0, 0] = [np.nan, 10.0]                     # renders zeros
    c[1, :4] = [[-3.9 * 1024 / res, 5], [5, -4 * 1024 / res],
                [res - 0.01, 512], [512, (res + 3.99) * 1024 / res]]
    got = dr.render_joint_heatmaps(torch.from_numpy(c), res)
    want = jdr.render_joint_heatmaps(jnp.asarray(c), res)
    _close(got, want)
    assert float(got.max()) == pytest.approx(1.0, abs=1e-6)


@pytest.mark.parametrize("preset", ["UnrealEgo", "EgoCap"])
@pytest.mark.parametrize("res", [16, 64])
def test_limb_heatmaps_match_jax(preset, res):
    parents = tuple(jax_skeleton(preset).parents)
    rng = np.random.default_rng(res)
    c = rng.uniform(-150, 1150, (3, len(parents), 2)).astype(np.float32)
    c[0, 3] = c[0, 2]                            # zero-length bone
    c[1, 1] = c[1, 0] + [0.0, 300.0]             # vertical and
    c[1, 2] = c[1, 1] + [300.0, 0.0]             # horizontal bones
    lines, lengths = dr.render_limb_heatmaps(torch.from_numpy(c), parents,
                                             res)
    want_lines, want_lengths = jdr.render_limb_heatmaps(jnp.asarray(c),
                                                        parents, res)
    _close(lines, want_lines)
    _close(lengths, want_lengths)


def test_limb_theta_and_sin_maps_match_jax():
    parents = tuple(jax_skeleton("UnrealEgo").parents)
    rng = np.random.default_rng(3)
    p3 = rng.normal(0, 30, (4, 16, 3)).astype(np.float32)
    p3[0, 3, :2] = p3[0, 2, :2]                  # dz only: +-pi/2
    p3[1, 4] = p3[1, 0]                          # no length at all: 0
    theta = dr.limb_theta(torch.from_numpy(p3), parents)
    want = jdr.limb_theta(jnp.asarray(p3), parents)
    _close(theta, want)
    raw = rng.uniform(0, 1, (4, 15, 8, 8)).astype(np.float32)
    for got, ref in zip(dr.sin_limb_heatmaps(torch.from_numpy(raw), theta),
                        jdr.sin_limb_heatmaps(jnp.asarray(raw), want)):
        _close(got, ref)


CONFIGS = {
    "joint": dict(num_heatmap=15, num_rot_heatmap=0, heatmap_type="none"),
    "limb": dict(num_heatmap=0, num_rot_heatmap=15, heatmap_type="limb"),
    "sin": dict(num_heatmap=15, num_rot_heatmap=15, heatmap_type="sin"),
    "egocap_sin": dict(joint_preset="EgoCap", num_heatmap=17,
                       num_rot_heatmap=17, heatmap_type="sin"),
}


@pytest.mark.parametrize("image", [64, 96, 40],
                         ids=["native", "downscale", "upscale"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_preprocess_matches_jax(config, image):
    """Every output of `make_device_preprocess`, with the rgb resized to
    the config's 64 x 64 from a larger image (antialiased) and from a
    smaller one, as `jax.image.resize(..., "bilinear")` resizes."""
    fields = dict(CONFIGS[config], load_size_heatmap=(16, 16))
    cfg, jcfg = Config(**fields).derive(), JaxConfig(**fields).derive()
    joints = 18 if cfg.joint_preset == "EgoCap" else 16
    raw = raw_batch(np.random.default_rng(image), image=image, joints=joints)
    got = make_device_preprocess(cfg)({k: torch.from_numpy(v)
                                       for k, v in raw.items()})
    want = jax_preprocess(jcfg)({k: jnp.asarray(v) for k, v in raw.items()})
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].contiguous(), want[k])
    assert got["input_rgb"].shape == (2, 2, 64, 64, 3)


def test_losses_match_jax():
    """f32 means of 15360 terms, summed in another order (read 2.2e-6)."""
    rng = np.random.default_rng(5)
    pred, gt = (rng.normal(0, 1, (2, 16, 16, 30)).astype(np.float32)
                for _ in range(2))
    plength = rng.uniform(1, 40, (2, 30)).astype(np.float32)
    np.testing.assert_allclose(
        losses.heatmap_mse(torch.from_numpy(pred), torch.from_numpy(gt)),
        jlosses.heatmap_mse(pred, gt), rtol=1e-5)
    np.testing.assert_allclose(
        losses.limb_heatmap_mse(torch.from_numpy(pred), torch.from_numpy(gt),
                                torch.from_numpy(plength)),
        jlosses.limb_heatmap_mse(pred, gt, plength), rtol=1e-5)
