"""The port's pose losses, Procrustes alignment and pose metrics
(egotap_tpu_torch.train.losses, ops.procrustes, eval.metrics) against the
JAX package's, at f32 on the same seeded poses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.core.skeleton import get_skeleton as jax_skeleton
from egotap_tpu.eval import metrics as jax_metrics
from egotap_tpu.ops.procrustes import similarity_align as jax_align
from egotap_tpu.train import losses as jax_losses
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.eval import metrics
from egotap_tpu_torch.ops.procrustes import similarity_align
from egotap_tpu_torch.train import losses

RTOL = 1e-5            # f32, the same formulas summed in another order
PA_RTOL = 1e-4         # through a 3x3 SVD (LAPACK on both sides)


def _poses(seed, b=6, j=16):
    """gt, and a prediction near it (noise, a rotation, a scale, a shift)."""
    rng = np.random.default_rng(seed)
    gt = rng.standard_normal((b, j, 3)).astype(np.float32) * 20
    a = rng.uniform(-0.5, 0.5, b)
    rot = np.zeros((b, 3, 3))
    rot[:, 0, 0] = rot[:, 1, 1] = np.cos(a)
    rot[:, 0, 1], rot[:, 1, 0] = -np.sin(a), np.sin(a)
    rot[:, 2, 2] = 1
    pred = 1.1 * gt @ rot.transpose(0, 2, 1) + rng.normal(0, 2, (b, j, 3)) + 5
    return pred.astype(np.float32), gt


def _reflected(seed):
    """A prediction that is gt mirrored through a plane: the best
    orthogonal fit is a reflection, det(U V^T) < 0, which the sign fix
    turns into the nearest rotation."""
    pred, gt = _poses(seed)
    pred = pred * np.array([-1, 1, 1], np.float32)
    return pred, gt


def _close(got, ref, rtol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= rtol * np.abs(ref).max()


@pytest.mark.parametrize("make", [_poses, _reflected],
                         ids=["rotated", "reflected"])
def test_similarity_align_matches_jax(make):
    pred, gt = make(0)
    ref = np.asarray(jax_align(jnp.asarray(pred), jnp.asarray(gt)))
    got = similarity_align(torch.from_numpy(pred), torch.from_numpy(gt))
    _close(got, ref, PA_RTOL)


def test_reflection_is_fixed():
    """With the reflected pose, U V^T of the covariance has det -1: the
    alignment must still be a proper rotation (no mirror image of the
    prediction lands on gt)."""
    pred, gt = _reflected(1)
    x1 = pred - pred.mean(1, keepdims=True)
    x2 = gt - gt.mean(1, keepdims=True)
    u, _, vh = np.linalg.svd(np.einsum("bji,bjk->bik", x1, x2))
    assert (np.linalg.det(u @ vh) < 0).all()
    got = similarity_align(torch.from_numpy(pred), torch.from_numpy(gt))
    # the aligned pose is a rotation of the centred prediction: a proper
    # rotation keeps the handedness of every triple of joints
    c = got.numpy() - got.numpy().mean(1, keepdims=True)
    tri = np.linalg.det(np.stack([c[:, 1], c[:, 2], c[:, 3]], axis=1))
    tri_in = np.linalg.det(np.stack([x1[:, 1], x1[:, 2], x1[:, 3]], axis=1))
    assert (np.sign(tri) == np.sign(tri_in)).all()


@pytest.mark.parametrize("fn", ["mpjpe", "per_sample_mpjpe"])
def test_mpjpe_matches_jax(fn):
    pred, gt = _poses(2)
    ref = getattr(jax_losses, fn)(jnp.asarray(pred), jnp.asarray(gt))
    got = getattr(losses, fn)(torch.from_numpy(pred), torch.from_numpy(gt))
    _close(got, ref, RTOL)


@pytest.mark.parametrize("preset,estimate_head", [("UnrealEgo", True),
                                                  ("EgoCap", False)])
def test_cos_sim_matches_jax(preset, estimate_head):
    """estimate_head False (EgoCap): a zero root row is prepended to both
    poses and the first bone dropped from the sum."""
    sk = get_skeleton(preset)
    j = sk.num_joints - (0 if estimate_head else 1)
    pred, gt = _poses(3, j=j)
    pred[:, 4] = pred[:, 1]              # one zero-length bone (eps path)
    ref = jax_losses.cos_sim(jnp.asarray(pred), jnp.asarray(gt),
                             jax_skeleton(preset).parents_array(),
                             estimate_head=estimate_head)
    got = losses.cos_sim(torch.from_numpy(pred), torch.from_numpy(gt),
                         sk.parents, estimate_head=estimate_head)
    _close(got, ref, RTOL)


@pytest.mark.parametrize("make", [_poses, _reflected],
                         ids=["rotated", "reflected"])
def test_pose_metrics_match_jax(make):
    pred, gt = make(4)
    ref = jax_metrics.pose_metrics(jnp.asarray(pred), jnp.asarray(gt))
    got = metrics.pose_metrics(torch.from_numpy(pred), torch.from_numpy(gt))
    assert sorted(got) == sorted(ref) == ["mpjpe", "pa_mpjpe"]
    _close(got["mpjpe"], ref["mpjpe"], RTOL)
    _close(got["pa_mpjpe"], ref["pa_mpjpe"], PA_RTOL)
    # PA-MPJPE can only be smaller: the alignment includes the identity
    assert (got["pa_mpjpe"] <= got["mpjpe"] + 1e-3).all()


def test_accumulator_matches_jax():
    rng = np.random.default_rng(5)
    batches = [{"mpjpe": rng.uniform(0, 100, n), "pa_mpjpe":
                rng.uniform(0, 50, n)} for n in (4, 3, 4)]
    mask = np.array([1, 1, 0, 1], bool)
    ours, ref = metrics.MetricAccumulator(), jax_metrics.MetricAccumulator()
    for i, b in enumerate(batches):
        m = mask if i == 2 else None
        ours.update(b, m)
        ref.update(b, m)
    assert ours.means() == ref.means()
    assert ours.count == ref.count == 10
    assert ours.per_sample == ref.per_sample
