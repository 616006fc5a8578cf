"""The port's train-mode BatchNorm (egotap_tpu_torch.models.layers
.batch_norm_train) against the JAX package's `TorchBatchNorm`: outputs
and running statistics over three calls, with one group and with two
interleaved groups (the stereo views of the folded batch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.layers import TorchBatchNorm
from egotap_tpu_torch.models.layers import batch_norm_train

TOL = 1e-6      # f32 statistics of the same rows, summed in another order


@pytest.mark.parametrize("shape", [(12, 7), (4, 5, 3, 6)],
                         ids=["rows", "nhwc"])
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_jax(groups, shape, dtype):
    rng = np.random.default_rng(groups)
    feat = shape[-1]
    scale = rng.uniform(0.5, 1.5, feat).astype(np.float32)
    bias = rng.normal(0, 0.1, feat).astype(np.float32)
    mean0 = rng.normal(0, 0.1, feat).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, feat).astype(np.float32)
    mod = TorchBatchNorm(use_running_average=False, stats_groups=groups)
    jvars = {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean0, "var": var0}}
    bn = torch.nn.BatchNorm2d(feat)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    for call in range(3):
        # a different mean and spread per group, so per-group statistics
        # differ from statistics over the whole batch
        x = rng.normal(0, 1, shape).astype(np.float32)
        x = x * (1 + np.arange(shape[0]) % groups)[(...,) + (None,) * (
            len(shape) - 1)] + call
        jx = jnp.asarray(x, getattr(jnp, dtype))
        ref, upd = mod.apply(jvars, jx, mutable=["batch_stats"])
        jvars = {"params": jvars["params"], "batch_stats": upd["batch_stats"]}
        got = batch_norm_train(torch.from_numpy(x).to(getattr(torch, dtype)),
                               bn, groups)
        assert got.dtype == getattr(torch, dtype)
        ref = np.asarray(ref, np.float32)
        # bf16 outputs: one rounding of the same f32 value, at most an ulp
        tol = TOL if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(got.detach().float().numpy(), ref, rtol=tol,
                                   atol=tol)
        np.testing.assert_allclose(bn.running_mean.numpy(),
                                   upd["batch_stats"]["mean"], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   upd["batch_stats"]["var"], rtol=0,
                                   atol=TOL)
    assert int(bn.num_batches_tracked) == 3 * groups


def test_grouped_differs_from_fused_statistics():
    """Two interleaved groups with different statistics: the per-group
    normalisation is not the one over the whole batch, and the running
    statistics take two updates (momentum applied twice)."""
    x = torch.cat([torch.zeros(1, 3), torch.full((1, 3), 4.0)]).repeat(4, 1)
    x = x + torch.arange(8.0)[:, None] / 8
    one, two = torch.nn.BatchNorm1d(3), torch.nn.BatchNorm1d(3)
    y1, y2 = batch_norm_train(x, one, 1), batch_norm_train(x, two, 2)
    assert not torch.allclose(y1.detach(), y2.detach())
    torch.testing.assert_close(two.running_mean,
                               torch.full((3,), 0.1 * 0.9 * x[0::2].mean()
                                          + 0.1 * x[1::2].mean()))
