"""The port's align-corners 2x upsample (egotap_tpu_torch.ops.upsample)
against the JAX package's two-pass einsum and its one-pass Pallas kernel
(run in interpret mode, as tests/test_utils.py runs it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.ops.upsample import (_lerp_taps, _upsample_pallas,
                                     _upsample_two_pass)
from egotap_tpu_torch.ops import upsample as up

SHAPES = [(2, 8, 8, 64), (2, 16, 16, 128), (1, 8, 16, 64), (3, 1, 4, 8)]
# f32: the same two-tap lerps in f32 on both sides; the einsum sums its
# zero taps too and may contract differently, so allow a few ulps.
# bf16: the JAX paths round the interpolation weights and the row-pass
# intermediate to bf16, the port rounds once at the end: a few bf16 ulps.
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def _inputs(shape, dtype, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jx, tx


def _check(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= TOL[dtype] * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_matches_two_pass_einsum(shape, dtype):
    jx, tx = _inputs(shape, dtype)
    _check(up.upsample2x_align_corners(tx), _upsample_two_pass(jx), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES[:3])
def test_matches_pallas_interpret(shape, dtype):
    jx, tx = _inputs(shape, dtype, seed=1)
    _check(up.upsample2x_align_corners(tx),
           _upsample_pallas(jx, interpret=True), dtype)


@pytest.mark.parametrize("size", [1, 2, 8, 16, 32])
def test_taps_match_jax(size):
    lo, hi, fr = up.lerp_taps(size)
    jlo, jhi, jfr = _lerp_taps(size)
    n = len(jlo)
    np.testing.assert_array_equal(lo[:n], jlo)
    np.testing.assert_array_equal(hi[:n], jhi)
    np.testing.assert_array_equal(fr[:n], np.asarray(jfr, np.float32))


def test_leading_dims_and_corners():
    """(..., H, W, C): extra leading dims pass through; align_corners keeps
    the four corner pixels exactly."""
    x = torch.randn(2, 3, 4, 5, 8)
    y = up.upsample2x_align_corners(x)
    assert y.shape == (2, 3, 8, 10, 8)
    for i, j in ((0, 0), (0, -1), (-1, 0), (-1, -1)):
        torch.testing.assert_close(y[..., i, j, :], x[..., i, j, :],
                                   rtol=0, atol=0)


def test_cpu_path_does_not_launch():
    before = up.upsample2x_align_corners.launches
    up.upsample2x_align_corners(torch.randn(1, 4, 4, 8))
    assert up.upsample2x_align_corners.launches == before

