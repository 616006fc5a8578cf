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



@pytest.mark.parametrize("size", [1, 2, 8, 16, 32])
def test_tap_table_matches_jax(size):
    """Kernel A's tap arguments: lo, hi and the f32 fractions' bits of
    `lerp_taps`, which equal JAX's `_lerp_taps`, 2 * size of each (JAX
    gives one tap for both outputs of a one-pixel axis)."""
    table = up.tap_table(size)
    assert table.dtype == np.int32 and table.shape == (6 * size,)
    lo, hi, fr = np.split(table, 3)
    jlo, jhi, jfr = (np.resize(t, 2 * size) for t in _lerp_taps(size))
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    np.testing.assert_array_equal(fr.view(np.float32),
                                  np.asarray(jfr, np.float32))


def _writes(n, h, w, c, dtype):
    """How many times kernel A writes each 16-byte output vector: its
    loops (`csrc/upsample.cu`) over `launch_geometry`'s grid, emulated
    with numpy. Axes: image, band, row in band, channel slice, column
    pass, thread."""
    geo = up.launch_geometry(n, h, w, c, dtype)
    cv, band = geo["cv"], geo["band"]
    gx, gy, gz = geo["grid"]
    vec = 8 if dtype == torch.bfloat16 else 4
    cvec, oh, ow = c // vec, 2 * h, 2 * w
    cols = up.THREADS // cv
    img = np.arange(gz)[:, None] + gz * np.arange(-(-n // gz))[None, :]
    img = img.reshape(-1, 1, 1, 1, 1, 1)
    by = np.arange(gy).reshape(1, -1, 1, 1, 1, 1)
    k = np.arange(band).reshape(1, 1, -1, 1, 1, 1)
    bx = np.arange(gx).reshape(1, 1, 1, -1, 1, 1)
    t = np.arange(up.THREADS).reshape(1, 1, 1, 1, 1, -1)
    p = t // cv + cols * np.arange(-(-ow // cols)).reshape(1, 1, 1, 1, -1, 1)
    o = by * band + k
    ch = bx * cv + t % cv
    valid = (img < n) & (o < oh) & (p < ow) & (ch < cvec)
    flat = ((img * oh + o) * ow + p) * cvec + ch
    return np.bincount(np.broadcast_to(flat, valid.shape)[valid],
                       minlength=n * oh * ow * cvec)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (32, 8, 8, 1024), (32, 16, 16, 1024), (32, 32, 32, 512),  # the decoder
    (3, 1, 4, 8), (2, 5, 1, 16), (2, 7, 9, 8), (1, 1, 1, 8),  # h, w = 1, odd
    (2, 33, 17, 24), (1, 160, 96, 64)])        # ragged band, narrowed slices
def test_launch_geometry_writes_every_vector_once(shape, dtype):
    geo = up.launch_geometry(*shape, dtype)
    assert geo["smem"] <= up.SMEM_BUDGET and 1 <= geo["band"] <= 64
    counts = _writes(*shape, dtype)
    assert counts.min() == counts.max() == 1


def test_launch_geometry_folds_images_past_the_grid():
    """Past 65535 images a block walks every 65535th image."""
    geo = up.launch_geometry(70000, 1, 1, 8, torch.float32)
    assert geo["grid"] == (1, 1, 65535)
    counts = _writes(70000, 1, 1, 8, torch.float32)
    assert counts.min() == counts.max() == 1
