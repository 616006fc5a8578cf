"""Kernel F's walk over its output, played on the CPU: each block's tile of
rows and each thread's chunks as ``csrc/int8_pack.cu`` walks them, with
its geometry (`int8_pack.pack_geometry`, `epilogue_geometry`) and its
divisions by multiply-high (`FastDiv`). Every entry of the rows and of
the output is written once and equals the plain twin's. The kernel itself
is held to the plain sequence on the card
(`tests/test_torch_kernels_cuda.py`)."""

import numpy as np
import pytest
import torch

from egotap_tpu_torch.ops import int8_pack as F8
from egotap_tpu_torch.ops import quant

THREADS = 256


def fast_div(d):
    """`fast_div` of the kernel: n -> n // d for 0 <= n < 2^31."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    magic = ((1 << 32) * ((1 << shift) - d)) // d + 1
    return lambda n: ((n * magic >> 32) + n) >> shift


def _walk(rows_total, row_chunks, rows_per_block):
    """(row, chunk) of every step of every thread, block by block, as the
    kernels' loops take them."""
    div = fast_div(row_chunks)
    for row0 in range(0, rows_total, rows_per_block):
        tile = min(rows_per_block, rows_total - row0) * row_chunks
        for t0 in range(0, tile, THREADS):
            for t in range(t0, min(t0 + THREADS, tile)):
                r = div(t)
                yield row0 + r, t - r * row_chunks


def pack_walk(x, a_scale, kernel, stride, padding):
    """The pack's rows as its threads write them."""
    n, h, w, c = x.shape
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    m, kk = n * ho * wo, kernel * kernel * c
    mp, kp = quant.padded(m, kk)
    vec, rows_per_block = F8.pack_geometry(c, mp, kp)
    assert c % vec == 0 and kp % vec == 0
    by_wo, by_ho, by_c, by_k = (fast_div(d) for d in (wo, ho, c, kernel))
    q = torch.round(x.float() / a_scale).clamp(-127, 127).numpy()
    rows = np.full((mp, kp), 1000, np.int64)
    for row, chunk in _walk(mp, kp // vec, rows_per_block):
        col = chunk * vec
        codes = np.zeros(vec, np.int64)
        if row < m and col < kk:
            rest = by_wo(row)
            b = by_ho(rest)
            tap = by_c(col)
            di = by_k(tap)
            hi = (rest - b * ho) * stride - padding + di
            wi = (row - rest * wo) * stride - padding + tap - di * kernel
            if 0 <= hi < h and 0 <= wi < w:
                ch = col - tap * c
                codes = q[b, hi, wi, ch:ch + vec]
        assert (rows[row, col:col + vec] == 1000).all(), (row, col)
        rows[row, col:col + vec] = codes
    assert (rows != 1000).all()
    return torch.from_numpy(rows).to(torch.int8)


def epilogue_walk(acc, m, n, a_scale, w_scale, bias):
    """The epilogue's output (f32) as its threads write it."""
    vec, rows_per_block = F8.epilogue_geometry(m, n)
    assert n % vec == 0 and acc.shape[1] % vec == 0
    scale = (a_scale * w_scale).numpy()
    out = np.full((m, n), np.nan, np.float32)
    for row, chunk in _walk(m, n // vec, rows_per_block):
        col = chunk * vec
        y = acc[row, col:col + vec].float().numpy() * scale[col:col + vec]
        if bias is not None:
            y = y + bias[col:col + vec].numpy()
        assert np.isnan(out[row, col:col + vec]).all(), (row, col)
        out[row, col:col + vec] = y
    assert not np.isnan(out).any()
    return torch.from_numpy(out)


@pytest.mark.parametrize("shape,kernel,stride,padding", [
    ((1, 3, 3, 4), 3, 1, 1), ((2, 5, 4, 3), 3, 2, 1), ((1, 4, 4, 16), 1, 2, 0),
    ((2, 3, 5, 20), 3, 1, 1), ((1, 2, 2, 1540), 3, 1, 1),
    ((1, 1, 1, 24), 1, 1, 0), ((3, 2, 2, 8), 3, 2, 1),
    ((1, 6, 6, 64), 3, 2, 1), ((2, 9, 5, 64), 3, 2, 0),
    ((600, 1, 1, 64), 1, 1, 0)])
def test_pack_walk_writes_the_plain_rows(shape, kernel, stride, padding):
    """Codes of 16, 8, 4 and 1 a chunk, M at most 16 and above, K tails,
    borders, strides, and a call of more blocks than `MIN_BLOCKS`' rows
    a block (600 rows: one row a block)."""
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g) * 3
    a = torch.tensor(0.05)
    want, _ = F8.pack_plain(x, a, kernel, stride, padding)
    assert torch.equal(pack_walk(x, a, kernel, stride, padding), want)


@pytest.mark.parametrize("m,n,bias", [(40, 64, True), (33, 30, False),
                                      (17, 516, True), (3, 5, True),
                                      (600, 8, False)])
def test_epilogue_walk_writes_the_plain_output(m, n, bias):
    g = torch.Generator().manual_seed(m + n)
    mp, np_ = quant.padded(m, 8)[0], -(-n // 8) * 8
    acc = torch.randint(-2 ** 20, 2 ** 20, (mp, np_), generator=g,
                        dtype=torch.int32)
    a, w_scale = torch.tensor(0.05), torch.rand(n, generator=g) / 127
    b = torch.randn(n, generator=g) if bias else None
    want = F8.epilogue_plain(acc, m, n, a, w_scale, b, torch.float32)
    assert torch.equal(epilogue_walk(acc, m, n, a, w_scale, b), want)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 27, 36, 113, 1540, 3466, 13864,
                               131072, 2 ** 20 + 3])
def test_fast_div(d):
    """The multiply-high division equals n // d over the indices the
    kernels divide (0 to 2^31 - 1)."""
    div = fast_div(d)
    rng = np.random.default_rng(d)
    for n in [0, 1, d - 1, d, d + 1, 2 ** 31 - 1,
              *rng.integers(0, 2 ** 31, 2000).tolist()]:
        assert div(n) == n // d, n
