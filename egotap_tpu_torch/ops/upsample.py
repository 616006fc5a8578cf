"""Bilinear 2x upsampling with align_corners=True, NHWC.

Counterpart of `egotap_tpu/ops/upsample.py`. The reference decoder uses
``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``
(reference model/net_architecture.py:126).

`upsample2x_align_corners` runs kernel A (``csrc/upsample.cu``) for a
CUDA tensor and `upsample2x_plain` for a CPU tensor. Both compute each
output pixel as the 2-tap lerp of input rows, then of input columns,
``a * (1 - f) + b * f`` in f32, with the taps of `lerp_taps`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from egotap_tpu_torch.ops import _build, refuse_grad


@functools.lru_cache(maxsize=None)
def lerp_taps(in_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, frac) per output index for 2x align-corners, computed in
    float64 like `egotap_tpu/ops/upsample.py:_lerp_taps`."""
    if in_size == 1:
        z = np.zeros(2, np.int64)
        return z, z, np.zeros(2, np.float32)
    src = np.arange(2 * in_size) * (in_size - 1) / (2 * in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, (src - lo).astype(np.float32)


def _lerp(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    lo, hi, fr = lerp_taps(size)
    shape = [1] * x.dim()
    shape[dim] = -1
    f = torch.from_numpy(fr).to(x.device).view(shape)
    a = x.index_select(dim, torch.from_numpy(lo).to(x.device))
    b = x.index_select(dim, torch.from_numpy(hi).to(x.device))
    return a * (1.0 - f) + b * f


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A: (..., H, W, C) -> (..., 2H, 2W, C),
    lerps in f32, rounded once to x's dtype."""
    h, w = x.shape[-3], x.shape[-2]
    y = _lerp(x.float(), x.dim() - 3, h)
    y = _lerp(y, x.dim() - 2, w)
    return y.to(x.dtype)


# kernel vs `upsample2x_plain` on the card, (max, rms) relative error
# (`ops.kernel_errors`). Both round once from the same f32 lerps, so in
# bf16 only a final rounding flips where FMA contraction moves the f32
# value across a tie: one bf16 ulp, at most 2^-7 of max|plain|. On an H100
# at the decoder's shapes the kernel read at most (3.4e-3, 1.4e-4); a
# second rounding after the row pass reads an rms of 2.3e-3 or more.
TOL = {torch.float32: (2e-5, 2e-6), torch.bfloat16: (8e-3, 5e-4)}

_VEC = {torch.float32: (4, 0), torch.bfloat16: (8, 1)}


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Exact ``Upsample(scale_factor=2, bilinear, align_corners=True)``.

    x: (..., H, W, C) NHWC. Returns (..., 2H, 2W, C) in x's dtype."""
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    if x.dtype not in _VEC:
        raise NotImplementedError(f"upsample kernel: dtype {x.dtype}")
    refuse_grad("upsample", x)
    vec, code = _VEC[x.dtype]
    h, w, c = x.shape[-3:]
    if c % vec:
        raise NotImplementedError(
            f"upsample kernel: channels {c} not a multiple of {vec}")
    x = x.contiguous()
    if x.data_ptr() % 16:            # the kernel moves 16-byte vectors
        x = x.clone()
    n = x.numel() // (h * w * c)
    out = torch.empty(x.shape[:-3] + (2 * h, 2 * w, c), dtype=x.dtype,
                      device=x.device)
    lib = _build.library("upsample")
    _build.check(lib.egotap_upsample2x(
        x.data_ptr(), out.data_ptr(), n, h, w, c, code,
        _build.stream_ptr(x)), "upsample2x")
    upsample2x_align_corners.launches += 1
    return out


upsample2x_align_corners.launches = 0
