"""Bilinear 2x upsampling with align_corners=True, NHWC.

Counterpart of `egotap_tpu/ops/upsample.py`. The reference decoder uses
``nn.Upsample(scale_factor=2, mode='bilinear', align_corners=True)``
(reference model/net_architecture.py:126).

`upsample2x_align_corners` runs kernel A (``csrc/upsample.cu``) for a
CUDA tensor and `upsample2x_plain` for a CPU tensor. Both compute each
output pixel as the 2-tap lerp of input rows, then of input columns,
``a * (1 - f) + b * f`` in f32, with the taps of `lerp_taps`.

Gradients: on the card the kernel is the forward of `_KernelA`, whose
backward is autograd over `upsample2x_plain` recomputed from the saved
input (`ops.plain_vjp`): the transposed interpolation, as JAX's
`custom_vjp` differentiates its einsum formulation
(`egotap_tpu/ops/upsample.py:139-149`). On the CPU the plain version
differentiates itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from egotap_tpu_torch.ops import _build, plain_vjp


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
# (`ops.kernel_errors`). The kernel rounds each multiply and add as the
# plain version does (no FMA contraction) and the output once, so on an
# H100 it reads 0 at the decoder's shapes in both dtypes; the limits leave
# room for a contracted build, whose bf16 output flips one ulp where the
# f32 value crosses a tie: at most 2^-7 of max|plain|, read as (3.4e-3,
# 1.4e-4). A second rounding after the row pass reads an rms of 2.3e-3 or
# more.
TOL = {torch.float32: (2e-5, 2e-6), torch.bfloat16: (8e-3, 5e-4)}

_VEC = {torch.float32: (4, 0), torch.bfloat16: (8, 1)}

BACKWARD_LABEL = "kernel A backward (plain recompute)"   # profiler range

THREADS = 256                 # a block of kernel A
BAND_ROWS = 16                # output rows a block, at most
SMEM_BUDGET = 48 * 1024       # staged input bytes a block, at most


def tap_table(in_size: int) -> np.ndarray:
    """`lerp_taps(in_size)` as kernel A reads them: int32 lo, hi, then the
    f32 fractions' bits, 2 * in_size of each."""
    lo, hi, fr = lerp_taps(in_size)
    return np.concatenate([lo.astype(np.int32), hi.astype(np.int32),
                           fr.view(np.int32)])


@functools.lru_cache(maxsize=None)
def _device_taps(in_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tap_table(in_size)).to(device)


@functools.lru_cache(maxsize=None)
def launch_geometry(n: int, h: int, w: int, c: int, dtype: torch.dtype
                    ) -> dict:
    """Kernel A's blocks for (n, h, w, c) in ``dtype``: ``cv`` 16-byte
    channel vectors a block (the most of 8, 4, 2, 1 dividing c's), ``band``
    output rows a block, ``staged`` input rows the widest band reads,
    ``smem`` bytes a block, ``grid`` (channel slices, bands, images; a
    block walks images ``z, z + 65535, ...``). Bands halve down to 4 rows,
    then channel slices narrow, then bands halve again, until the staged
    rows fit ``SMEM_BUDGET``. Cached: the caller must not change it."""
    vec = _VEC[dtype][0]
    if c % vec:
        raise NotImplementedError(
            f"upsample kernel: channels {c} not a multiple of {vec}")
    if 4 * h * w * c >= 2 ** 31:
        raise NotImplementedError("upsample kernel: 2H x 2W x C of one "
                                  "image must stay below 2^31")
    lo, hi, _ = lerp_taps(h)
    cvec = c // vec
    cv = next(k for k in (8, 4, 2, 1) if cvec % k == 0)
    band = min(BAND_ROWS, 2 * h)
    while True:
        staged = max(int(hi[min(o + band, 2 * h) - 1] - lo[o]) + 1
                     for o in range(0, 2 * h, band))
        smem = staged * w * cv * 16
        if smem <= SMEM_BUDGET:
            break
        if band > 4:
            band //= 2
        elif cv > 1:
            cv //= 2
        elif band > 1:
            band //= 2
        else:
            raise NotImplementedError(
                f"upsample kernel: two input rows of width {w} exceed "
                f"{SMEM_BUDGET} bytes of shared memory a block")
    return {"cv": cv, "band": band, "staged": staged, "smem": smem,
            "grid": (cvec // cv, -(-2 * h // band), min(n, 65535))}


def kernel_resources(dtype: torch.dtype, smem: int) -> dict:
    """What kernel A in ``dtype`` takes of an SM with ``smem`` bytes of
    staged input a block (needs the card): ``registers``, spill bytes and
    static shared memory from ``ptxas -v``; ``blocks_per_sm``,
    ``runtime_registers``, ``local_bytes``, ``smem_bytes`` and
    ``threads`` from the runtime."""
    tag = {torch.float32: "upsample2x_kernelIfE",
           torch.bfloat16: "upsample2x_kernelI13__nv_bfloat16E"}[dtype]
    info = (ctypes.c_int * 5)()
    _build.check(_build.library("upsample").egotap_upsample2x_occupancy(
        _VEC[dtype][1], smem, ctypes.addressof(info)), "upsample occupancy")
    return {**_build.ptxas_resources("upsample", tag),
            "blocks_per_sm": info[0], "runtime_registers": info[1],
            "local_bytes": info[2], "smem_bytes": info[3],
            "threads": info[4]}


def _launch(x: torch.Tensor) -> torch.Tensor:
    """Check what kernel A covers and launch it on (..., H, W, C)."""
    if x.dtype not in _VEC:
        raise NotImplementedError(f"upsample kernel: dtype {x.dtype}")
    h, w, c = x.shape[-3:]
    n = x.numel() // (h * w * c)
    geo = launch_geometry(n, h, w, c, x.dtype)
    x = x.contiguous()
    if x.data_ptr() % 16:            # the kernel moves 16-byte vectors
        x = x.clone()
    out = torch.empty(x.shape[:-3] + (2 * h, 2 * w, c), dtype=x.dtype,
                      device=x.device)
    lib = _build.library("upsample")
    _build.check(lib.egotap_upsample2x(
        x.data_ptr(), out.data_ptr(), _device_taps(h, x.device).data_ptr(),
        _device_taps(w, x.device).data_ptr(), n, h, w, c, _VEC[x.dtype][1],
        geo["band"], geo["cv"], geo["staged"], _build.stream_ptr(x)),
        "upsample2x")
    return out


class _KernelA(torch.autograd.Function):
    """Kernel A forward; backward: autograd over the plain version,
    recomputed from the saved input."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _launch(x)

    @staticmethod
    def backward(ctx, grad):
        return plain_vjp(upsample2x_plain, ctx.saved_tensors,
                         ctx.needs_input_grad, grad, BACKWARD_LABEL)


def upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Exact ``Upsample(scale_factor=2, bilinear, align_corners=True)``.

    x: (..., H, W, C) NHWC. Returns (..., 2H, 2W, C) in x's dtype."""
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    out = _KernelA.apply(x)
    upsample2x_align_corners.launches += 1
    return out


upsample2x_align_corners.launches = 0
