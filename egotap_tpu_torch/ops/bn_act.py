"""Eval-mode BatchNorm, then a residual add and ReLU, NHWC: kernel E.

The ResNet trunk's eval path normalises each convolution's output with
its BatchNorm's running statistics (`batch_norm_eval`, in f32, rounded
back to the input's dtype), adds the residual at a block's end (the
block input, or a second convolution's output through its own
BatchNorm, rounded first) and applies ReLU. `bn_act_plain` is that
plain sequence: eight launches a BatchNorm and one each for the add and
the ReLU. The JAX package has no kernel for it; XLA fuses it there.

`bn_act` runs kernel E (``csrc/bn_act.cu``) for a CUDA tensor and
`bn_act_plain` for a CPU tensor. The kernel reads x (and the residual)
once and writes the output once, and its result equals the plain
sequence's bit for bit (`TOL`). It takes f32 or bf16 with channels a
multiple of 4 or 8 and the BatchNorms' four f32 vectors beside x, and
raises NotImplementedError for anything else; a non-contiguous or
misaligned input is copied first, as kernel A does. Each launch counts
in ``bn_act.launches`` (`ops.launch_counts`), as the other kernels' do.

Gradients: when one is asked for, the kernel is the forward of
`_KernelE`, whose backward is autograd over the plain sequence
recomputed from the saved inputs (`ops.plain_vjp`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
from torch import nn

from egotap_tpu_torch.ops import _build, plain_vjp

BN_EPS = 1e-5

# kernel vs `bn_act_plain` on the card, (max, rms) relative error
# (`ops.kernel_errors`): the kernel rounds each operation as the plain
# sequence does, so it is exact
TOL = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}

# channels a 16-byte vector, the C entry's dtype code
_VEC = {torch.float32: (4, 0), torch.bfloat16: (8, 1)}

BACKWARD_LABEL = "kernel E backward (plain recompute)"   # profiler range


def _normalise(x: torch.Tensor, mean, var, weight, bias) -> torch.Tensor:
    inv = torch.rsqrt(var.float() + BN_EPS) * weight.float()
    y = (x.float() - mean.float()) * inv + bias.float()
    return y.to(x.dtype)


def stats(bn: nn.modules.batchnorm._BatchNorm) -> tuple:
    """What kernel E reads of a BatchNorm: (running_mean, running_var,
    weight, bias)."""
    return bn.running_mean, bn.running_var, bn.weight, bn.bias


def batch_norm_eval(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm
                    ) -> torch.Tensor:
    """Eval-mode BatchNorm over the last axis, in f32, cast back
    (`egotap_tpu/models/layers.py:TorchBatchNorm`, running averages)."""
    return _normalise(x, *stats(bn))


def _plain(x: torch.Tensor, residual: Optional[torch.Tensor],
           *vectors: torch.Tensor) -> torch.Tensor:
    """`bn_act_plain` on tensors: ``vectors`` are x's BatchNorm's four
    (`stats`), then the residual's four when it has its own."""
    y = _normalise(x, *vectors[:4])
    if residual is not None:
        if len(vectors) == 8:
            residual = _normalise(residual, *vectors[4:])
        y = y + residual
    return torch.relu(y)


def bn_act_plain(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
                 residual: Optional[torch.Tensor] = None,
                 residual_bn: Optional[nn.modules.batchnorm._BatchNorm] = None
                 ) -> torch.Tensor:
    """``bn`` on x (`batch_norm_eval`); plus ``residual`` (through
    ``residual_bn`` first, when given) in x's dtype; then ReLU. Plain
    PyTorch version of kernel E."""
    vectors = stats(bn) + (() if residual_bn is None else stats(residual_bn))
    return _plain(x, residual, *vectors)


def kernel_resources(dtype: torch.dtype, residual: int, n: int, c: int
                     ) -> dict:
    """What kernel E of (``dtype``, ``residual`` 0/1/2) takes of an SM,
    and its grid for n elements of c channels (needs the card):
    ``blocks_per_sm``, ``registers``, ``local_bytes``, ``threads``,
    ``grid``."""
    info = (ctypes.c_int * 5)()
    _build.check(_build.library("bn_act").egotap_bn_act_occupancy(
        _VEC[dtype][1], residual, n, c, ctypes.addressof(info)),
        "bn_act occupancy")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "threads",
                     "grid"), info))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t   # 16-byte vectors


def _launch(x: torch.Tensor, residual: Optional[torch.Tensor],
            vectors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Check what kernel E covers and launch it: ``vectors`` as in
    `_plain`."""
    if x.dtype not in _VEC:
        raise NotImplementedError(f"bn_act kernel: dtype {x.dtype}")
    vec, code = _VEC[x.dtype]
    c = x.shape[-1] if x.dim() else 0
    if c == 0 or c % vec:
        raise NotImplementedError(
            f"bn_act kernel: channels {c} not a positive multiple of {vec}")
    if residual is not None and (residual.shape != x.shape
                                 or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise NotImplementedError(
            f"bn_act kernel: residual {tuple(residual.shape)} "
            f"{residual.dtype} on {residual.device}, x {tuple(x.shape)} "
            f"{x.dtype} on {x.device}")
    for t in vectors:
        if t is None:
            raise NotImplementedError(
                "bn_act kernel: a BatchNorm without affine parameters")
        if (t.dtype != torch.float32 or t.device != x.device
                or t.shape != (c,)):
            raise NotImplementedError(
                f"bn_act kernel: BatchNorm vector {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, not f32 ({c},) on "
                f"{x.device}")
    x = _aligned(x)
    out = torch.empty_like(x)
    mode = 0
    r_ptrs = [None] * 4
    if residual is not None:
        residual = _aligned(residual)
        mode = 1 if len(vectors) == 4 else 2
    vectors = [t.contiguous() for t in vectors]
    if mode == 2:
        r_ptrs = [t.data_ptr() for t in vectors[4:]]
    _build.check(_build.library("bn_act").egotap_bn_act(
        x.data_ptr(), None if residual is None else residual.data_ptr(),
        out.data_ptr(), *[t.data_ptr() for t in vectors[:4]], *r_ptrs,
        x.numel(), c, code, mode, BN_EPS, _build.stream_ptr(x)), "bn_act")
    return out


class _KernelE(torch.autograd.Function):
    """Kernel E forward; backward: autograd over the plain sequence,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, residual, *vectors):
        ctx.save_for_backward(x, residual, *vectors)
        return _launch(x, residual, vectors)

    @staticmethod
    def backward(ctx, grad):
        x, residual, *vectors = ctx.saved_tensors
        need = ctx.needs_input_grad
        if residual is not None:
            return plain_vjp(_plain, (x, residual, *vectors), need, grad,
                             BACKWARD_LABEL)
        grads = plain_vjp(lambda x, *v: _plain(x, None, *v), (x, *vectors),
                          need[:1] + need[2:], grad, BACKWARD_LABEL)
        return (grads[0], None, *grads[1:])


def bn_act(x: torch.Tensor, bn: nn.modules.batchnorm._BatchNorm,
           residual: Optional[torch.Tensor] = None,
           residual_bn: Optional[nn.modules.batchnorm._BatchNorm] = None
           ) -> torch.Tensor:
    """Eval-mode ``bn`` on NHWC x, plus ``residual`` (through
    ``residual_bn`` first, when given), then ReLU: kernel E on the card,
    `bn_act_plain` on the CPU, with the same result."""
    if x.device.type == "cpu":
        return bn_act_plain(x, bn, residual, residual_bn)
    vectors = stats(bn) + (() if residual_bn is None else stats(residual_bn))
    inputs = (x, residual, *vectors)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        out = _KernelE.apply(*inputs)
    else:                # no graph to record: skip the Function's host time
        out = _launch(x, residual, vectors)
    bn_act.launches += 1
    return out


bn_act.launches = 0
