"""The passes around an int8 product, in two launches: kernel F.

An int8 convolution or dense product of `ops/quant.py` on the card is
three launches: kernel F's pack (quantise, im2col and padding into the
rows that ``torch._int_mm`` takes), the library's integer product, and
kernel F's epilogue (dequantise and bias). The plain sequence they
replace is `quant.conv_plain` / `quant.dense_plain`: `quantize_activation`,
`im2col`, `int8_matmul` (which pads its operands, the weight's rows at
every call) and `dequantize`, about 15 launches a product. The JAX package
has no kernel for these passes; XLA fuses them there.

  * `pack` (``csrc/int8_pack.cu``): NHWC x in f32 or bf16 and the 0-d f32
    activation scale on the device -> (Mp, Kp) int8 rows, Kp = K rounded
    up to 8 and Mp = 32 when M <= 16 (what ``torch._int_mm`` needs on the
    card), zeros in the image border, the K tail and the padded rows. A
    dense product or a `QuantStub` packs (M, 1, 1, K) with k = 1. Its
    plain twin is `pack_plain`.
  * `epilogue`: the (Mp, Np) int32 product -> (M, N) in x's dtype,
    ``acc * (a_scale * w_scale) + bias`` rounded as `quant.dequantize`
    rounds it. Its plain twin is `epilogue_plain`.
  * `weight_rows`: a weight's (Np, Kp) int8 rows, zero-padded, laid out
    once, at a module's first product on the card (`WeightCache.rows_for`),
    and kept beside its int8 weight.
  * `dense_sum`: the row-parallel product of `parallel/tp.py`, one pack
    and one product on each device of the group and one epilogue for
    their exact int32 sum.

Both entry points equal their plain twins bit for bit (`TOL`): the
quotient is the IEEE one, rounding half to even, and nothing is
contracted into an FMA. They take f32 or bf16 and raise
NotImplementedError for anything else; a non-contiguous or misaligned x
is copied first, as kernel E does. Each launch counts in
``int8_pack.launches`` and ``int8_epilogue.launches``
(`ops.launch_counts`). `conv`, `dense` and `quantize` are
`quant.quantized_conv`, `quant.quantized_dense` and `quant.quantize_input`
on the card. The padding, the counted library call (`quant.int_mm`, in
its ``int8.matmul`` span) and the dynamic scale are the plain sequence's
own (`quant.padded`, `quant.dynamic_scale`).

Gradients: when one is asked for (the int8 training mode), the three
launches are the forward of `_KernelF`, whose backward is autograd over
the plain sequence recomputed from the saved scales and bias
(`ops.plain_vjp`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from egotap_tpu_torch.ops import _build, plain_vjp, quant
from egotap_tpu_torch.utils import profiling

# kernel vs plain twin on the card, (max, rms) relative error
# (`ops.kernel_errors`): each rounds every operation as the plain sequence
# does, so both are exact
TOL = {torch.float32: (0.0, 0.0), torch.bfloat16: (0.0, 0.0)}

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
PACK_VECS = (16, 8, 4, 1)           # codes a chunk of the pack
EPILOGUE_VECS = (8, 4, 2, 1)        # outputs a chunk of the epilogue
TILE = 2048                         # chunks a block, at most about
# fewer rows a block for a smaller call, down to one: at least this many
# blocks (four an SM of the H100's 132) where there are the rows
MIN_BLOCKS = 4 * 132

BACKWARD_LABEL = "kernel F backward (plain recompute)"   # profiler range


def _geometry(width: int, rows: int, row_length: int, vecs
              ) -> Tuple[int, int]:
    vec = next(v for v in vecs if width % v == 0)
    return vec, max(1, min(TILE // (row_length // vec), rows // MIN_BLOCKS))


def pack_geometry(c: int, mp: int, kp: int) -> Tuple[int, int]:
    """(codes a chunk, rows a block) of the pack for C channels and (Mp,
    Kp) rows: the widest chunk that C divides, so that a chunk never
    crosses a tap."""
    return _geometry(c, mp, kp, PACK_VECS)


def epilogue_geometry(m: int, n: int) -> Tuple[int, int]:
    """(outputs a chunk, rows a block) of the epilogue for (M, N)
    outputs."""
    return _geometry(n, m, n, EPILOGUE_VECS)


def weight_rows(wq: torch.Tensor) -> torch.Tensor:
    """An int8 weight (OIHW conv or (out, in) dense) -> its (Np, Kp) rows,
    each output channel's im2col row (`quant.conv_weight_rows`) zero-padded
    to a multiple of 8 both ways; contiguous, so that ``rows.t()`` is the
    column-major B of ``torch._int_mm``."""
    rows = quant.conv_weight_rows(wq) if wq.dim() == 4 else wq
    n, k = rows.shape
    return F.pad(rows, (0, -k % 8, 0, -n % 8)).contiguous()


def _out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


def pack_plain(x: torch.Tensor, a_scale: torch.Tensor, kernel: int = 1,
               stride: int = 1, padding: int = 0
               ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Plain twin of `pack`: `quant.quantize_activation`, `quant.im2col`,
    then the rows padded to 32 when there are at most 16."""
    xq, _ = quant.quantize_activation(x, a_scale)
    cols, out_hw = quant.im2col(xq, kernel, stride, padding)
    mp, _ = quant.padded(cols.shape[0], cols.shape[1])
    if mp != cols.shape[0]:
        cols = F.pad(cols, (0, 0, 0, mp - cols.shape[0]))
    return cols, out_hw


def epilogue_plain(acc: torch.Tensor, m: int, n: int, a_scale: torch.Tensor,
                   w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                   dtype: torch.dtype) -> torch.Tensor:
    """Plain twin of `epilogue`: `quant.dequantize` of the (m, n) corner."""
    return quant.dequantize(acc[:m, :n], a_scale, w_scale, bias, dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t   # 16-byte vectors


def _check_scale(a_scale: torch.Tensor, x: torch.Tensor, what: str) -> None:
    if (a_scale.dtype != torch.float32 or a_scale.numel() != 1
            or a_scale.device != x.device):
        raise NotImplementedError(
            f"int8 {what} kernel: scale {a_scale.dtype} "
            f"{tuple(a_scale.shape)} on {a_scale.device}, not one f32 on "
            f"{x.device}")


def pack(x: torch.Tensor, a_scale: torch.Tensor, kernel: int = 1,
         stride: int = 1, padding: int = 0
         ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """Kernel F's pack of NHWC x for a ``kernel`` x ``kernel`` convolution
    (stride, zero padding): ((Mp, Kp) int8 rows, (Ho, Wo)), as
    `pack_plain`."""
    if x.dtype not in _DTYPE:
        raise NotImplementedError(f"int8 pack kernel: dtype {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise NotImplementedError(
            f"int8 pack kernel: x {tuple(x.shape)}, not a non-empty NHWC")
    _check_scale(a_scale, x, "pack")
    n, h, w, c = x.shape
    ho, wo = (_out_size(s, kernel, stride, padding) if stride >= 1 else 0
              for s in (h, w))
    if kernel < 1 or padding < 0 or ho < 1 or wo < 1:
        raise NotImplementedError(
            f"int8 pack kernel: kernel {kernel}, stride {stride}, padding "
            f"{padding} on {h} x {w}")
    m, k = n * ho * wo, kernel * kernel * c
    mp, kp = quant.padded(m, k)
    vec, rows_per_block = pack_geometry(c, mp, kp)
    if max(mp, kp) >= 2 ** 31:
        raise NotImplementedError(
            f"int8 pack kernel: {m} rows of {k} past its 2^31 indices")
    x = _aligned(x)
    rows = torch.empty(mp, kp, dtype=torch.int8, device=x.device)
    _build.check(_build.library("int8_pack").egotap_int8_pack(
        x.data_ptr(), a_scale.data_ptr(), rows.data_ptr(), n, h, w, c,
        kernel, stride, padding, ho, wo, mp, kp, _DTYPE[x.dtype], vec,
        rows_per_block, _build.stream_ptr(x)), "int8 pack")
    pack.launches += 1
    return rows, (ho, wo)


def epilogue(acc: torch.Tensor, m: int, n: int, a_scale: torch.Tensor,
             w_scale: torch.Tensor, bias: Optional[torch.Tensor],
             dtype: torch.dtype) -> torch.Tensor:
    """Kernel F's epilogue: the (m, n) corner of the int32 product ``acc``
    dequantised to ``dtype``, as `epilogue_plain`."""
    if dtype not in _DTYPE:
        raise NotImplementedError(f"int8 epilogue kernel: dtype {dtype}")
    if (acc.dtype != torch.int32 or acc.dim() != 2 or not acc.is_contiguous()
            or acc.shape[0] < m or acc.shape[1] < n or m < 1 or n < 1):
        raise NotImplementedError(
            f"int8 epilogue kernel: product {acc.dtype} {tuple(acc.shape)} "
            f"for ({m}, {n})")
    _check_scale(a_scale, acc, "epilogue")
    vectors = [w_scale] + ([] if bias is None else [bias.float()])
    for t in vectors:
        if (t.dtype != torch.float32 or t.shape != (n,)
                or t.device != acc.device):
            raise NotImplementedError(
                f"int8 epilogue kernel: scale or bias {t.dtype} "
                f"{tuple(t.shape)} on {t.device}, not f32 ({n},) on "
                f"{acc.device}")
    vec, rows_per_block = epilogue_geometry(m, n)
    if acc.shape[1] % vec or max(acc.shape) >= 2 ** 31:
        raise NotImplementedError(
            f"int8 epilogue kernel: product {tuple(acc.shape)} for "
            f"({m}, {n})")
    vectors = [t.contiguous() for t in vectors]
    out = torch.empty(m, n, dtype=dtype, device=acc.device)
    _build.check(_build.library("int8_pack").egotap_int8_epilogue(
        acc.data_ptr(), a_scale.data_ptr(), vectors[0].data_ptr(),
        vectors[1].data_ptr() if bias is not None else None, out.data_ptr(),
        m, n, acc.shape[1], _DTYPE[dtype], vec, rows_per_block,
        _build.stream_ptr(acc)), "int8 epilogue")
    epilogue.launches += 1
    return out


pack.launches = 0
epilogue.launches = 0


class _KernelF(torch.autograd.Function):
    """Kernel F's launches (``run``) forward; backward: autograd over the
    plain sequence (``plain``), recomputed from the saved inputs. Its
    inputs are what the plain sequence differentiates: the scales and the
    bias. The codes cut x off (the plain sequence casts them to int8), so
    x reaches the gradient only through a dynamic scale, made outside."""

    @staticmethod
    def forward(ctx, run, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return run(*tensors)

    @staticmethod
    def backward(ctx, grad):
        return (None, None, *plain_vjp(ctx.plain, ctx.saved_tensors,
                                       ctx.needs_input_grad[2:], grad,
                                       BACKWARD_LABEL))


def _apply(run, plain, *tensors: torch.Tensor) -> torch.Tensor:
    """``run(*tensors)``, as `_KernelF`'s forward when a gradient is asked
    for (else the Function's host time is skipped)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _KernelF.apply(run, plain, *tensors)
    return run(*tensors)


def _tensors(bias: Optional[torch.Tensor]) -> tuple:
    return () if bias is None else (bias,)


def _bias(rest):
    return rest[0] if rest else None


def conv(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
         stride: int, padding: int, bias: Optional[torch.Tensor],
         a_scale: Optional[torch.Tensor],
         w_rows: Optional[torch.Tensor]) -> torch.Tensor:
    """`quant.quantized_conv` by kernel F: ``w_rows`` is
    `weight_rows(wq)` (made here when None)."""
    kernel, n_out = wq.shape[-1], wq.shape[0]
    if a_scale is None:
        a_scale = quant.dynamic_scale(x)
    if w_rows is None:
        w_rows = weight_rows(wq)

    def run(a_scale, w_scale, *rest):
        rows, (ho, wo) = pack(x, a_scale, kernel, stride, padding)
        m = x.shape[0] * ho * wo
        acc = quant.int_mm(rows, w_rows.t(), m, n_out,
                           kernel * kernel * x.shape[-1])
        out = epilogue(acc, m, n_out, a_scale, w_scale, _bias(rest), x.dtype)
        return out.view(x.shape[0], ho, wo, n_out)

    def plain(a_scale, w_scale, *rest):
        return quant.conv_plain(x, wq, w_scale, stride, padding, _bias(rest),
                                a_scale)
    return _apply(run, plain, a_scale, w_scale, *_tensors(bias))


def _code_rows(xq: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Codes already made (a `QuantStub`'s, in its input's shape) as the
    rows ``torch._int_mm`` takes: a view where they fit, else a padded
    copy (no served model has such a stub: its K is a multiple of 8 and
    its M above 16)."""
    rows = xq.reshape(m, k)
    mp, kp = quant.padded(m, k)
    if (mp, kp) != (m, k):
        rows = F.pad(rows, (0, kp - k, 0, mp - m))
    return rows.contiguous()


def dense(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
          bias: Optional[torch.Tensor], a_scale: Optional[torch.Tensor],
          pre_q: Optional[Tuple[torch.Tensor, torch.Tensor]],
          w_rows: Optional[torch.Tensor]) -> torch.Tensor:
    """`quant.quantized_dense` by kernel F: ``w_rows`` is
    `weight_rows(wq)` (made here when None)."""
    n_out, k = wq.shape
    m = x.numel() // k
    lead = x.shape[:-1]
    if w_rows is None:
        w_rows = weight_rows(wq)

    def product(rows, a_scale, w_scale, rest):
        acc = quant.int_mm(rows, w_rows.t(), m, n_out, k)
        out = epilogue(acc, m, n_out, a_scale, w_scale, _bias(rest), x.dtype)
        return out.view(*lead, n_out)
    if pre_q is not None:
        xq, a_scale = pre_q

        def run(a_scale, w_scale, *rest):
            return product(_code_rows(xq, m, k), a_scale, w_scale, rest)

        def plain(a_scale, w_scale, *rest):
            return quant.dense_plain(x, wq, w_scale, _bias(rest),
                                     pre_q=(xq, a_scale))
        return _apply(run, plain, a_scale, w_scale, *_tensors(bias))
    if a_scale is None:
        a_scale = quant.dynamic_scale(x)

    def run(a_scale, w_scale, *rest):
        rows, _ = pack(x.reshape(m, 1, 1, k), a_scale)
        return product(rows, a_scale, w_scale, rest)

    def plain(a_scale, w_scale, *rest):
        return quant.dense_plain(x, wq, w_scale, _bias(rest), a_scale)
    return _apply(run, plain, a_scale, w_scale, *_tensors(bias))


def quantize(x: torch.Tensor, a_scale: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quant.quantize_input` by kernel F's pack: (int8 codes in x's shape,
    scale), as `quant.quantize_activation` gives them."""
    if a_scale is None:
        a_scale = quant.dynamic_scale(x)
    k = x.shape[-1]
    m = x.numel() // k
    rows, _ = pack(x.reshape(m, 1, 1, k), a_scale)
    if rows.shape != (m, k):
        rows = rows[:m, :k]
    return rows.reshape(x.shape), a_scale


def dense_sum_plain(xs: List[torch.Tensor], a_scale: torch.Tensor,
                    w_qs: List[torch.Tensor], w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain twin of `dense_sum` (its CPU path)."""
    home, x0 = a_scale.device, xs[0]
    acc = sum(quant.int8_matmul(
        quant.quantize_activation(x, a_scale.to(x.device))[0]
        .reshape(-1, x.shape[-1]), w_q).to(home) for x, w_q in zip(xs, w_qs))
    out = quant.dequantize(acc, a_scale, w_scale, bias, x0.dtype)
    return out.view(*x0.shape[:-1], -1)


def dense_sum(xs: List[torch.Tensor], a_scale: torch.Tensor,
              w_qs: List[torch.Tensor], w_rows: List[Optional[torch.Tensor]],
              w_scale: torch.Tensor, bias: Optional[torch.Tensor]
              ) -> torch.Tensor:
    """``sum_i xs[i] @ w_qs[i].T`` in int8, each product on the device of
    its x, the int32 partials summed exactly onto ``a_scale``'s device and
    dequantised once there with the whole product's ``w_scale`` and
    ``bias``: the row-parallel product of `parallel/tp.py`. On the card a
    pack and a product on each device (``w_rows[i]``:
    `weight_rows(w_qs[i])`) and one epilogue; on the CPU the plain
    sequence. Returns xs[0]'s dtype."""
    home, x0 = a_scale.device, xs[0]
    m, n = x0.numel() // x0.shape[-1], w_scale.shape[0]

    def run(a_scale, w_scale, *rest):
        acc = sum(quant.int_mm(
            pack(x.reshape(m, 1, 1, -1), a_scale.to(x.device))[0], rows.t(),
            m, n, x.shape[-1]).to(home) for x, rows in zip(xs, w_rows))
        out = epilogue(acc, m, n, a_scale, w_scale, _bias(rest), x0.dtype)
        return out.view(*x0.shape[:-1], n)

    def plain(a_scale, w_scale, *rest):
        return dense_sum_plain(xs, a_scale, w_qs, w_scale, _bias(rest))
    with profiling.span("int8.dense"):
        if home.type == "cpu":
            return dense_sum_plain(xs, a_scale, w_qs, w_scale, bias)
        return _apply(run, plain, a_scale, w_scale, *_tensors(bias))
