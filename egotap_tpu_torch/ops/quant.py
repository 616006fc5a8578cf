"""int8 inference ops: quantized convolutions (stage-1 UNets) and matrix
products (lifter), with static calibrated activation scales.

Counterpart of `egotap_tpu/ops/quant.py`, same scheme and numerics:
  * weights: symmetric per-output-channel int8, ``w_scale = max(max|w| /
    127, 1e-12)``, computed once per module and kept (`WeightCache`:
    filled by `prequantize` off the hot path, the counterpart of
    `quantize_conv_tree` / `quantize_dense_tree`, or else at first use;
    dropped whenever parameters load);
  * activations: symmetric per-tensor int8, ``a_scale = max(max|x|,
    1e-12) / 127`` per call (dynamic) or a static calibrated scale;
  * codes ``clip(round_half_even(x / a_scale), -127, 127)``, products
    accumulated in int32 and dequantized as ``acc * (a_scale * w_scale)
    + bias`` in f32, then cast to the input's dtype.

The int32 products go through ``torch._int_mm`` (one library integer
GEMM, as the JAX package leaves them to XLA's ``dot_general``); a conv is
an NHWC im2col in int8 (rows ordered ``(di * k + dj) * C + c``, the JAX
HWIO kernel's reshape) times the packed weight. On the CPU that is the
plain sequence below (`conv_plain`, `dense_plain`); on the card
`quantized_conv`, `quantized_dense` and `QuantStub` run kernel F
(`ops/int8_pack.py`): one pack launch before the product and one
epilogue after it, equal to the plain sequence bit for bit, on weight
rows padded once, at the first product on the card (``w_rows``, beside
``w_q``). ``F.conv2d`` has no int8
path, and a float conv of the codes is not exact once a sum passes 2^24.
Divisions by a constant divide by a tensor: on the card PyTorch turns a
division by a Python float into a multiply by its reciprocal, which is
not the IEEE quotient that JAX computes.

Modules (same gating as the JAX `QConv` / `QDense` / `QuantStub`):
  * `QConv` — nn.Conv2d on NHWC: in_ch < 64 is never quantized; 64 <=
    in_ch < 128 is quantized only with a static ``a_scale`` (else a float
    conv in the compute dtype); in_ch >= 128 always. In training mode its
    weights are quantized anew at every call (JAX's `QConv` under
    ``train=True``, which rounds inline).
  * `QDense` — nn.Linear, always quantized; ``pre_q`` shares one
    quantized input between several consumers (and records no amax).
  * `QuantStub` — quantizes one activation once for several `QDense`.
Calibration (`calibrating`): every module that reads its static scale
also records ``max|x|`` in f32 (JAX `_calib_or_static`); `install_scales`
turns the records into ``a_scale`` (JAX `amax_to_qparams` +
`merge_qparams`). State dicts are unchanged: the int8 weights and scales
are non-persistent buffers, so reference checkpoints strict-load.

Tracing (`utils/profiling.py`): `quantized_conv` runs in the span
``int8.conv``, `quantized_dense` and `QuantStub` in ``int8.dense``, and
the integer product of `int_mm` (the library call alone, after its
operands are padded and laid out) in ``int8.matmul``; under a profiler
these are the ranges ``egotap.int8.*``. Counters of the innermost root
span: ``int8.products`` (products run), ``int8.macs`` (M·N·K of each, the
sizes before padding) and ``int8.float_convs`` (convolutions of an int8
net that ran as float convolutions for want of a static scale).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from egotap_tpu_torch.utils import profiling

QMAX = 127.0


def f32_scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d f32 tensor on ``like``'s device (for IEEE division)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def quantize_weights(weight: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, ...) weight -> (int8 weight, per-out-channel f32 scale).

    The port keeps the output channel first (conv OIHW, linear (out,
    in)), so JAX's per-last-axis scale is a per-first-axis scale here."""
    w = weight.float()
    amax = w.abs().amax(dim=tuple(range(1, w.dim())))
    w_scale = torch.clamp_min(amax / f32_scalar(w, QMAX), 1e-12)
    shape = (-1,) + (1,) * (w.dim() - 1)
    wq = torch.round(w / w_scale.reshape(shape)).clamp_(-127, 127)
    return wq.to(torch.int8), w_scale


def quantize_activation(x: torch.Tensor,
                        a_scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x -> (int8 codes, 0-d f32 scale): the static ``a_scale`` or, when
    None, the dynamic ``max(max|x|, 1e-12) / 127``."""
    xf = x.float()
    if a_scale is None:
        a_scale = dynamic_scale(xf)
    xq = torch.round(xf / a_scale).clamp_(-127, 127).to(torch.int8)
    return xq, a_scale


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The dynamic activation scale of x: ``max(max|x|, 1e-12) / 127``,
    0-d f32."""
    xf = x.float()
    return torch.clamp_min(xf.abs().amax(), 1e-12) / f32_scalar(xf, QMAX)


def padded(m: int, k: int) -> Tuple[int, int]:
    """(Mp, Kp): the rows and the row length that ``torch._int_mm`` takes
    on the card for an (m, k) operand: K a multiple of 8, more than 16
    rows (32 for 16 or fewer)."""
    return (32 if m <= 16 else m), -(-k // 8) * 8


def int_mm(a: torch.Tensor, b: torch.Tensor, m: int, n: int, k: int
           ) -> torch.Tensor:
    """``torch._int_mm(a, b)`` of operands already padded (`padded`),
    counted as the (m, n, k) product it holds (``int8.products``,
    ``int8.macs`` = M·N·K before padding) and run in the span
    ``int8.matmul``."""
    profiling.count("int8.products")
    profiling.count("int8.macs", m * n * k)
    with profiling.span("int8.matmul"):
        return torch._int_mm(a, b)


def int8_matmul(a: torch.Tensor, b_t: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 times (N, K) int8 transposed -> (M, N) int32, exact.

    The operands are zero-padded to what `int_mm` takes (zeros add
    nothing) and the result is cut back. B goes in column-major."""
    m, k = a.shape
    n, kb = b_t.shape
    mp, kp = padded(m, k)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if kb != kp or n % 8:
        b_t = F.pad(b_t, (0, kp - kb, 0, (-n) % 8))
    out = int_mm(a.contiguous(), b_t.contiguous().t(), m, n, kb)
    return out[:m, :n]


def im2col(xq: torch.Tensor, kernel: int, stride: int, padding: int
           ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(N, H, W, C) codes -> ((N*Ho*Wo, k*k*C) rows, (Ho, Wo)); row
    entries ordered ``(di * k + dj) * C + c``, zero-padded to a multiple
    of 8 so that `int8_matmul` makes no second copy."""
    n, h, w, c = xq.shape
    ho = (h + 2 * padding - kernel) // stride + 1
    wo = (w + 2 * padding - kernel) // stride + 1
    if padding:
        xq = F.pad(xq, (0, 0, padding, padding, padding, padding))
    taps = [xq[:, di:di + stride * (ho - 1) + 1:stride,
               dj:dj + stride * (wo - 1) + 1:stride]
            for di in range(kernel) for dj in range(kernel)]
    extra = (-kernel * kernel * c) % 8
    if extra:
        taps.append(xq.new_zeros(n, ho, wo, extra))
    cols = taps[0] if len(taps) == 1 else torch.cat(taps, dim=-1)
    return cols.reshape(n * ho * wo, -1), (ho, wo)


def conv_weight_rows(wq: torch.Tensor) -> torch.Tensor:
    """(O, C, k, k) -> (O, k*k*C): each output channel's im2col row."""
    return wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)


def dequantize(acc: torch.Tensor, a_scale: torch.Tensor,
                w_scale: torch.Tensor, bias: Optional[torch.Tensor],
                dtype: torch.dtype) -> torch.Tensor:
    out = acc.float() * (a_scale * w_scale)
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def conv_plain(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
               stride: int = 1, padding: int = 0,
               bias: Optional[torch.Tensor] = None,
               a_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`quantized_conv` as the plain sequence (the CPU path, and kernel F's
    plain twin)."""
    xq, a_scale = quantize_activation(x, a_scale)
    cols, (ho, wo) = im2col(xq, wq.shape[-1], stride, padding)
    acc = int8_matmul(cols, conv_weight_rows(wq))
    out = dequantize(acc, a_scale, w_scale, bias, x.dtype)
    return out.reshape(x.shape[0], ho, wo, -1)


def dense_plain(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                a_scale: Optional[torch.Tensor] = None,
                pre_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """`quantized_dense` as the plain sequence (the CPU path, and kernel
    F's plain twin)."""
    xq, a_scale = pre_q if pre_q is not None \
        else quantize_activation(x, a_scale)
    acc = int8_matmul(xq.reshape(-1, xq.shape[-1]), wq)
    out = dequantize(acc, a_scale, w_scale, bias, x.dtype)
    return out.reshape(*x.shape[:-1], -1)


def quantized_conv(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                   stride: int = 1, padding: int = 0,
                   bias: Optional[torch.Tensor] = None,
                   a_scale: Optional[torch.Tensor] = None,
                   w_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """NHWC int8 conv of x with an OIHW int8 weight ``wq`` and its
    per-output ``w_scale`` (`quantize_weights`), dynamic or static
    (``a_scale``) activation scale; returns x's dtype. Kernel F on the card
    (``w_rows``: `int8_pack.weight_rows(wq)`, made per call when None), the
    plain sequence on the CPU."""
    with profiling.span("int8.conv"):
        if x.device.type == "cpu":
            return conv_plain(x, wq, w_scale, stride, padding, bias, a_scale)
        from egotap_tpu_torch.ops import int8_pack
        return int8_pack.conv(x, wq, w_scale, stride, padding, bias, a_scale,
                              w_rows)


def quantized_dense(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    a_scale: Optional[torch.Tensor] = None,
                    pre_q: Optional[Tuple[torch.Tensor, torch.Tensor]]
                    = None, w_rows: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """int8 ``x @ wq.T`` (``wq`` (out, in) int8, per-output ``w_scale``);
    ``pre_q`` supplies already-quantized ``(xq, a_scale)``. Kernel F on the
    card (``w_rows`` as for `quantized_conv`), the plain sequence on the
    CPU."""
    with profiling.span("int8.dense"):
        if x.device.type == "cpu":
            return dense_plain(x, wq, w_scale, bias, a_scale, pre_q)
        from egotap_tpu_torch.ops import int8_pack
        return int8_pack.dense(x, wq, w_scale, bias, a_scale, pre_q, w_rows)


class Calibrated:
    """Static activation scale and calibration record of one module
    (JAX ``qparams/a_scale`` and ``calib/amax`` at its path)."""

    calibrating = False

    def _init_calibration(self) -> None:
        self.register_buffer("a_scale", None, persistent=False)
        self.register_buffer("amax", None, persistent=False)

    def calib_or_static(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """Record max|x| (f32) while calibrating; the static scale or
        None."""
        if self.calibrating:
            amax = x.detach().float().abs().amax()
            self.amax = amax if self.amax is None \
                else torch.maximum(self.amax, amax)
        return self.a_scale


class WeightCache:
    """int8 weights derived from a module's float parameters, kept in the
    non-persistent buffers named by ``cached``: `prequantize` fills them
    (off the hot path), the forward fills them at first use if it finds
    them empty, and loading parameters empties them, so they never go
    stale."""

    cached: Tuple[str, ...] = ("w_q", "w_scale", "w_rows")

    def _init_cache(self) -> None:
        for name in self.cached:
            self.register_buffer(name, None, persistent=False)

    def rows_for(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """``w_rows``, kernel F's layout of ``w_q``
        (`int8_pack.weight_rows`), laid out at the first product off the
        CPU and kept; None on the CPU, whose plain sequence reads
        ``w_q``."""
        if x.device.type == "cpu":
            return None
        if self.w_rows is None:
            from egotap_tpu_torch.ops.int8_pack import weight_rows
            self.w_rows = weight_rows(self.w_q)
        return self.w_rows

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        for name in self.cached:
            setattr(self, name, None)


class QConv(WeightCache, Calibrated, nn.Conv2d):
    """nn.Conv2d on NHWC input with the JAX `QConv` gating (see module
    doc); same parameters and state_dict keys as nn.Conv2d."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias)
        self._init_calibration()
        self._init_cache()

    @torch.no_grad()
    def prequantize(self) -> None:
        if self.in_channels >= 64:          # the others never quantize
            self.w_q, self.w_scale = quantize_weights(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_ch = x.shape[-1]
        a_scale = self.calib_or_static(x) if in_ch >= 64 else None
        if in_ch < 128 and a_scale is None:
            profiling.count("int8.float_convs")
            out = conv_nhwc_float(x, self.weight.to(x.dtype), self.stride[0],
                                  self.padding[0])
            return out if self.bias is None else out + self.bias.to(out.dtype)
        if self.training:
            # a training step changes the weights: quantize them anew, as
            # the JAX QConv does without qparams (no cache to go stale)
            w_q, w_scale = quantize_weights(self.weight)
            w_rows = None
        else:
            if self.w_q is None:
                self.prequantize()
            w_q, w_scale, w_rows = self.w_q, self.w_scale, self.rows_for(x)
        return quantized_conv(x, w_q, w_scale, self.stride[0],
                              self.padding[0], self.bias, a_scale, w_rows)


class QDense(WeightCache, Calibrated, nn.Linear):
    """nn.Linear running `quantized_dense` (same parameters and keys).
    Every QDense keeps its int8 weights; JAX pre-quantizes only in_dim >=
    64 and rounds the others inline, with the same result."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self._init_calibration()
        self._init_cache()

    @torch.no_grad()
    def prequantize(self) -> None:
        self.w_q, self.w_scale = quantize_weights(self.weight)

    def forward(self, x: torch.Tensor,
                pre_q: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        a_scale = self.calib_or_static(x) if pre_q is None else None
        if self.w_q is None:
            self.prequantize()
        return quantized_dense(x, self.w_q, self.w_scale, self.bias, a_scale,
                               pre_q, self.rows_for(x))


class QuantStub(Calibrated, nn.Module):
    """Quantize one activation once for several `QDense` consumers."""

    def __init__(self):
        super().__init__()
        self._init_calibration()

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with profiling.span("int8.dense"):
            return quantize_input(x, self.calib_or_static(x))


def quantize_input(x: torch.Tensor, a_scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_activation` of an input that several products share:
    kernel F's pack on the card, the plain sequence on the CPU."""
    if x.device.type == "cpu":
        return quantize_activation(x, a_scale)
    from egotap_tpu_torch.ops import int8_pack
    return int8_pack.quantize(x, a_scale)


def conv_nhwc_float(x: torch.Tensor, weight: torch.Tensor, stride: int,
                    padding: int) -> torch.Tensor:
    """Bias-free float conv of an NHWC tensor with an OIHW weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, None, stride, padding)
    return y.permute(0, 2, 3, 1)


@torch.no_grad()
def prequantize(nets: Iterable[nn.Module]) -> None:
    """Fill every int8 weight cache of ``nets`` (off the hot path)."""
    for net in nets:
        for m in net.modules():
            if hasattr(m, "prequantize"):
                m.prequantize()


def set_calibrating(nets: Iterable[nn.Module], on: bool) -> None:
    for net in nets:
        for m in net.modules():
            if isinstance(m, Calibrated):
                m.calibrating = on


def install_scales(nets: Iterable[nn.Module]) -> int:
    """Every recorded amax becomes the static ``a_scale = max(amax,
    1e-12) / 127`` of its module; returns how many were installed."""
    count = 0
    for net in nets:
        for m in net.modules():
            if isinstance(m, Calibrated) and m.amax is not None:
                m.a_scale = torch.clamp_min(m.amax, 1e-12) \
                    / f32_scalar(m.amax, QMAX)
                m.amax = None
                count += 1
    return count
