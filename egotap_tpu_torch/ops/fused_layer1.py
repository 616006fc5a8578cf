"""Fused int8 ResNet layer1: every residual-block conv of the stage in
one call, with a per-image activation scale.

Counterpart of `egotap_tpu/ops/fused_layer1.py`. For each image the
stage runs 2n convs (4 for resnet18); each conv:
  1. ``a_scale = max(max|act|, 1e-12) / 127`` over the whole image,
  2. codes ``clip(round_half_even(act / a_scale), -127, 127)``,
  3. a 3x3 pad-1 conv of the codes with ``w_q[conv]`` (im2col rows
     ``(di * 3 + dj) * C + c``) accumulated in int32,
  4. ``out = acc * (a_scale * w_scale[conv]) + bias[conv]`` in f32,
  5. ReLU after even convs; after odd convs ``relu(out + residual)``,
     which becomes the next residual.
The activation stays f32 from ``x.float()`` on and is rounded once, to
x's dtype, at the end. BatchNorm is folded into the weights first
(`fold_bn`, `pack_blocks`).

`fused_layer1_int8` runs kernel D (``csrc/fused_layer1.cu``: one
thread-block cluster holds each image on chip for the whole stage) for a
CUDA tensor and `fused_layer1_plain` for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import re
from typing import Sequence, Tuple

import torch

from egotap_tpu_torch.ops import _build, refuse_grad
from egotap_tpu_torch.ops.quant import (conv_weight_rows, f32_scalar, im2col,
                                        int8_matmul, quantize_weights)

CHANNELS = 64                 # the kernel's channel count (every layer1)


def fold_bn(weight: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            mean: torch.Tensor, var: torch.Tensor, eps: float
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold inference BatchNorm into an OIHW conv weight: returns
    (weight', bias') with conv'(x) = BN(conv(x)). The f32 square root is
    taken in f64 and rounded once, which is the correctly rounded f32
    root that JAX computes (PyTorch's vectorised f32 root on the CPU is
    not, in about 1% of values)."""
    root = torch.sqrt((var.float() + eps).double()).float()
    g = scale.float() / root
    return weight.float() * g[:, None, None, None], \
        (bias.float() - mean.float() * g).float()


@torch.no_grad()
def pack_blocks(blocks: Sequence, eps: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold and quantize a stage's BasicBlocks (modules with conv1, bn1,
    conv2, bn2). Returns (w_q (2n, 9C, C) int8 with im2col rows
    ``(di * 3 + dj) * C + c``, w_scale (2n, C) f32, bias (2n, C) f32) in
    conv execution order."""
    wqs, wss, bs = [], [], []
    for blk in blocks:
        for conv, bn in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2)):
            w, b = fold_bn(conv.weight, bn.weight, bn.bias, bn.running_mean,
                           bn.running_var, eps)
            wq, ws = quantize_weights(w)
            wqs.append(conv_weight_rows(wq).t())
            wss.append(ws)
            bs.append(b)
    return torch.stack(wqs), torch.stack(wss), torch.stack(bs)


def fused_layer1_plain(x: torch.Tensor, w_q: torch.Tensor,
                       w_scale: torch.Tensor, bias: torch.Tensor
                       ) -> torch.Tensor:
    """Plain PyTorch version of kernel D (JAX `fused_layer1_reference`);
    takes any number of convs."""
    n, h, w, c = x.shape
    act = x.float()
    residual = act
    for conv in range(w_q.shape[0]):
        a_scale = torch.clamp_min(act.abs().amax(dim=(1, 2, 3), keepdim=True),
                                  1e-12) / f32_scalar(act, 127.0)
        aq = torch.round(act / a_scale).clamp_(-127, 127).to(torch.int8)
        cols, _ = im2col(aq, 3, 1, 1)
        acc = int8_matmul(cols, w_q[conv].t()).reshape(n, h, w, -1)
        out = acc.float() * (a_scale * w_scale[conv]) + bias[conv]
        if conv % 2 == 0:
            act = torch.relu(out)
        else:
            act = torch.relu(out + residual)
            residual = act
    return act.to(x.dtype)


# kernel vs `fused_layer1_plain` on the card, (max, rms) relative error
# (`ops.kernel_errors`). Both sides run the same operations in the same
# order per value: IEEE division, round half to even, exact int32 sums,
# the dequantization without FMA contraction, one final rounding. On an
# H100 the kernel equals the plain version bit for bit at every shape
# tried, in f32 and bf16 (reading 0); the limits only leave room for
# rounding noise. The faulty controls of `chip_smoke.py` read far above
# them: one scale for the whole batch (6.4e-3, 8.8e-3), one scale per
# block's 256 pixels instead of per image (4.4e-2, 1.7e-2), the residual
# dropped from the second block (1.0, 0.94).
TOL = {torch.float32: (1e-6, 1e-7), torch.bfloat16: (1e-6, 1e-7)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

PIXELS_MAX = 256              # pixels a block (8 warps of 32), at most
MAX_CLUSTER = 16              # blocks a cluster (one cluster an image)
PIX = 80                      # bytes per pixel of a code tile
WPITCH = 9 * CHANNELS + 16    # bytes per output channel of the weights
SMEM_LIMIT = 232448           # shared memory a block may opt in to
STATIC_SMEM = 1088            # the kernel's static shared memory


def cluster_geometry(h: int, w: int) -> dict:
    """How kernel D cuts one (h, w) image over its cluster: ``pixels`` a
    block (a multiple of 32, at most 256: the image's pixels over 16
    blocks, rounded up), ``cluster`` blocks (one cluster an image, the
    last block's run may be short), ``tile_rows`` the most rows a block's
    padded tile spans (its rows plus a one-row halo), ``smem`` bytes a
    block. Raises NotImplementedError for an image the cluster cannot
    hold on chip: more than 16 x 256 = 4096 pixels, or rows too wide for
    a block's shared memory."""
    hw = h * w
    per_block = -(-hw // MAX_CLUSTER)               # ceil(hw / 16)
    pb = 32 * -(-per_block // 32)                   # rounded up to a warp
    if pb > PIXELS_MAX:
        raise NotImplementedError(
            f"fused layer1 kernel: an image of {h}x{w} = {hw} pixels exceeds "
            f"one cluster's {MAX_CLUSTER} blocks x {PIXELS_MAX} pixels = "
            f"{MAX_CLUSTER * PIXELS_MAX}")
    tile_rows = max((min(p0 + pb, hw) - 1) // w - p0 // w + 3
                    for p0 in range(0, hw, pb))
    smem = 2 * CHANNELS * WPITCH + tile_rows * (w + 2) * PIX
    if smem + STATIC_SMEM > SMEM_LIMIT:
        raise NotImplementedError(
            f"fused layer1 kernel: rows of width {w} need {smem} bytes of "
            f"shared memory a block, more than {SMEM_LIMIT}")
    return {"pixels": pb, "cluster": -(-hw // pb), "tile_rows": tile_rows,
            "smem": smem}


def kernel_weights(w_q: torch.Tensor) -> torch.Tensor:
    """`pack_blocks`' (n_convs, 9C, C) int8 weights as kernel D reads
    them: (n_convs, C, WPITCH) rows [out channel][im2col k], zero padded
    to the pitch the `mma` fragment loads want. Made once and kept on
    ``w_q`` (again only after ``w_q`` changes in place)."""
    kept = getattr(w_q, "_kernel_rows", None)
    if kept is not None and kept[0] == w_q._version:
        return kept[1]
    rows = torch.zeros((w_q.shape[0], w_q.shape[2], WPITCH),
                       dtype=torch.int8, device=w_q.device)
    rows[:, :, :w_q.shape[1]] = w_q.transpose(1, 2)
    w_q._kernel_rows = (w_q._version, rows)
    return rows


def kernel_resources(dtype: torch.dtype, h: int, w: int) -> dict:
    """What kernel D in ``dtype`` takes at an (h, w) image (needs the
    card): ``registers``, spill bytes and static shared memory from
    ``ptxas -v``; from the runtime ``runtime_registers``, ``local_bytes``,
    ``smem_bytes`` and ``threads`` a block, ``blocks_per_sm``, ``sms``,
    and ``max_active_clusters`` (``cudaOccupancyMaxActiveClusters`` at
    the image's ``cluster`` size)."""
    tag = {torch.float32: "layer1_kernelIfE",
           torch.bfloat16: "layer1_kernelI13__nv_bfloat16E"}[dtype]
    log = _build.build_log("fused_layer1")
    entry = [part for part in log.split("Compiling entry function")
             if tag in part.split("\n", 1)[0]]
    if len(entry) != 1:
        raise RuntimeError(f"the build log holds no single {tag}:\n{log}")

    def read(pattern):
        found = re.search(pattern, entry[0])
        return int(found.group(1)) if found else 0
    geo = cluster_geometry(h, w)
    info = (ctypes.c_int * 7)()
    _build.check(_build.library("fused_layer1").egotap_fused_layer1_occupancy(
        _DTYPE_CODE[dtype], w, geo["pixels"], geo["cluster"],
        geo["tile_rows"], ctypes.addressof(info)), "fused_layer1 occupancy")
    return dict(geo, registers=read(r"Used (\d+) registers"),
                spill_store_bytes=read(r"(\d+) bytes spill stores"),
                spill_load_bytes=read(r"(\d+) bytes spill loads"),
                static_smem_bytes=read(r"(\d+) bytes smem"),
                max_active_clusters=info[0], runtime_registers=info[1],
                local_bytes=info[2], smem_bytes=info[3], threads=info[4],
                blocks_per_sm=info[5], sms=info[6])


def fused_layer1_int8(x: torch.Tensor, w_q: torch.Tensor,
                      w_scale: torch.Tensor, bias: torch.Tensor
                      ) -> torch.Tensor:
    """x (N, H, W, 64) -> (N, H, W, 64); w_q/w_scale/bias from
    `pack_blocks` (stride-1, equal-channel blocks: every layer1).

    On the card one thread-block cluster holds each image on chip for the
    whole stage (`cluster_geometry`): an image of more than 4096 pixels
    (64 x 64) raises NotImplementedError, as the JAX kernel holds one
    image in VMEM."""
    if x.device.type == "cpu":
        return fused_layer1_plain(x, w_q, w_scale, bias)
    n, h, w, c = x.shape
    n_convs = w_q.shape[0]
    if c != CHANNELS:
        raise NotImplementedError(f"fused layer1 kernel covers {CHANNELS} "
                                  f"channels, got {c}")
    if x.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"fused layer1 kernel: dtype {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused layer1 kernel: x must be contiguous NHWC")
    if (w_q.dtype != torch.int8 or w_q.shape != (n_convs, 9 * c, c)
            or n_convs % 2 or n_convs == 0
            or w_scale.shape != (n_convs, c) or bias.shape != (n_convs, c)):
        raise ValueError("w_q/w_scale/bias must come from pack_blocks")
    if any(t.device != x.device for t in (w_q, w_scale, bias)):
        raise ValueError("x, w_q, w_scale and bias must share a device")
    if n > 65535:
        raise NotImplementedError("fused layer1 kernel: N <= 65535")
    geo = cluster_geometry(h, w)
    refuse_grad("fused layer1", x, w_scale, bias)
    rows = kernel_weights(w_q)
    w_scale, bias = (t.float().contiguous() for t in (w_scale, bias))
    out = torch.empty_like(x)
    lib = _build.library("fused_layer1")
    _build.check(lib.egotap_fused_layer1(
        x.data_ptr(), rows.data_ptr(), w_scale.data_ptr(), bias.data_ptr(),
        out.data_ptr(), n, h, w, geo["pixels"], geo["cluster"],
        geo["tile_rows"], n_convs, _DTYPE_CODE[x.dtype],
        _build.stream_ptr(x)), "fused_layer1")
    fused_layer1_int8.launches += 1
    return out


fused_layer1_int8.launches = 0
