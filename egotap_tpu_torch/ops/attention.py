"""Multi-head softmax attention on the packed projection layout, and on
the unpacked (B, H, S, Dh) one.

Counterpart of `egotap_tpu/ops/attention.py:multihead_attention_packed`
and `multihead_attention`. In the packed layout q/k/v stay exactly as
the projections produce them, ``(B, S, H*Dh)``; head h is the column
block ``[h*Dh, (h+1)*Dh)``, so no transposes. The unpacked layout
flattened to ``(B*H, S, Dh)`` is the packed one with a single head.

Both wrappers run kernel B (``csrc/attention.cu``) for a CUDA tensor and
`attention_packed_plain` for a CPU tensor; each counts its own launches.
On the card the kernel is the forward of a `torch.autograd.Function`
whose backward recomputes `attention_packed_plain` from the q, k and v
the kernel saw (in their dtype) and returns its vector-Jacobian product:
the counterpart of JAX's ``custom_vjp`` (`_fused_attention_packed_bwd`,
`_fused_attention_bwd`), which recomputes its jnp formula.
Neither kernel keeps a score tile, so both take any S. The bfloat16
kernel runs both products on ``wgmma`` with the scores in registers and
two passes over the keys (p is normalised before it is rounded to bf16);
the float32 kernel runs them on the tensor cores in 3xTF32 (each f32
operand split into two TF32 parts, three TF32 products per product) in
one pass with the online softmax (running max and sum, the context
rescaled when the max moves), which in f32 is the same function up to
rounding.
Both follow the TPU kernel's numerics: f32 scores times ``1/sqrt(Dh)``,
max-subtracted softmax in f32, probabilities normalised and then rounded
to v's dtype (nothing to round in f32), ``p @ v`` accumulated in f32, one
rounding of the output.
"""

from __future__ import annotations

import ctypes
import math

import torch

from egotap_tpu_torch.ops import _build, plain_vjp

HEAD_DIM = 128            # the kernel's head width
BACKWARD_LABEL = "kernel B backward (plain recompute)"   # profiler range


def attention_packed_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           heads: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B."""
    b, s, d = q.shape
    hd = d // heads
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)

    def split(x):
        return x.float().reshape(b, s, heads, hd).transpose(1, 2)

    scores = (split(q) @ split(k).transpose(-1, -2)) * scale.to(q.device)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    p = p.to(v.dtype).float()
    out = (p @ split(v)).transpose(1, 2).reshape(b, s, d)
    return out.to(q.dtype)


# kernel vs `attention_packed_plain` on the card, (max, rms) relative
# error (`ops.kernel_errors`). In bf16 the f32 sums run in another order,
# which flips some roundings of p and of the output by one bf16 ulp: up
# to 2^-7 of max|plain| for the max. On an H100 at the Grid-ViT's shape
# the kernel reads (1.1e-3, 1.0e-4); leaving p unrounded reads
# (4.6e-3, 2.6e-3), so the rms limit is what catches that fault. In f32
# the kernel's products are 3xTF32 (about 22 of f32's 24 bits) and it
# reads (1.5e-6, 8.2e-7) there; operands rounded to TF32 once read
# (6.5e-4, 4.2e-4), a last key chunk dropped (0.62, 0.35).
TOL = {torch.float32: (2e-5, 2e-6), torch.bfloat16: (8e-3, 5e-4)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            heads: int) -> torch.Tensor:
    """Check what kernel B covers and launch it on (B, S, H*Dh)."""
    b, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share shape and dtype")
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"attention kernel: dtype {q.dtype}")
    if d != heads * HEAD_DIM or s < 1 or b > 65535:
        raise NotImplementedError(
            f"attention kernel covers head_dim {HEAD_DIM}, S >= 1 and at "
            f"most 65535 instances; got d={d}, heads={heads}, S={s}, B={b}")
    # contiguous and 16-byte aligned: both kernels move 16-byte vectors
    q, k, v = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    out = torch.empty_like(q)
    lib = _build.library("attention")
    _build.check(lib.egotap_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, heads,
        HEAD_DIM, _DTYPE_CODE[q.dtype], _build.stream_ptr(q)), "attention")
    return out


class _KernelB(torch.autograd.Function):
    """Kernel B forward; backward: autograd over the plain version,
    recomputed from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        return _launch(q, k, v, heads)

    @staticmethod
    def backward(ctx, grad):
        return (*plain_vjp(lambda q, k, v: attention_packed_plain(
            q, k, v, ctx.heads), ctx.saved_tensors, ctx.needs_input_grad,
            grad, BACKWARD_LABEL), None)


def multihead_attention_packed(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*Dh) q/k/v (projection layout) -> (B, S, H*Dh) context."""
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, heads)
    out = _KernelB.apply(q, k, v, heads)
    multihead_attention_packed.launches += 1
    by_heads = multihead_attention_packed.launches_by_heads
    by_heads[heads] = by_heads.get(heads, 0) + 1
    return out


multihead_attention_packed.launches = 0
# the same launches by head count (a tensor-parallel shard runs fewer heads)
multihead_attention_packed.launches_by_heads = {}


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                        ) -> torch.Tensor:
    """(B, H, S, Dh) q/k/v -> (B, H, S, Dh) context.

    Counterpart of `egotap_tpu/ops/attention.py:multihead_attention`
    (`_attention_pallas` on (B*H, S, Dh)). Flattened to (B*H, S, Dh) it is
    the packed layout with one head, so on the card it launches kernel B
    with ``heads=1``: grid (ceil(S/64), 1, B*H). The kernel masks a
    partial query and key tile, so it takes any S, also where JAX's Pallas
    rule (``S % 8 == 0 and Dh % 128 == 0``) falls back to jnp; a card
    tensor it does not cover (Dh other than 128) raises. A CPU tensor
    takes the plain formula. Gradients as for the packed wrapper."""
    b, h, s, d = q.shape
    flat = [x.reshape(b * h, s, d) for x in (q, k, v)]
    if q.device.type == "cpu":
        out = attention_packed_plain(*flat, heads=1)
    else:
        out = _KernelB.apply(*flat, 1)
        multihead_attention.launches += 1
    return out.reshape(b, h, s, d)


multihead_attention.launches = 0


def kernel_resources(dtype: torch.dtype) -> dict:
    """What the kernel of ``dtype`` (float32 or bfloat16) takes of an SM
    (needs the card). From ``ptxas -v`` in the build log: ``registers``,
    ``spill_store_bytes``, ``spill_load_bytes`` and ``static_smem_bytes``;
    from the CUDA runtime: ``smem_bytes`` a block (dynamic and static),
    ``threads`` a block, ``runtime_registers``, ``local_bytes`` a thread,
    and ``blocks_per_sm`` as ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    reports it."""
    name = {torch.float32: "attention_f32_kernel",
            torch.bfloat16: "attention_bf16_kernel"}[dtype]
    info = (ctypes.c_int * 5)()
    _build.check(_build.library("attention").egotap_attention_occupancy(
        _DTYPE_CODE[dtype], ctypes.addressof(info)), "attention occupancy")
    return {**_build.ptxas_resources("attention", name),
            "blocks_per_sm": info[0], "runtime_registers": info[1],
            "local_bytes": info[2], "smem_bytes": info[3],
            "threads": info[4]}
