"""Multi-head softmax attention on the packed projection layout.

Counterpart of `egotap_tpu/ops/attention.py:multihead_attention_packed`.
q/k/v stay exactly as the projections produce them, ``(B, S, H*Dh)``;
head h is the column block ``[h*Dh, (h+1)*Dh)``, so no transposes.

`multihead_attention_packed` runs kernel B (``csrc/attention.cu``) for a
CUDA tensor and `attention_packed_plain` for a CPU tensor. Both follow
the TPU kernel's numerics: f32 scores times ``1/sqrt(Dh)``, exact
max-subtracted softmax in f32, probabilities normalised and then rounded
to v's dtype, ``p @ v`` accumulated in f32, one rounding of the output.
"""

from __future__ import annotations

import math

import torch

from egotap_tpu_torch.ops import _build

HEAD_DIM = 128            # the kernel's head width
MAX_SEQ = 640             # the 64 x S f32 score tile must fit shared memory
                          # (csrc/attention.cu MAX_SEQ)


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
# the kernel read (1.1e-3, 1.0e-4); leaving p unrounded reads
# (4.6e-3, 2.6e-3), so the rms limit is what catches that fault.
TOL = {torch.float32: (2e-5, 2e-6), torch.bfloat16: (8e-3, 5e-4)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def multihead_attention_packed(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*Dh) q/k/v (projection layout) -> (B, S, H*Dh) context."""
    if q.device.type == "cpu":
        return attention_packed_plain(q, k, v, heads)
    b, s, d = q.shape
    if k.shape != q.shape or v.shape != q.shape or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share shape and dtype")
    if q.dtype not in _DTYPE_CODE:
        raise NotImplementedError(f"attention kernel: dtype {q.dtype}")
    if d != heads * HEAD_DIM or s > MAX_SEQ:
        raise NotImplementedError(
            f"attention kernel covers head_dim {HEAD_DIM} and S <= {MAX_SEQ}; "
            f"got d={d}, heads={heads}, S={s}")
    # contiguous and 16-byte aligned: the bf16 kernel moves 16-byte vectors
    q, k, v = (x if x.is_contiguous() and x.data_ptr() % 16 == 0
               else x.clone(memory_format=torch.contiguous_format)
               for x in (q, k, v))
    out = torch.empty_like(q)
    lib = _build.library("attention")
    _build.check(lib.egotap_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, heads,
        HEAD_DIM, _DTYPE_CODE[q.dtype], _build.stream_ptr(q)),
        "attention_packed")
    multihead_attention_packed.launches += 1
    return out


multihead_attention_packed.launches = 0
