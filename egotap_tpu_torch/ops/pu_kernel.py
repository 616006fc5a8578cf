"""The 2-layer Propagation-Unit chain in one kernel launch.

Counterpart of `egotap_tpu/ops/pu_kernel.py:pu_chain_fused`, with its
signature. The (x, bridge)-only terms are computed outside and passed in
as ``fh`` (layer-0 h-forget gates, sigmoid applied) and ``gates_pre``
(layer-0 gate preactivations including the h2h bias). Weight matrices
are in the JAX ``(in, out)`` layout and in the compute dtype (f32 or
bf16); matrix operands are rounded to that dtype before each product and
every product accumulates in f32; h/c state and the output are f32.

`pu_chain_fused` runs kernel C (``csrc/pu_chain.cu``) for CUDA tensors
and `pu_chain_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Dict

import torch

from egotap_tpu_torch.ops import _build


def _cell_update(gates: torch.Tensor, c: torch.Tensor):
    f, i, g, o = gates.chunk(4, dim=-1)            # gate order f, i, g, o
    c = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def pu_chain_plain(fh: torch.Tensor, gates_pre: torch.Tensor,
                   cell0_h2h_kernel: torch.Tensor,
                   cell1: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Plain PyTorch version of kernel C (a loop over the joints)."""
    wdt = cell0_h2h_kernel.dtype

    def r(x):                        # round an operand to the weight dtype
        return x.to(wdt).float()

    w0 = cell0_h2h_kernel.float()
    wx2f, bx2f = cell1["x2f"]["kernel"].float(), cell1["x2f"]["bias"].float()
    wx2h, bx2h = cell1["x2h"]["kernel"].float(), cell1["x2h"]["bias"].float()
    wh2h, bh2h = cell1["h2h"]["kernel"].float(), cell1["h2h"]["bias"].float()
    fh, gates_pre = fh.float(), gates_pre.float()
    b, J, H = fh.shape
    h0 = c0 = h1 = c1 = fh.new_zeros(b, H)
    outs = []
    for j in range(J):
        h0, c0 = _cell_update(gates_pre[:, j] + r(fh[:, j] * h0) @ w0, c0)
        x = r(h0)
        fh1 = torch.sigmoid(x @ wx2f + bx2f)
        gates1 = x @ wx2h + bx2h + r(fh1 * h1) @ wh2h + bh2h
        h1, c1 = _cell_update(gates1, c1)
        outs.append(h1)
    return torch.stack(outs, dim=1)


# kernel vs `pu_chain_plain` on the card, (max, rms) relative error
# (`ops.kernel_errors`). The output is f32; in bf16 the f32 sums run in
# another order and flip some operand roundings by one bf16 ulp, which
# the 15 steps carry on. On an H100 at the lifter's shape the kernel read
# (1.0e-4, 1.6e-5); operands left unrounded read (1.2e-3, 1.1e-3), and
# dropping layer 1's recurrent product reads (1.4e-1, 1.2e-1).
TOL = {torch.float32: (2e-5, 2e-6), torch.bfloat16: (5e-4, 1e-4)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def pu_chain_fused(fh: torch.Tensor, gates_pre: torch.Tensor,
                   cell0_h2h_kernel: torch.Tensor,
                   cell1: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Run the 2-layer PU chain in one launch.

    fh: (B, J, H) layer-0 h-forget gates; gates_pre: (B, J, 4H) layer-0
    preactivations incl. the h2h bias; cell0_h2h_kernel: (H, 4H); cell1:
    ``{"x2f"|"x2h"|"h2h": {"kernel": (H, n), "bias": (n,)}}`` of the
    bridge-less top cell. Returns (B, J, H) top-layer h per step, f32."""
    if fh.device.type == "cpu":
        return pu_chain_plain(fh, gates_pre, cell0_h2h_kernel, cell1)
    wdt = cell0_h2h_kernel.dtype
    if wdt not in _DTYPE_CODE:
        raise NotImplementedError(f"PU chain kernel: weight dtype {wdt}")
    b, J, H = fh.shape
    if gates_pre.shape != (b, J, 4 * H):
        raise ValueError(f"gates_pre {tuple(gates_pre.shape)} != {(b, J, 4 * H)}")

    def weight(w, n_out):
        # (in, out) -> the kernel's (out, in) rows; a transposed view of a
        # PyTorch Linear weight is already contiguous that way
        if w.dtype != wdt or tuple(w.shape) != (H, n_out):
            raise ValueError(f"PU weight {tuple(w.shape)} {w.dtype}: "
                             f"expected {(H, n_out)} {wdt}")
        return w.t().contiguous()

    def f32(x):
        return x.float().contiguous()

    w0 = weight(cell0_h2h_kernel, 4 * H)
    wx2f = weight(cell1["x2f"]["kernel"], H)
    wx2h = weight(cell1["x2h"]["kernel"], 4 * H)
    wh2h = weight(cell1["h2h"]["kernel"], 4 * H)
    bx2f, bx2h, bh2h = (f32(cell1[n]["bias"]) for n in ("x2f", "x2h", "h2h"))
    fh, gates_pre = f32(fh), f32(gates_pre)
    out = torch.empty(b, J, H, dtype=torch.float32, device=fh.device)
    scratch = torch.zeros(6, b, H, dtype=torch.float32, device=fh.device)
    lib = _build.library("pu_chain")
    _build.check(lib.egotap_pu_chain(
        fh.data_ptr(), gates_pre.data_ptr(), w0.data_ptr(), wx2f.data_ptr(),
        bx2f.data_ptr(), wx2h.data_ptr(), bx2h.data_ptr(), wh2h.data_ptr(),
        bh2h.data_ptr(), out.data_ptr(), scratch.data_ptr(), b, J, H,
        _DTYPE_CODE[wdt], _build.stream_ptr(fh)), "pu_chain")
    pu_chain_fused.launches += 1
    return out


pu_chain_fused.launches = 0
