"""The 2-layer Propagation-Unit chain in one kernel launch.

Counterpart of `egotap_tpu/ops/pu_kernel.py:pu_chain_fused`, with its
signature. The (x, bridge)-only terms are computed outside and passed in
as ``fh`` (layer-0 h-forget gates, sigmoid applied) and ``gates_pre``
(layer-0 gate preactivations including the h2h bias). Weight matrices
are in the JAX ``(in, out)`` layout and in the compute dtype (f32 or
bf16); matrix operands are rounded to that dtype before each product and
every product accumulates in f32; h/c state and the output are f32.

`pu_chain_fused` runs kernel C (``csrc/pu_chain.cu``) for CUDA tensors
and `pu_chain_plain` for CPU tensors. The kernel keeps each block's
weights in shared memory for the whole walk, read once from their
(out, in) rows (`weight_rows`), and meets the grid at one barrier per
joint; `barrier_walk` runs those barriers alone (its latency floor),
`kernel_resources` reports what a block takes of an SM.

On the card the kernel is the forward of a `torch.autograd.Function`
whose backward recomputes `pu_chain_plain` from the saved inputs and
returns its vector-Jacobian product, so gradients reach ``fh``,
``gates_pre``, the layer-0 h2h kernel and every weight and bias of the
top cell (through the transposed Linear views the lifter passes). JAX
differentiates its `lax.scan` of the same chain (`models/cells.py`).
"""

from __future__ import annotations

import ctypes
import re
from typing import Dict

import torch
import torch.nn.functional as F

from egotap_tpu_torch.ops import _build, plain_vjp


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
BACKWARD_LABEL = "kernel C backward (plain recompute)"   # profiler range
_GATES = (4, 1, 4, 4)       # rows a unit has in Wh2h, Wx2f1, Wx2h1, Wh2h1


def unit_slice(hidden: int, sms: int) -> int:
    """Hidden units a block of kernel C owns: the smallest U dividing
    ``hidden`` with at most one block an SM (a cooperative launch needs
    the whole grid resident, and each block reads every operand whole,
    so more blocks than SMs buy nothing)."""
    return next(u for u in range(1, hidden + 1)
                if hidden % u == 0 and hidden // u <= sms)


def padded(hidden: int) -> int:
    """H padded to a multiple of 16: the kernel's rows of weights and of
    operands (16-byte copies, 16-wide k steps)."""
    return -(-hidden // 16) * 16


def weight_rows(w: torch.Tensor) -> torch.Tensor:
    """An (in, out) kernel as kernel C reads it: its (out, in) rows,
    16-byte aligned, zero-padded to HP where H values are not a whole
    number of 16 bytes. The transposed view of a PyTorch Linear weight,
    as the lifter passes it, is that already: no copy."""
    rows = w.t().contiguous()
    hidden = rows.shape[1]
    if hidden * rows.element_size() % 16:
        return F.pad(rows, (0, padded(hidden) - hidden))
    return rows if rows.data_ptr() % 16 == 0 else rows.clone()


def _card(device):
    """(SMs, shared memory bytes a block may opt in to) of the card."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def _check_fits(hidden: int, wdt: torch.dtype, device) -> int:
    """U for this card; raises when a block's weights cannot stay in
    its shared memory."""
    sms, limit = _card(device)
    units = unit_slice(hidden, sms)
    need = 13 * units * (padded(hidden) * wdt.itemsize + 16)
    if need > limit:
        raise NotImplementedError(
            f"PU chain kernel: H={hidden} gives {units} units a block, whose "
            f"weights ({need} bytes) do not fit its {limit} bytes of shared "
            "memory")
    return units


def _launch(fh, gp, rows, biases, b, J, hidden, units, wdt, barrier_only):
    dev = fh.device
    out = torch.empty(b, J, hidden, dtype=torch.float32, device=dev)
    ops = torch.zeros(3, 2, b, padded(hidden), dtype=wdt, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _build.library("pu_chain")
    _build.check(lib.egotap_pu_chain(
        fh.data_ptr(), gp.data_ptr(), *(w.data_ptr() for w in rows),
        *(x.data_ptr() for x in biases), out.data_ptr(), ops.data_ptr(),
        counter.data_ptr(), b, J, hidden, padded(hidden), rows[0].shape[-1],
        units, _DTYPE_CODE[wdt], int(barrier_only), _build.stream_ptr(fh)),
        "pu_chain")
    return out


_CELL1 = (("x2f", "kernel"), ("x2f", "bias"), ("x2h", "kernel"),
          ("x2h", "bias"), ("h2h", "kernel"), ("h2h", "bias"))


def _plain_flat(fh, gates_pre, w0, *cell1):
    """`pu_chain_plain` with the top cell's tensors in `_CELL1` order."""
    nested: Dict[str, Dict[str, torch.Tensor]] = {}
    for (n, leaf), t in zip(_CELL1, cell1):
        nested.setdefault(n, {})[leaf] = t
    return pu_chain_plain(fh, gates_pre, w0, nested)


class _KernelC(torch.autograd.Function):
    """Kernel C forward; backward: autograd over the plain version,
    recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, units, fh, gates_pre, w0, *cell1):
        ctx.save_for_backward(fh, gates_pre, w0, *cell1)
        b, J, H = fh.shape

        def f32(x):
            return x.float().contiguous()
        kernels = [w0, cell1[0], cell1[2], cell1[4]]
        biases = [f32(x) for x in cell1[1::2]]
        return _launch(f32(fh), f32(gates_pre),
                       [weight_rows(w) for w in kernels], biases, b, J, H,
                       units, w0.dtype, barrier_only=False)

    @staticmethod
    def backward(ctx, grad):
        return (None, *plain_vjp(_plain_flat, ctx.saved_tensors,
                                 ctx.needs_input_grad[1:], grad,
                                 BACKWARD_LABEL))


def pu_chain_fused(fh: torch.Tensor, gates_pre: torch.Tensor,
                   cell0_h2h_kernel: torch.Tensor,
                   cell1: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Run the 2-layer PU chain in one launch.

    fh: (B, J, H) layer-0 h-forget gates; gates_pre: (B, J, 4H) layer-0
    preactivations incl. the h2h bias; cell0_h2h_kernel: (H, 4H); cell1:
    ``{"x2f"|"x2h"|"h2h": {"kernel": (H, n), "bias": (n,)}}`` of the
    bridge-less top cell. Returns (B, J, H) top-layer h per step, f32,
    differentiable in every tensor input."""
    if fh.device.type == "cpu":
        return pu_chain_plain(fh, gates_pre, cell0_h2h_kernel, cell1)
    wdt = cell0_h2h_kernel.dtype
    if wdt not in _DTYPE_CODE:
        raise NotImplementedError(f"PU chain kernel: weight dtype {wdt}")
    b, J, H = fh.shape
    if gates_pre.shape != (b, J, 4 * H):
        raise ValueError(f"gates_pre {tuple(gates_pre.shape)} != {(b, J, 4 * H)}")
    kernels = [cell0_h2h_kernel] + [cell1[n]["kernel"]
                                    for n in ("x2f", "x2h", "h2h")]
    for w, g in zip(kernels, _GATES):
        if w.dtype != wdt or tuple(w.shape) != (H, g * H):
            raise ValueError(f"PU weight {tuple(w.shape)} {w.dtype}: "
                             f"expected {(H, g * H)} {wdt}")
    if b < 1 or J < 1:
        raise NotImplementedError(f"PU chain kernel: B={b}, J={J}")
    units = _check_fits(H, wdt, fh.device)
    out = _KernelC.apply(units, fh, gates_pre, cell0_h2h_kernel,
                         *(cell1[n][leaf] for n, leaf in _CELL1))
    pu_chain_fused.launches += 1
    return out


pu_chain_fused.launches = 0


def barrier_walk(b: int, J: int, hidden: int, dtype: torch.dtype,
                 device) -> None:
    """Launch kernel C's walk with its J + 1 grid barriers and nothing
    else, at the geometry of (B, J, H) in ``dtype``: the kernel's latency
    floor (needs the card; not counted as a launch of the chain)."""
    units = _check_fits(hidden, dtype, device)
    dummy = torch.zeros(1, device=device)
    rows = torch.zeros(1, dtype=dtype, device=device).expand(1, padded(hidden))
    _launch(dummy.expand(b, J, hidden), dummy, [rows] * 4, [dummy] * 3, b, J,
            hidden, units, dtype, barrier_only=True)


def kernel_resources(dtype: torch.dtype, b: int, hidden: int) -> dict:
    """What kernel C in ``dtype`` takes of an SM at (B, H) (needs the
    card): ``registers``, ``spill_store_bytes``, ``spill_load_bytes`` from
    ``ptxas -v`` in the build log; from the runtime ``blocks_per_sm``,
    ``runtime_registers``, ``local_bytes``, ``smem_bytes`` a block,
    ``threads`` a block and ``sms``; the launch's ``blocks``, ``units`` a
    block, k-chunk ``kc`` and k-splits ``ks``."""
    tag = {torch.float32: "pu_chain_kernelIf",
           torch.bfloat16: "pu_chain_kernelI13__nv_bfloat16"}[dtype]
    log = _build.build_log("pu_chain")
    entry = [part for part in log.split("Compiling entry function")
             if tag in part.split("\n", 1)[0]]
    if len(entry) != 1:
        raise RuntimeError(f"the build log holds no single {tag}:\n{log}")

    def read(pattern):
        found = re.search(pattern, entry[0])
        return int(found.group(1)) if found else 0
    units = unit_slice(hidden, _card(torch.device("cuda"))[0])
    info = (ctypes.c_int * 8)()
    _build.check(_build.library("pu_chain").egotap_pu_chain_occupancy(
        _DTYPE_CODE[dtype], b, hidden, padded(hidden), units,
        ctypes.addressof(info)), "pu_chain occupancy")
    return {"registers": read(r"Used (\d+) registers"),
            "spill_store_bytes": read(r"(\d+) bytes spill stores"),
            "spill_load_bytes": read(r"(\d+) bytes spill loads"),
            "blocks_per_sm": info[0], "runtime_registers": info[1],
            "local_bytes": info[2], "smem_bytes": info[3],
            "threads": info[4], "sms": info[5], "kc": info[6],
            "ks": info[7], "units": units, "blocks": hidden // units}
