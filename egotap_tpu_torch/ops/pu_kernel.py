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

On the card the kernel is the forward of a `torch.autograd.Function`.
When a gradient is wanted, the forward launch also writes each joint's
states (`STATES`), and the backward is one launch of the chain's reverse
walk (``pu_chain_reverse`` in the same source) followed by the weight
and bias gradients as plain large products (`_weight_grads`), so
gradients reach ``fh``, ``gates_pre``, the layer-0 h2h kernel and every
weight and bias of the top cell (through the transposed Linear views
the lifter passes). `pu_chain_plain_vjp` is the reverse walk's plain
counterpart, with the kernel's rounding places. JAX differentiates its
`lax.scan` of the same chain (`models/cells.py`).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch
import torch.nn.functional as F

from egotap_tpu_torch.ops import _build
from egotap_tpu_torch.utils import profiling


def _cell_update(gates: torch.Tensor, c: torch.Tensor):
    f, i, g, o = gates.chunk(4, dim=-1)            # gate order f, i, g, o
    c = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def pu_chain_plain(fh: torch.Tensor, gates_pre: torch.Tensor,
                   cell0_h2h_kernel: torch.Tensor,
                   cell1: Dict[str, Dict[str, torch.Tensor]]) -> torch.Tensor:
    """Plain PyTorch version of kernel C (a loop over the joints)."""
    _, st = _plain_walk(fh, gates_pre, cell0_h2h_kernel, cell1)
    return torch.stack([s["h1"] for s in st], dim=1)


def _plain_walk(fh, gates_pre, cell0_h2h_kernel, cell1):
    """The chain's forward walk, keeping what the reverse walk reads:
    (the weights and biases as f32, by name; per joint a dict of its
    states and its rounded operands a0, x, a1)."""
    wdt = cell0_h2h_kernel.dtype

    def r(v):                        # round an operand to the weight dtype
        return v.to(wdt).float()

    w = {"w0": cell0_h2h_kernel.float()}
    for n in ("x2f", "x2h", "h2h"):
        w[n] = cell1[n]["kernel"].float()
        w["b" + n] = cell1[n]["bias"].float()
    fh, gp = fh.float(), gates_pre.float()
    b, J, H = fh.shape
    h0 = c0 = h1 = c1 = fh.new_zeros(b, H)
    st = []
    for j in range(J):
        a0 = r(fh[:, j] * h0)
        f, i, g, o = (gp[:, j] + a0 @ w["w0"]).chunk(4, dim=-1)
        s0 = (torch.sigmoid(f), torch.sigmoid(i), torch.tanh(g),
              torch.sigmoid(o))
        c0_prev, c0 = c0, c0 * s0[0] + s0[1] * s0[2]
        h0 = s0[3] * torch.tanh(c0)
        x = r(h0)
        fh1 = torch.sigmoid(x @ w["x2f"] + w["bx2f"])
        a1 = r(fh1 * h1)
        f, i, g, o = (x @ w["x2h"] + w["bx2h"] + a1 @ w["h2h"]
                      + w["bh2h"]).chunk(4, dim=-1)
        s1 = (torch.sigmoid(f), torch.sigmoid(i), torch.tanh(g),
              torch.sigmoid(o))
        c1_prev, c1 = c1, c1 * s1[0] + s1[1] * s1[2]
        h1_prev, h1 = h1, s1[3] * torch.tanh(c1)
        st.append(dict(s0=s0, c0=c0, c0_prev=c0_prev, h0=h0, s1=s1, c1=c1,
                       c1_prev=c1_prev, fh1=fh1, h1_prev=h1_prev, h1=h1,
                       a0=a0, x=x, a1=a1))
    return w, st


def _cell_reverse(dh, carry, sf, si, tg, so, c, c_prev):
    """The backward of `_cell_update` from its activations: the gate
    preactivations' gradient (gate order f, i, g, o) and the carry to
    the previous joint's c. ``carry`` is the gradient that the next
    joint sent to this c (None at the last joint)."""
    tc = torch.tanh(c)
    dc = torch.ops.aten.tanh_backward(dh * so, tc)
    if carry is not None:
        dc = dc + carry
    sig = torch.ops.aten.sigmoid_backward
    return torch.cat([sig(dc * c_prev, sf), sig(dc * tg, si),
                      torch.ops.aten.tanh_backward(dc * si, tg),
                      sig(dh * tc, so)], dim=-1), dc * sf


def _plain_reverse(w, st, fh, grad, wdt):
    """The reverse walk over `_plain_walk`'s states, with the output
    gradient ``grad`` (B, J, H) f32: the gate gradients dG0, dG1 (B, J,
    4H), dzf (layer 1's h-forget preactivation) and dfh (B, J, H), f32.
    Where the forward rounds an operand to the weight dtype ``wdt``, the
    gradient reaching that operand is rounded the same way, as autograd
    rounds it through the cast."""
    def r(v):                        # round to the weight dtype
        return v.to(wdt).float()

    fh = fh.float()
    b, J, H = fh.shape
    dg0, dg1, dzf = [None] * J, [None] * J, [None] * J
    dfh = [fh.new_zeros(b, H)] * J
    carry0 = carry1 = ra0 = ra1 = None
    for j in reversed(range(J)):
        s = st[j]
        dh1 = grad[:, j]
        if ra1 is not None:                  # layer 1's recurrent term
            dh1 = dh1 + ra1 * st[j + 1]["fh1"]
        dg1[j], carry1 = _cell_reverse(dh1, carry1, *s["s1"], s["c1"],
                                       s["c1_prev"])
        ra1 = r(dg1[j] @ w["h2h"].t())
        dzf[j] = torch.ops.aten.sigmoid_backward(ra1 * s["h1_prev"],
                                                 s["fh1"])
        dh0 = r(dg1[j] @ w["x2h"].t() + dzf[j] @ w["x2f"].t())
        if ra0 is not None:
            dh0 = dh0 + ra0 * fh[:, j + 1]
            dfh[j + 1] = ra0 * s["h0"]
        dg0[j], carry0 = _cell_reverse(dh0, carry0, *s["s0"], s["c0"],
                                       s["c0_prev"])
        ra0 = r(dg0[j] @ w["w0"].t())
    return [torch.stack(t, dim=1) for t in (dg0, dg1, dzf, dfh)]


def _weight_grads(a0, x, a1, dg0, dg1, dzf, leaves, need):
    """The weight and bias gradients of the chain, f32, in `_CELL1`
    order after the layer-0 h2h kernel (``leaves``, the 7 tensors they
    are the gradients of): plain large products over all (batch, joint)
    rows of the walk's operands (``a0``, ``x``, ``a1``, (B, J, H)) and
    gate gradients (``dg0``, ``dg1`` (B, J, 4H), ``dzf`` (B, J, H));
    None where ``need`` (7 flags) is false. A kernel's gradient is laid
    out as the kernel, as autograd's matmul backward lays it out: the
    transposed view of an (out, in) Linear weight gets (d^T a)^T, so the
    weight's gradient reaches the optimizer contiguous (its foreach
    kernels take their fast path only on gradients laid out as their
    parameters)."""
    def rows(t):
        return t.reshape(-1, t.shape[-1])

    def product(a, d, leaf):
        if leaf.stride(0) == 1 and leaf.stride(1) != 1:
            return (d.t() @ a).t()
        return a.t() @ d
    a0, x, a1, dg0, dg1, dzf = map(rows, (a0, x, a1, dg0, dg1, dzf))
    w0, wx2f, _, wx2h, _, wh2h, _ = leaves
    make = (lambda: product(a0, dg0, w0), lambda: product(x, dzf, wx2f),
            lambda: dzf.sum(0), lambda: product(x, dg1, wx2h),
            lambda: dg1.sum(0), lambda: product(a1, dg1, wh2h),
            lambda: dg1.sum(0))
    return [f() if n else None for f, n in zip(make, need)]


def _leaf_grads(fh, gates_pre, cell0_h2h_kernel, cell1, st, dg0, dg1, dzf,
                dfh):
    """`pu_chain_plain_vjp`'s result from the gate gradients of a reverse
    walk over the states ``st``: the weight and bias gradients by
    `_weight_grads`, each gradient cast to its input's dtype."""
    operands = [torch.stack([s[k] for s in st], dim=1)
                for k in ("a0", "x", "a1")]
    leaves = [cell0_h2h_kernel] + [cell1[n][leaf] for n, leaf in _CELL1]
    grads = _weight_grads(*operands, dg0, dg1, dzf, leaves, [True] * 7)
    grads = [g.to(t.dtype) for g, t in zip(grads, leaves)]
    return (dfh.to(fh.dtype), dg0.to(gates_pre.dtype), grads[0],
            _nested(grads[1:]))


def pu_chain_plain_vjp(fh: torch.Tensor, gates_pre: torch.Tensor,
                       cell0_h2h_kernel: torch.Tensor,
                       cell1: Dict[str, Dict[str, torch.Tensor]],
                       grad: torch.Tensor):
    """Plain PyTorch version of kernel C's backward: the vector-Jacobian
    product of `pu_chain_plain` with the output gradient ``grad``
    (B, J, H), by an explicit reverse walk with the kernel's arithmetic
    and rounding places (`_plain_reverse`). Returns the gradients of
    ``fh``, ``gates_pre``, the layer-0 h2h kernel and ``cell1`` (a dict
    of the same shape), each in its input's dtype."""
    w, st = _plain_walk(fh, gates_pre, cell0_h2h_kernel, cell1)
    gates = _plain_reverse(w, st, fh, grad.float(), cell0_h2h_kernel.dtype)
    return _leaf_grads(fh, gates_pre, cell0_h2h_kernel, cell1, st, *gates)


# kernel vs `pu_chain_plain` on the card, (max, rms) relative error
# (`ops.kernel_errors`). The output is f32; in bf16 the f32 sums run in
# another order and flip some operand roundings by one bf16 ulp, which
# the 15 steps carry on. On an H100 at the lifter's shape the kernel read
# (1.0e-4, 1.6e-5); operands left unrounded read (1.2e-3, 1.1e-3), and
# dropping layer 1's recurrent product reads (1.4e-1, 1.2e-1).
TOL = {torch.float32: (2e-5, 2e-6), torch.bfloat16: (5e-4, 1e-4)}

# kernel C's backward (`_KernelC.backward` on the card) vs autograd over
# `pu_chain_plain` (`ops.plain_vjp`) and vs `pu_chain_plain_vjp`, for
# each gradient, (max, rms) relative error. The kernel's states come
# from its own forward, whose bf16 operand roundings differ from the
# plain version's by one ulp here and there (`TOL`), and its sums run in
# another order; both flip some of the gradients' own bf16 roundings (of
# the operand gradients and of the bf16 weight gradients), one ulp each:
# the max error of a bf16 gradient is then a few 1e-3 whatever the
# kernel does right or wrong, and the rms error tells them apart. On an
# H100 (B, J, H up to (33, 17, 512)) the kernel read f32 (9.9e-7,
# 4.7e-7), bf16 (4.7e-3, 5.7e-4); x's gradient left unrounded read bf16
# (5.1e-3, 2.3e-3), layer 1's recurrent term dropped (1.3e-1, 1.3e-1).
GRAD_TOL = {torch.float32: (1e-5, 5e-6), torch.bfloat16: (1e-2, 1.2e-3)}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# each dtype's template argument in the kernels' mangled names (ptxas -v)
_MANGLED = {torch.float32: "If", torch.bfloat16: "I13__nv_bfloat16"}
BACKWARD_LABEL = "kernel C backward"     # profiler range of the backward
# the states the forward writes for the backward when a gradient is
# wanted, each (B, J, H) f32: layer 0's sigmoid(f), sigmoid(i), tanh(g),
# sigmoid(o), c and h, layer 1's sigmoid(f), sigmoid(i), tanh(g),
# sigmoid(o) and c, and layer 1's h-forget gate fh1 (layer 1's h is the
# output)
STATES = 12
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


def _launch(fh, gp, rows, biases, b, J, hidden, units, wdt, barrier_only,
            states=None):
    """Kernel C's forward; with ``states`` ((STATES, B, J, H) f32) the
    walk also writes each joint's states there."""
    dev = fh.device
    out = torch.empty(b, J, hidden, dtype=torch.float32, device=dev)
    ops = torch.zeros(3, 2, b, padded(hidden), dtype=wdt, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _build.library("pu_chain")
    ptrs = (fh.data_ptr(), gp.data_ptr(), *(w.data_ptr() for w in rows),
            *(x.data_ptr() for x in biases), out.data_ptr(), ops.data_ptr(),
            counter.data_ptr())
    dims = (b, J, hidden, padded(hidden), rows[0].shape[-1], units,
            _DTYPE_CODE[wdt])
    if states is None:
        _build.check(lib.egotap_pu_chain(*ptrs, *dims, int(barrier_only),
                                         _build.stream_ptr(fh)), "pu_chain")
    else:
        _build.check(lib.egotap_pu_chain_save(*ptrs, states.data_ptr(), *dims,
                                              _build.stream_ptr(fh)),
                     "pu_chain")
    return out


def _launch_backward(fh, grad, out, states, rows, b, J, hidden, units, wdt):
    """Kernel C's reverse walk: the gate gradients of both layers per
    joint, dzf (layer 1's h-forget preactivation), dfh and the walk's
    rounded operands a0, x, a1, all f32."""
    dev = fh.device

    def f32(*shape):
        return torch.empty(*shape, dtype=torch.float32, device=dev)
    dgp, dg1 = f32(b, J, 4 * hidden), f32(b, J, 4 * hidden)
    dzf, dfh = f32(b, J, hidden), f32(b, J, hidden)
    operands = f32(3, b, J, hidden)
    slots = torch.zeros(2, b, 9 * padded(hidden), dtype=torch.float32,
                        device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _build.library("pu_chain")
    _build.check(lib.egotap_pu_chain_backward(
        fh.data_ptr(), grad.data_ptr(), out.data_ptr(), states.data_ptr(),
        *(w.data_ptr() for w in rows), dgp.data_ptr(), dg1.data_ptr(),
        dzf.data_ptr(), dfh.data_ptr(), operands.data_ptr(), slots.data_ptr(),
        counter.data_ptr(), b, J, hidden, padded(hidden), rows[0].shape[-1],
        units, _DTYPE_CODE[wdt], _build.stream_ptr(fh)), "pu_chain_backward")
    return dgp, dg1, dzf, dfh, operands


_CELL1 = (("x2f", "kernel"), ("x2f", "bias"), ("x2h", "kernel"),
          ("x2h", "bias"), ("h2h", "kernel"), ("h2h", "bias"))


def _nested(flat):
    """The top cell's tensors, given in `_CELL1` order, as a cell1 dict."""
    nested: Dict[str, Dict[str, torch.Tensor]] = {}
    for (n, leaf), t in zip(_CELL1, flat):
        nested.setdefault(n, {})[leaf] = t
    return nested


def _f32(x):
    return x.float().contiguous()


class _KernelC(torch.autograd.Function):
    """Kernel C forward (writing the joints' states when ``save``);
    backward: the reverse-walk kernel and the weight products."""

    @staticmethod
    def forward(ctx, units, save, fh, gates_pre, w0, *cell1):
        b, J, H = fh.shape
        kernels = [w0, cell1[0], cell1[2], cell1[4]]
        biases = [_f32(x) for x in cell1[1::2]]
        states = (torch.empty(STATES, b, J, H, dtype=torch.float32,
                              device=fh.device) if save else None)
        out = _launch(_f32(fh), _f32(gates_pre),
                      [weight_rows(w) for w in kernels], biases, b, J, H,
                      units, w0.dtype, barrier_only=False, states=states)
        if save:
            ctx.units = units
            ctx.save_for_backward(fh, gates_pre, w0, *cell1, out, states)
        return out

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        if not any(need):
            return (None,) * (2 + len(need))
        fh, gates_pre, w0, *cell1, out, states = ctx.saved_tensors
        with profiling.span(BACKWARD_LABEL, prefix=""):
            grads = _kernel_vjp(ctx.units, fh, gates_pre, w0, cell1, out,
                                states, grad, need)
        return (None, None, *(g if n else None for g, n in zip(grads, need)))


def _kernel_vjp(units, fh, gates_pre, w0, cell1, out, states, grad, need):
    """Kernel C's backward on the card: one launch of the reverse walk,
    then the weight and bias gradients as plain products."""
    b, J, H = fh.shape
    rows = [weight_rows(w) for w in (w0, cell1[0], cell1[2], cell1[4])]
    dgp, dg1, dzf, dfh, (a0, x, a1) = _launch_backward(
        _f32(fh), _f32(grad), out, states, rows, b, J, H, units, w0.dtype)
    pu_chain_fused.backward_launches += 1
    grads = [dfh if need[0] else None, dgp if need[1] else None]
    grads += _weight_grads(a0, x, a1, dgp, dg1, dzf, [w0, *cell1], need[2:])
    return [g.to(t.dtype) if g is not None else None
            for g, t in zip(grads, [fh, gates_pre, w0, *cell1])]


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
    leaves = [fh, gates_pre, cell0_h2h_kernel] + [cell1[n][leaf]
                                                   for n, leaf in _CELL1]
    save = torch.is_grad_enabled() and any(t.requires_grad for t in leaves)
    out = _KernelC.apply(units, save, *leaves)
    pu_chain_fused.launches += 1
    return out


pu_chain_fused.launches = 0
pu_chain_fused.backward_launches = 0


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
    card): ``registers``, spill bytes and static shared memory from
    ``ptxas -v`` in the build log (the instance that does not write
    states); from the runtime ``blocks_per_sm``,
    ``runtime_registers``, ``local_bytes``, ``smem_bytes`` a block,
    ``threads`` a block and ``sms``; the launch's ``blocks``, ``units`` a
    block, k-chunk ``kc`` and k-splits ``ks``."""
    units = unit_slice(hidden, _card(torch.device("cuda"))[0])
    info = (ctypes.c_int * 8)()
    _build.check(_build.library("pu_chain").egotap_pu_chain_occupancy(
        _DTYPE_CODE[dtype], b, hidden, padded(hidden), units,
        ctypes.addressof(info)), "pu_chain occupancy")
    return {**_build.ptxas_resources(
                "pu_chain", f"pu_chain_kernel{_MANGLED[dtype]}Lb0E"),
            "blocks_per_sm": info[0], "runtime_registers": info[1],
            "local_bytes": info[2], "smem_bytes": info[3],
            "threads": info[4], "sms": info[5], "kc": info[6],
            "ks": info[7], "units": units, "blocks": hidden // units}


def reverse_resources(dtype: torch.dtype, b: int, hidden: int) -> dict:
    """What kernel C's reverse walk in ``dtype`` takes of an SM at
    (B, H) (needs the card): the `kernel_resources` keys but the k-chunk
    and k-splits."""
    units = unit_slice(hidden, _card(torch.device("cuda"))[0])
    info = (ctypes.c_int * 6)()
    _build.check(_build.library("pu_chain").egotap_pu_chain_backward_occupancy(
        _DTYPE_CODE[dtype], b, hidden, padded(hidden), units,
        ctypes.addressof(info)), "pu_chain backward occupancy")
    return {**_build.ptxas_resources(
                "pu_chain", f"pu_chain_reverse{_MANGLED[dtype]}"),
            "blocks_per_sm": info[0], "runtime_registers": info[1],
            "local_bytes": info[2], "smem_bytes": info[3],
            "threads": info[4], "sms": info[5], "units": units,
            "blocks": hidden // units}
