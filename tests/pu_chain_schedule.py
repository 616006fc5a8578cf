"""Kernel C's reverse walk emulated interval by interval in plain PyTorch
(``pu_chain_reverse`` in ``egotap_tpu_torch/csrc/pu_chain.cu``), and
the faults that the negative controls of its gradient checks inject.
Imported by the CPU tests and the card tests; it imports neither JAX
nor pytest."""

import torch

from egotap_tpu_torch.ops import pu_kernel


def reverse_schedule(w, st, fh, grad, wdt, da0_lag=0, unrounded=False,
                     no_recurrent=False):
    """The reverse walk's schedule over `pu_kernel._plain_walk`'s weights
    ``w`` and states ``st``: J + 2 intervals u, a grid barrier between
    two. Interval u reads the gradients published before the barrier, in
    slot (u + 1) % 2, and runs the transposed products on them:
      Wh2h1^T, Wx2h1^T on dG1 of joint J-u       (1 <= u <= J),
      Wx2f1^T on dzf of joint J-u+1              (u >= 2),
      Wh2h^T on dG0 of joint J-u+2               (u >= 3);
    then dzf of joint J-u, layer 1 of joint J-u-1 and layer 0 of joint
    J-u+1, which publish into slot u % 2; x2h1's part of dx waits one
    interval. Returns dG0, dG1, dzf and dfh as `pu_kernel._plain_reverse`
    does. The faults: ``da0_lag=1``, a layer 0 that reads dG0's product
    one joint late; ``unrounded``, x's gradient left unrounded;
    ``no_recurrent``, layer 1's recurrent gradient term dropped."""
    def r(v):
        return v.to(wdt).float()

    fh, grad = fh.float(), grad.float()
    b, n_joints, h = fh.shape
    zero = fh.new_zeros(b, h)
    slots = {"g1": [fh.new_zeros(b, 4 * h)] * 2, "z": [zero] * 2,
             "g0": [fh.new_zeros(b, 4 * h)] * 2}
    g0_history = []
    carry0 = carry1 = None
    pend = zero
    dg0, dg1, dzf, dfh = ([None] * n_joints for _ in range(4))
    for u in range(n_joints + 2):
        rd, wr, j1 = (u + 1) % 2, u % 2, n_joints - u
        g1, z, g0 = (slots[n][rd] for n in ("g1", "z", "g0"))
        if da0_lag:
            late = len(g0_history) - 1 - da0_lag
            g0 = g0_history[late] if late >= 0 else torch.zeros_like(g0)
        ra1 = r(g1 @ w["h2h"].t())
        dxh, dxf = g1 @ w["x2h"].t(), z @ w["x2f"].t()
        ra0 = r(g0 @ w["w0"].t())
        if u >= 2:                                    # layer 0, joint J-u+1
            j = j1 + 1
            dh0 = pend + dxf if unrounded else r(pend + dxf)
            if u >= 3:
                dh0 = dh0 + ra0 * fh[:, j + 1]
                dfh[j + 1] = ra0 * st[j]["h0"]
            if j == 0:
                dfh[0] = zero
            s = st[j]
            dg0[j], carry0 = pu_kernel._cell_reverse(
                dh0, carry0, *s["s0"], s["c0"], s["c0_prev"])
            slots["g0"][wr] = dg0[j]
            g0_history.append(dg0[j])
        if 1 <= u <= n_joints:                        # x2f1, joint J-u
            s = st[j1]
            dzf[j1] = torch.ops.aten.sigmoid_backward(ra1 * s["h1_prev"],
                                                      s["fh1"])
            slots["z"][wr] = dzf[j1]
            pend = dxh
        if u <= n_joints - 1:                         # layer 1, joint J-u-1
            j = j1 - 1
            dh1 = grad[:, j]
            if u >= 1 and not no_recurrent:
                dh1 = dh1 + ra1 * st[j + 1]["fh1"]
            s = st[j]
            dg1[j], carry1 = pu_kernel._cell_reverse(
                dh1, carry1, *s["s1"], s["c1"], s["c1_prev"])
            slots["g1"][wr] = dg1[j]
    return [torch.stack(t, dim=1) for t in (dg0, dg1, dzf, dfh)]


def schedule_vjp(fh, gates_pre, w0, cell1, grad, **faults):
    """`pu_kernel.pu_chain_plain_vjp`'s result computed by
    `reverse_schedule` (with ``faults``, its keyword arguments)."""
    w, st = pu_kernel._plain_walk(fh, gates_pre, w0, cell1)
    gates = reverse_schedule(w, st, fh, grad, w0.dtype, **faults)
    return pu_kernel._leaf_grads(fh, gates_pre, w0, cell1, st, *gates)
