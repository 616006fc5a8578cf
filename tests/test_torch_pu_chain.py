"""The port's PU chain (egotap_tpu_torch.ops.pu_kernel and
models.cells.PUChain) against the JAX package's `PUChain` scan, which
`egotap_tpu/ops/pu_kernel.py` states is the same math as its kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.cells import PUChain as JaxPUChain
from egotap_tpu_torch.models import cells
from egotap_tpu_torch.models.cells import PUChain
from egotap_tpu_torch.ops import kernel_errors, pu_kernel

B, J, IN, H = 3, 6, 32, 64

# f32: same recurrence in f32, products summed in another order.
# bf16: the JAX scan keeps h/c and every gate in bf16, the port keeps
# state and accumulation in f32 and rounds only the matrix operands; over
# J steps the difference stays a few bf16 ulps of the O(1) hidden state.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _setup(dtype, seed=0, j=J, layers=2, **kw):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, j, IN)).astype(np.float32)
    br = rng.standard_normal((B, j, IN)).astype(np.float32)
    model = JaxPUChain(IN, IN, H, layers, **kw)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, j, IN)),
        jnp.zeros((1, j, IN)))["params"])
    jdt = getattr(jnp, dtype)
    ref = model.apply({"params": params}, jnp.asarray(x, jdt),
                      jnp.asarray(br, jdt))
    return params, x, br, np.asarray(ref, np.float32)


def _port_module(params, layers=2, **kw):
    m = PUChain(IN, IN, H, layers, **kw)
    sd = {}
    for i in range(layers):
        for name, p in params[f"cell{i}"].items():
            sd[f"layers.{i}.{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(p["kernel"].T))
            sd[f"layers.{i}.{name}.bias"] = torch.from_numpy(np.array(p["bias"]))
    m.load_state_dict(sd, strict=True)
    return m


def _check(got, ref, dtype):
    got = got.detach().float().numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_matches_jax_scan(dtype):
    params, x, br, ref = _setup(dtype)
    dt = getattr(torch, dtype)
    out = _port_module(params)(torch.from_numpy(x).to(dt),
                               torch.from_numpy(br).to(dt))
    assert out.dtype == dt
    _check(out, ref, dtype)


def _hoisted(params, x, br, dt):
    """The kernel's inputs, the (x, bridge)-only terms computed as
    cells.py:106-113 does, with the JAX signature ((in, out) kernels,
    cell1 dict): (fh, gates_pre, cell0 h2h kernel, cell1)."""
    c0 = {k: {n: torch.from_numpy(np.array(a)) for n, a in v.items()}
          for k, v in params["cell0"].items()}
    xt, brt = torch.from_numpy(x).to(dt), torch.from_numpy(br).to(dt)

    def lin(p, a):
        return a @ p["kernel"].to(dt) + p["bias"].to(dt)

    bh = lin(c0["x2f"], xt)
    fh = torch.sigmoid(bh[..., :H])
    gates_pre = lin(c0["x2h"], xt) + lin(c0["b2h"],
                                         torch.sigmoid(bh[..., H:]) * brt)
    gp = gates_pre.float() + c0["h2h"]["bias"]
    cell1 = {k: {"kernel": torch.from_numpy(np.array(v["kernel"])).to(dt),
                 "bias": torch.from_numpy(np.array(v["bias"]))}
             for k, v in params["cell1"].items()}
    return fh, gp, c0["h2h"]["kernel"].to(dt), cell1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_scan(dtype):
    """pu_chain_fused fed the hoisted terms."""
    params, x, br, ref = _setup(dtype, seed=1)
    dt = getattr(torch, dtype)
    out = pu_kernel.pu_chain_fused(*_hoisted(params, x, br, dt))
    assert out.dtype == torch.float32 and out.shape == (B, J, H)
    _check(out, ref, dtype)


def interval_schedule(fh, gp, w0, cell1, a1_lag=0):
    """Kernel C's schedule in plain PyTorch (``csrc/pu_chain.cu``): J + 2
    intervals u, one grid barrier between two. In interval u every block
    reads three operands that were published before the barrier, in slot
    (u + 1) % 2, and runs three products on them:
      layer 0 of joint u on a0 = round(fh(u) * h0(u-1))     (u < J),
      x2f1 and x2h1 of joint u-1 on x = round(h0(u-1))      (1 <= u <= J),
      layer 1's recurrent product of joint u-2 on
      a1 = round(fh1(u-2) * h1(u-3))                        (2 <= u);
    then the cell updates, which publish the next x, a0 and a1 into slot
    u % 2. The slots start at zero, which is h0(-1) = h1(-1) = 0 (fill);
    the last two intervals only drain layer 1. ``a1_lag=1`` is the fault
    of a layer 1 that reads a1 one joint late."""
    wdt = w0.dtype

    def r(v):                        # round an operand to the weight dtype
        return v.to(wdt).float()

    wx2f, bx2f = cell1["x2f"]["kernel"].float(), cell1["x2f"]["bias"].float()
    wx2h, bx2h = cell1["x2h"]["kernel"].float(), cell1["x2h"]["bias"].float()
    wh2h, bh2h = cell1["h2h"]["kernel"].float(), cell1["h2h"]["bias"].float()
    w0, fh, gp = w0.float(), fh.float(), gp.float()
    b, n_joints, h = fh.shape
    slots = {n: [fh.new_zeros(b, h), fh.new_zeros(b, h)]
             for n in ("a0", "x", "a1")}
    a1_history = []                  # a1 as published, interval by interval
    c0, c1, h1 = (fh.new_zeros(b, h) for _ in range(3))
    out = fh.new_zeros(b, n_joints, h)
    pending = None                   # x @ Wx2h1 + b of the joint in flight
    for u in range(n_joints + 2):
        rd, wr = (u + 1) % 2, u % 2
        a0, x, a1 = (slots[n][rd] for n in ("a0", "x", "a1"))
        if a1_lag:                   # the a1 published a1_lag joints before
            late = len(a1_history) - 1 - a1_lag
            a1 = a1_history[late] if late >= 0 else torch.zeros_like(a1)
        g0 = a0 @ w0
        g1 = x @ torch.cat([wx2f, wx2h], dim=1)
        grec = a1 @ wh2h
        if u < n_joints:                              # layer 0, joint u
            h0, c0 = pu_kernel._cell_update(gp[:, u] + g0, c0)
            slots["x"][wr] = r(h0)
            if u + 1 < n_joints:
                slots["a0"][wr] = r(fh[:, u + 1] * h0)
        if u >= 2:                                    # layer 1, joint u-2
            h1, c1 = pu_kernel._cell_update(pending + grec + bh2h, c1)
            out[:, u - 2] = h1
        if 1 <= u <= n_joints:                        # x2f1/x2h1, joint u-1
            fh1 = torch.sigmoid(g1[:, :h] + bx2f)
            pending = g1[:, h:] + bx2h
            slots["a1"][wr] = r(fh1 * h1)
            a1_history.append(slots["a1"][wr])
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j", [1, 2, 5])
def test_interval_schedule_matches_plain_and_jax(dtype, j):
    """The schedule computes the chain: within the kernel's own limits
    (`pu_kernel.TOL`) of `pu_chain_plain`, and within this file's TOL of
    JAX's scan. A layer 1 that reads a1 one joint late falls outside the
    kernel's limits (from J = 2 on: with one joint a1 is zero either way)."""
    params, x, br, ref = _setup(dtype, seed=2, j=j)
    dt = getattr(torch, dtype)
    args = _hoisted(params, x, br, dt)
    plain = pu_kernel.pu_chain_plain(*args)
    tol = pu_kernel.TOL[dt]

    def within(got):
        _, max_rel, rms_rel = kernel_errors(got, plain)
        return max_rel <= tol[0] and rms_rel <= tol[1]
    got = interval_schedule(*args)
    assert got.shape == (B, j, H) and within(got)
    _check(got, ref, dtype)
    if j >= 2:
        assert not within(interval_schedule(*args, a1_lag=1))


# a branching tree over the J = 6 walked joints (root first)
PARENTS = (0, 0, 1, 1, 2, 3, 3)


@pytest.mark.parametrize("layers,kw", [
    (2, dict(semantics="tree", parents=PARENTS)),
    (3, dict(semantics="tree", parents=PARENTS)),
    (1, {}), (3, {}),
], ids=["tree", "tree_3_layers", "chain_1_layer", "chain_3_layers"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_walk_matches_jax_scan(dtype, layers, kw, monkeypatch):
    """The configurations kernel C does not cover (tree semantics, a
    layer count other than 2) walk the joints in plain PyTorch, on the
    card as on the CPU (the kernel's wrapper is never called), and hold
    to JAX's scan within TOL."""
    params, x, br, ref = _setup(dtype, layers=layers, **kw)
    dt = getattr(torch, dtype)
    module = _port_module(params, layers, **kw)
    assert not module.uses_kernel

    def refuse(*args):
        raise AssertionError("kernel C called")
    monkeypatch.setattr(cells, "pu_chain_fused", refuse)
    out = module(torch.from_numpy(x).to(dt), torch.from_numpy(br).to(dt))
    assert out.dtype == dt
    _check(out, ref, dtype)


def test_tree_without_parents_raises():
    with pytest.raises(ValueError, match="parents"):
        PUChain(IN, IN, H, semantics="tree")


def test_unknown_semantics_raises():
    with pytest.raises(ValueError, match="semantics"):
        PUChain(IN, IN, H, semantics="graph")

