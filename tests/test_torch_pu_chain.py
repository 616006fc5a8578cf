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
from pu_chain_schedule import schedule_vjp

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



# ---- kernel C's backward: its plain counterpart `pu_chain_plain_vjp`

GRAD_SHAPES = [(2, 3, 8), (3, 4, 36), (2, 17, 16)]    # (B, J, H)


def _grad_inputs(b, j, h, dt, seed=3):
    """(fh, gates_pre, w0, cell1) as the lifter hands them to the chain,
    and an output gradient, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def u(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)
                                * h ** -0.5)
    fh = torch.sigmoid(torch.from_numpy(
        rng.standard_normal((b, j, h)).astype(np.float32)))
    gp = torch.from_numpy(
        0.5 * rng.standard_normal((b, j, 4 * h)).astype(np.float32))
    cell1 = {n: {"kernel": u(h, m).to(dt), "bias": u(m)}
             for n, m in (("x2f", h), ("x2h", 4 * h), ("h2h", 4 * h))}
    ct = torch.from_numpy(rng.standard_normal((b, j, h)).astype(np.float32))
    return (fh, gp, u(h, 4 * h).to(dt), cell1), ct


def _flat(fh, gp, w0, cell1):
    return [fh, gp, w0] + [cell1[n][leaf] for n, leaf in pu_kernel._CELL1]


def _autograd_vjp(args, ct):
    """Autograd over `pu_chain_plain`: what the card's backward was."""
    leaves = [t.detach().requires_grad_(True) for t in _flat(*args)]
    out = pu_kernel.pu_chain_plain(*leaves[:3], pu_kernel._nested(leaves[3:]))
    return torch.autograd.grad(out, leaves, ct)


def _errors(got, want):
    """Per leaf (max, rms) relative error (`ops.kernel_errors`)."""
    return [kernel_errors(g, w)[1:] for g, w in zip(got, want)]


@pytest.mark.parametrize("b,j,h", GRAD_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_vjp_matches_autograd(dtype, b, j, h):
    """The explicit reverse walk equals autograd over the plain forward
    up to the order of its f32 sums (the weight gradients are one product
    over all joints, autograd adds them joint by joint): within 1e-6 in
    f32, and within `pu_kernel.GRAD_TOL` in bf16, where such a sum moves
    a gradient's final bf16 rounding. Each gradient is in its input's
    dtype."""
    dt = getattr(torch, dtype)
    args, ct = _grad_inputs(b, j, h, dt)
    want = _autograd_vjp(args, ct)
    got = _flat(*pu_kernel.pu_chain_plain_vjp(*args, ct))
    assert [g.dtype for g in got] == [t.dtype for t in _flat(*args)]
    tol = (1e-6, 1e-6) if dt == torch.float32 else pu_kernel.GRAD_TOL[dt]
    for (max_rel, rms_rel), g in zip(_errors(got, want), got):
        assert torch.isfinite(g).all()
        assert max_rel <= tol[0] and rms_rel <= tol[1], (max_rel, rms_rel)


@pytest.mark.parametrize("fault,dtype", [("unrounded", "bfloat16"),
                                         ("no_recurrent", "bfloat16"),
                                         ("no_recurrent", "float32")])
def test_plain_vjp_faults_fall_outside_grad_tol(fault, dtype):
    """The negative controls of the card's checks: the reverse walk with
    x's gradient left unrounded (bf16 only: f32 rounds nothing), or with
    layer 1's recurrent gradient term dropped (`schedule_vjp`'s faults),
    reads outside `pu_kernel.GRAD_TOL` against autograd in some
    gradient."""
    dt = getattr(torch, dtype)
    args, ct = _grad_inputs(32, 15, 64, dt, seed=4)
    want = _autograd_vjp(args, ct)
    got = _flat(*schedule_vjp(*args, ct, **{fault: True}))
    tol = pu_kernel.GRAD_TOL[dt]
    assert any(m > tol[0] or r > tol[1] for m, r in _errors(got, want))


class _PlainChain(torch.autograd.Function):
    """`pu_chain_plain` whose backward is `pu_chain_plain_vjp`."""

    @staticmethod
    def forward(ctx, fh, gp, w0, *cell1):
        ctx.save_for_backward(fh, gp, w0, *cell1)
        return pu_kernel.pu_chain_plain(fh, gp, w0, pu_kernel._nested(cell1))

    @staticmethod
    def backward(ctx, grad):
        fh, gp, w0, *cell1 = ctx.saved_tensors
        return tuple(_flat(*pu_kernel.pu_chain_plain_vjp(
            fh, gp, w0, pu_kernel._nested(cell1), grad)))


@pytest.mark.parametrize("b,j,h", GRAD_SHAPES)
def test_plain_vjp_matches_jax_grad(monkeypatch, b, j, h):
    """At f32, the port's PU module with `pu_chain_plain_vjp` as its
    chain's backward against `jax.grad` of the JAX package's scan: the
    gradients in the inputs, the bridges and every parameter of both
    cells (the chain's gradients reach the layer-0 x2f, x2h, b2h through
    fh and gates_pre)."""
    rng = np.random.default_rng(5)
    x, br = (rng.standard_normal((b, j, IN)).astype(np.float32)
             for _ in range(2))
    ct = rng.standard_normal((b, j, h)).astype(np.float32)
    model = JaxPUChain(IN, IN, h, 2)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(5), jnp.zeros((1, j, IN)),
        jnp.zeros((1, j, IN)))["params"])

    def loss(params, x, br):
        return jnp.sum(model.apply({"params": params}, x, br) * ct)
    gp, gx, gbr = jax.grad(loss, argnums=(0, 1, 2))(params, x, br)

    monkeypatch.setattr(cells, "pu_chain_fused", lambda fh, g, w0, c1:
                        _PlainChain.apply(fh, g, w0, *(c1[n][leaf] for n, leaf
                                                       in pu_kernel._CELL1)))
    monkeypatch.setitem(globals(), "H", h)
    m = _port_module(params)
    tx, tbr = (torch.from_numpy(a).requires_grad_(True) for a in (x, br))
    (m(tx, tbr) * torch.from_numpy(ct)).sum().backward()
    pairs = [(tx.grad, gx), (tbr.grad, gbr)]
    for i in (0, 1):
        for name, g in gp[f"cell{i}"].items():
            lin = getattr(m.layers[i], name)
            pairs += [(lin.weight.grad, np.asarray(g["kernel"]).T),
                      (lin.bias.grad, g["bias"])]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= TOL["float32"] * \
            np.abs(want).max()


@pytest.mark.parametrize("j", [1, 2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reverse_schedule_matches_plain_vjp(dtype, j):
    """The reverse walk's schedule (`reverse_schedule`, the kernel's
    intervals) computes the plain backward: its gradients equal
    `pu_chain_plain_vjp`'s bit for bit. A layer 0 that reads dG0's
    product one joint late falls outside `pu_kernel.GRAD_TOL` (from
    J = 2 on: with one joint there is no later joint to read)."""
    dt = getattr(torch, dtype)
    args, ct = _grad_inputs(3, j, 36, dt, seed=6)
    want = _flat(*pu_kernel.pu_chain_plain_vjp(*args, ct))
    for g, w in zip(_flat(*schedule_vjp(*args, ct)), want):
        assert torch.equal(g, w)
    if j >= 2:
        late = _flat(*schedule_vjp(*args, ct, da0_lag=1))
        tol = pu_kernel.GRAD_TOL[dt]
        assert any(m > tol[0] or r > tol[1] for m, r in
                   _errors(late[:2], want[:2]))
