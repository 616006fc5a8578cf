"""Gradients through kernels A, B and C's autograd functions
(egotap_tpu_torch.ops.upsample._KernelA, ops.attention._KernelB,
ops.pu_kernel._KernelC) on the CPU against `jax.grad` / `jax.vjp` of the
JAX package's functions at f32.

On the card each function's forward is its kernel; here the launch is
replaced by the plain version (for C fed the kernel's (out, in) weight
rows, padded as the kernel reads them), so the backward under test is
the one the card runs for A and B: autograd over the plain version,
recomputed from the saved inputs. For C the reverse walk's launch is
played by the plain reverse walk over the states the forward's launch
wrote, and the weight products and the choice of gradients are the
card's. The CPU path of the wrappers (autograd over the plain version
directly) is held to the same JAX gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.cells import PUChain as JaxPUChain
from egotap_tpu.ops.attention import multihead_attention as jax_mha_unpacked
from egotap_tpu.ops.attention import multihead_attention_packed as jax_mha
from egotap_tpu.ops.upsample import upsample2x_align_corners as jax_upsample
from egotap_tpu_torch.models import cells
from egotap_tpu_torch.ops import attention as att
from egotap_tpu_torch.ops import pu_kernel
from egotap_tpu_torch.ops import upsample as up
from tests.test_torch_pu_chain import _port_module

RTOL = 1e-5     # f32, the same functions differentiated in another order


def _close(got, ref):
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


@pytest.fixture
def kernel_a_on_cpu(monkeypatch):
    """Kernel A's autograd function with its launch played by the plain
    version."""
    launches = []
    monkeypatch.setattr(up, "_launch", lambda x: launches.append(x.shape)
                        or up.upsample2x_plain(x))
    return up._KernelA.apply, launches


# the decoder's three grids (8 -> 16 -> 32 -> 64 at a 256 x 256 input, here
# at a 64 x 64 one), and leading dimensions beyond the batch
@pytest.mark.parametrize("through", ["function", "cpu_path"])
@pytest.mark.parametrize("shape", [(2, 2, 2, 16), (2, 4, 4, 8),
                                   (2, 8, 8, 8), (2, 3, 5, 7, 4)])
def test_upsample_grad_matches_jax(kernel_a_on_cpu, shape, through):
    """The transposed interpolation: JAX's `custom_vjp` differentiates its
    einsum formulation, the port autograd over the plain lerps."""
    rng = np.random.default_rng(len(shape) * 10 + shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    ct = rng.standard_normal(shape[:-3] + (2 * shape[-3], 2 * shape[-2],
                                           shape[-1])).astype(np.float32)
    _, vjp = jax.vjp(jax_upsample, x)
    tx = torch.from_numpy(x).requires_grad_(True)
    fn = kernel_a_on_cpu[0] if through == "function" else \
        up.upsample2x_align_corners
    (fn(tx) * torch.from_numpy(ct)).sum().backward()
    assert len(kernel_a_on_cpu[1]) == (through == "function")
    _close(tx.grad, vjp(ct)[0])


@pytest.fixture
def kernel_b_on_cpu(monkeypatch):
    """Kernel B's autograd function with its launch played by the plain
    version."""
    launches = []
    monkeypatch.setattr(att, "_launch", lambda *a: launches.append(a[3])
                        or att.attention_packed_plain(*a))
    return att._KernelB.apply, launches


@pytest.mark.parametrize("through", ["function", "cpu_path"])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_attention_grad_matches_jax(kernel_b_on_cpu, layout, through):
    rng = np.random.default_rng(0)
    if layout == "packed":
        shape, heads = (2, 40, 2 * 128), 2
    else:
        shape, heads = (2, 2, 40, 128), 1
    q, k, v, ct = (rng.standard_normal(shape).astype(np.float32)
                   for _ in range(4))

    def jax_loss(q, k, v):
        out = (jax_mha(q, k, v, heads) if layout == "packed"
               else jax_mha_unpacked(q, k, v))
        return jnp.sum(out * ct)
    ref = jax.grad(jax_loss, argnums=(0, 1, 2))(q, k, v)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    if through == "cpu_path":
        out = (att.multihead_attention_packed(tq, tk, tv, heads)
               if layout == "packed" else att.multihead_attention(tq, tk, tv))
    elif layout == "packed":
        out = kernel_b_on_cpu[0](tq, tk, tv, heads)
    else:
        flat = [x.reshape(4, 40, 128) for x in (tq, tk, tv)]
        out = kernel_b_on_cpu[0](*flat, 1).reshape(shape)
    (out * torch.from_numpy(ct)).sum().backward()
    assert len(kernel_b_on_cpu[1]) == (through == "function")
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        _close(got, want)


def _plain_from_rows(fh, gp, rows, biases, b, J, H, units, wdt,
                     barrier_only, states=None):
    """Kernel C's launch played by the plain version, reading the weights
    as the kernel does: (out, in) rows, the first H columns; a training
    launch also writes the joints' states into ``states`` in the
    kernel's order (`pu_kernel.STATES`)."""
    w0, wx2f, wx2h, wh2h = (r[:, :H].t() for r in rows)
    cell1 = {n: {"kernel": w, "bias": bias} for n, w, bias in
             zip(("x2f", "x2h", "h2h"), (wx2f, wx2h, wh2h), biases)}
    _, st = pu_kernel._plain_walk(fh, gp, w0, cell1)
    if states is not None:
        planes = [lambda s, k=k: s["s0"][k] for k in range(4)] + [
            lambda s: s["c0"], lambda s: s["h0"]] + [
            lambda s, k=k: s["s1"][k] for k in range(4)] + [
            lambda s: s["c1"], lambda s: s["fh1"]]
        for plane, read in zip(states, planes):
            plane.copy_(torch.stack([read(s) for s in st], dim=1))
    return torch.stack([s["h1"] for s in st], dim=1)


def _reverse_from_states(fh, grad, out, states, rows, b, J, H, units, wdt):
    """Kernel C's reverse-walk launch played by the plain reverse walk
    (`pu_kernel._plain_reverse`) over the states that the forward's
    launch wrote and its output, the weights read from their rows: the
    gate gradients, dfh and the rounded operands a0, x, a1."""
    def r(v):
        return v.to(wdt).float()
    w = {n: m[:, :H].t().float() for n, m in
         zip(("w0", "x2f", "x2h", "h2h"), rows)}
    zero = torch.zeros_like(out[:, 0])

    def prev(t, j):
        return t[:, j - 1] if j else zero
    p = states
    st = []
    for j in range(J):
        h1_prev = prev(out, j)
        st.append(dict(
            s0=tuple(p[k][:, j] for k in range(4)), c0=p[4][:, j],
            c0_prev=prev(p[4], j), h0=p[5][:, j],
            s1=tuple(p[k][:, j] for k in range(6, 10)), c1=p[10][:, j],
            c1_prev=prev(p[10], j), fh1=p[11][:, j], h1_prev=h1_prev,
            a0=r(fh[:, j] * prev(p[5], j)), x=r(p[5][:, j]),
            a1=r(p[11][:, j] * h1_prev)))
    dg0, dg1, dzf, dfh = pu_kernel._plain_reverse(w, st, fh, grad, wdt)
    operands = torch.stack([torch.stack([s[k] for s in st], dim=1)
                            for k in ("a0", "x", "a1")])
    return dg0, dg1, dzf, dfh, operands


def _kernel_c_on_cpu(monkeypatch, launches):
    """The PU module's chain run by kernel C's autograd function, its
    forward and reverse-walk launches played on the CPU and recorded in
    ``launches``."""
    monkeypatch.setattr(pu_kernel, "_launch", lambda *a, **kw: (
        launches.append(a[7]) or _plain_from_rows(*a, **kw)))
    monkeypatch.setattr(pu_kernel, "_launch_backward", lambda *a: (
        launches.append("backward") or _reverse_from_states(*a)))

    def fused(fh, gp, w0, cell1):
        return pu_kernel._KernelC.apply(
            1, True, fh, gp, w0, *(cell1[n][leaf] for n, leaf in
                                   pu_kernel._CELL1))
    monkeypatch.setattr(cells, "pu_chain_fused", fused)


@pytest.mark.parametrize("through", ["function", "cpu_path"])
@pytest.mark.parametrize("hidden", [32, 36])
def test_pu_chain_grad_matches_jax(monkeypatch, through, hidden):
    """The PU module's gradients in its inputs, bridges and every
    parameter (both cells), with the chain run by kernel C's autograd
    function: gradients must reach the Linear parameters through the
    transposed (in, out) views. H = 36 takes the kernel's padded rows."""
    launches = []
    if through == "function":
        _kernel_c_on_cpu(monkeypatch, launches)
    b, j, n_in = 3, 5, 16
    rng = np.random.default_rng(1)
    x, br = (rng.standard_normal((b, j, n_in)).astype(np.float32)
             for _ in range(2))
    ct = rng.standard_normal((b, j, hidden)).astype(np.float32)
    model = JaxPUChain(n_in, n_in, hidden, 2, semantics="chain")
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, j, n_in)),
        jnp.zeros((1, j, n_in)))["params"])

    def jax_loss(params, x, br):
        return jnp.sum(model.apply({"params": params}, x, br) * ct)
    gp, gx, gbr = jax.grad(jax_loss, argnums=(0, 1, 2))(params, x, br)

    from tests import test_torch_pu_chain
    monkeypatch.setattr(test_torch_pu_chain, "IN", n_in)
    monkeypatch.setattr(test_torch_pu_chain, "H", hidden)
    m = _port_module(params)
    tx, tbr = (torch.from_numpy(a).requires_grad_(True) for a in (x, br))
    (m(tx, tbr) * torch.from_numpy(ct)).sum().backward()
    assert launches == ([1, "backward"] if through == "function" else [])
    _close(tx.grad, gx)
    _close(tbr.grad, gbr)
    for i in (0, 1):
        for name, g in gp[f"cell{i}"].items():
            lin = getattr(m.layers[i], name)
            _close(lin.weight.grad, np.asarray(g["kernel"]).T)
            _close(lin.bias.grad, g["bias"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pu_chain_weight_grads_laid_out_as_params(monkeypatch, dtype):
    """The parameters' gradients that `torch.autograd.grad` hands the
    optimizer (the training step takes them so) through kernel C's
    backward: each laid out as its parameter, as autograd over the plain
    version lays them out. A Linear weight's gradient that arrived
    transposed would send the optimizer's foreach kernels off their fast
    path."""
    from egotap_tpu_torch.models.cells import PUChain
    launches = []
    _kernel_c_on_cpu(monkeypatch, launches)
    dt = getattr(torch, dtype)
    torch.manual_seed(0)
    m = PUChain(16, 16, 32, 2)
    x, br = (torch.randn(3, 5, 16).to(dt) for _ in range(2))
    params = list(m.parameters())
    grads = torch.autograd.grad(m(x, br).float().sum(), params)
    assert launches == [1, "backward"]
    for p, g in zip(params, grads):
        assert g.shape == p.shape and g.stride() == p.stride(), \
            (tuple(p.shape), g.stride())
