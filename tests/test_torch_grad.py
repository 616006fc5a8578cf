"""Gradients through kernels B and C's autograd functions
(egotap_tpu_torch.ops.attention._KernelB, ops.pu_kernel._KernelC) on the
CPU against `jax.grad` of the JAX package's functions at f32.

On the card each function's forward is its kernel; here the launch is
replaced by the plain version (for C fed the kernel's (out, in) weight
rows, padded as the kernel reads them), so the backward under test is
the one the card runs: autograd over the plain version, recomputed from
the saved inputs. The CPU path of the wrappers (autograd over the plain
version directly) is held to the same JAX gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.cells import PUChain as JaxPUChain
from egotap_tpu.ops.attention import multihead_attention as jax_mha_unpacked
from egotap_tpu.ops.attention import multihead_attention_packed as jax_mha
from egotap_tpu_torch.models import cells
from egotap_tpu_torch.ops import attention as att
from egotap_tpu_torch.ops import pu_kernel
from tests.test_torch_pu_chain import _port_module

RTOL = 1e-5     # f32, the same functions differentiated in another order


def _close(got, ref):
    got = got.detach().double().numpy()
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= RTOL * np.abs(ref).max()


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
                     barrier_only):
    """Kernel C's launch played by the plain version, reading the weights
    as the kernel does: (out, in) rows, the first H columns."""
    w0, wx2f, wx2h, wh2h = (r[:, :H].t() for r in rows)
    cell1 = {n: {"kernel": w, "bias": bias} for n, w, bias in
             zip(("x2f", "x2h", "h2h"), (wx2f, wx2h, wh2h), biases)}
    return pu_kernel.pu_chain_plain(fh, gp, w0, cell1)


@pytest.mark.parametrize("through", ["function", "cpu_path"])
@pytest.mark.parametrize("hidden", [32, 36])
def test_pu_chain_grad_matches_jax(monkeypatch, through, hidden):
    """The PU module's gradients in its inputs, bridges and every
    parameter (both cells), with the chain run by kernel C's autograd
    function: gradients must reach the Linear parameters through the
    transposed (in, out) views. H = 36 takes the kernel's padded rows."""
    launches = []
    if through == "function":
        monkeypatch.setattr(pu_kernel, "_launch", lambda *a, **kw: (
            launches.append(a[7]) or _plain_from_rows(*a, **kw)))

        def fused(fh, gp, w0, cell1):
            return pu_kernel._KernelC.apply(
                1, fh, gp, w0, *(cell1[n][leaf] for n, leaf in
                                 pu_kernel._CELL1))
        monkeypatch.setattr(cells, "pu_chain_fused", fused)
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
    assert len(launches) == (through == "function")
    _close(tx.grad, gx)
    _close(tbr.grad, gbr)
    for i in (0, 1):
        for name, g in gp[f"cell{i}"].items():
            lin = getattr(m.layers[i], name)
            _close(lin.weight.grad, np.asarray(g["kernel"]).T)
            _close(lin.bias.grad, g["bias"])
