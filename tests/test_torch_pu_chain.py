"""The port's PU chain (egotap_tpu_torch.ops.pu_kernel and
models.cells.PUChain) against the JAX package's `PUChain` scan, which
`egotap_tpu/ops/pu_kernel.py` states is the same math as its kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.models.cells import PUChain as JaxPUChain
from egotap_tpu_torch.models.cells import PUChain
from egotap_tpu_torch.ops import pu_kernel

B, J, IN, H = 3, 6, 32, 64

# f32: same recurrence in f32, products summed in another order.
# bf16: the JAX scan keeps h/c and every gate in bf16, the port keeps
# state and accumulation in f32 and rounds only the matrix operands; over
# J steps the difference stays a few bf16 ulps of the O(1) hidden state.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _setup(dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, J, IN)).astype(np.float32)
    br = rng.standard_normal((B, J, IN)).astype(np.float32)
    model = JaxPUChain(IN, IN, H, 2, semantics="chain")
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, J, IN)),
        jnp.zeros((1, J, IN)))["params"])
    jdt = getattr(jnp, dtype)
    ref = model.apply({"params": params}, jnp.asarray(x, jdt),
                      jnp.asarray(br, jdt))
    return params, x, br, np.asarray(ref, np.float32)


def _port_module(params):
    m = PUChain(IN, IN, H, 2)
    sd = {}
    for i in (0, 1):
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_scan(dtype):
    """pu_chain_fused fed the hoisted terms computed as cells.py:106-113
    does, with the JAX signature ((in, out) kernels, cell1 dict)."""
    params, x, br, ref = _setup(dtype, seed=1)
    dt = getattr(torch, dtype)
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
    out = pu_kernel.pu_chain_fused(fh, gp, c0["h2h"]["kernel"].to(dt), cell1)
    assert out.dtype == torch.float32 and out.shape == (B, J, H)
    _check(out, ref, dtype)


@pytest.mark.parametrize("kw", [dict(semantics="tree"), dict(num_layers=3)])
def test_uncovered_configurations_raise(kw):
    with pytest.raises(NotImplementedError):
        PUChain(IN, IN, H, **kw)

