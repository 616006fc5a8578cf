"""The port's LSTM tree walk (egotap_tpu_torch.models.skel_variants)
against the JAX package's `LSTMTreeWalk`, and against torch's nn.LSTM
where the tree is a chain, at a small size: input 24, hidden 32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from egotap_tpu.core.skeleton import get_skeleton as jax_get_skeleton
from egotap_tpu.models.skel_variants import LSTMTreeWalk as JaxLSTMTreeWalk
from egotap_tpu.models.skel_variants import \
    skel_output_size as jax_skel_output_size
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.models.skel_variants import (LSTMTreeWalk,
                                                   skel_output_size)

B, IN, H = 3, 24, 32
# f32: the same recurrence in f32, products summed in another order
# (read up to 3.7e-7 of max|ref|). bf16: both sides keep h, c and every
# gate in bf16, but round in other places (the port adds the two bias
# products in its matrix products, XLA fuses a cell's elementwise
# chain), so over 15-17 joints they differ by a few bf16 ulps of the
# O(1) hidden state (read 1.0e-2 to 1.9e-2 of max|ref|).
TOL = {"float32": 2e-6, "bfloat16": 3e-2}
MODES = ("PU", "LSTM", "LSTMSplit", "LSTMNoRel", "None", "NoneNoRel")


def _jax_walk(preset, layers, dtype, extra, seed=0):
    """(JAX params as numpy, inputs, extra inputs or None, JAX output)."""
    parents = jax_get_skeleton(preset).parents
    J = len(parents) - 1
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, J, IN)).astype(np.float32)
    pre = rng.standard_normal((B, J, IN)).astype(np.float32) if extra \
        else None
    model = JaxLSTMTreeWalk(IN, H, layers, parents=parents)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, J, IN)))["params"])
    jdt = getattr(jnp, dtype)
    ref = model.apply({"params": params}, jnp.asarray(x, jdt),
                      None if pre is None else jnp.asarray(pre, jdt))
    return params, x, pre, np.asarray(ref, np.float32)


def _port_walk(params, preset, layers):
    m = LSTMTreeWalk(IN, H, layers, parents=get_skeleton(preset).parents)
    sd = {}
    for i in range(layers):
        p = params[f"layer{i}"]
        sd[f"weight_ih_l{i}"] = p["w_ih"].T
        sd[f"weight_hh_l{i}"] = p["w_hh"].T
        sd[f"bias_ih_l{i}"] = p["b_ih"]
        sd[f"bias_hh_l{i}"] = p["b_hh"]
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in sd.items()}, strict=True)
    return m


@pytest.mark.parametrize("preset,layers", [("UnrealEgo", 2), ("EgoCap", 2),
                                           ("UnrealEgo", 3)])
@pytest.mark.parametrize("extra", [False, True],
                         ids=["input", "extra_inputs"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_walk_matches_jax(dtype, extra, preset, layers):
    """The walk over both presets' trees, with and without LSTMSplit's
    extra inputs, within TOL of max|ref|."""
    params, x, pre, ref = _jax_walk(preset, layers, dtype, extra)
    dt = getattr(torch, dtype)
    with torch.no_grad():
        out = _port_walk(params, preset, layers)(
            torch.from_numpy(x).to(dt),
            None if pre is None else torch.from_numpy(pre).to(dt))
    assert out.dtype == dt and out.shape == ref.shape
    err = np.abs(out.float().numpy() - ref).max()
    assert err <= TOL[dtype] * np.abs(ref).max(), err


def test_chain_tree_is_nn_lstm():
    """Where each joint's parent is the joint before it, the walk is
    torch's nn.LSTM over the sequence: an nn.LSTM state_dict in the
    reference SkelNet's ``lstm.*_l{i}`` layout (the golden fixture's)
    loads strict and gives its output."""
    torch.manual_seed(0)
    J = 6
    ref = nn.LSTM(IN, H, 2, batch_first=True)
    walk = nn.ModuleDict({"lstm": LSTMTreeWalk(
        IN, H, 2, parents=(0,) + tuple(range(J)))})
    sd = {f"lstm.{k}": v for k, v in ref.state_dict().items()}
    assert sorted(sd) == sorted(walk.state_dict())
    walk.load_state_dict(sd, strict=True)
    x = torch.randn(B, J, IN)
    with torch.no_grad():
        np.testing.assert_allclose(walk["lstm"](x).numpy(),
                                   ref(x)[0].numpy(), rtol=0, atol=1e-6)


def test_tree_is_not_a_chain():
    """The tree walk differs from the same weights walked as a chain (the
    UnrealEgo tree branches at the neck and hips)."""
    parents = get_skeleton("UnrealEgo").parents
    J = len(parents) - 1
    torch.manual_seed(1)
    tree = LSTMTreeWalk(IN, H, 2, parents=parents)
    chain = LSTMTreeWalk(IN, H, 2, parents=(0,) + tuple(range(J)))
    chain.load_state_dict(tree.state_dict())
    x = torch.randn(B, J, IN)
    with torch.no_grad():
        a, b = tree(x), chain(x)
    assert torch.equal(a[:, :2], b[:, :2])      # joints 1, 2: the same path
    assert (a - b).abs().max() > 1e-2


def test_reset_parameters_draws_from_the_generator():
    """U(+-1/sqrt(H)) for every weight and bias, as nn.LSTM draws them,
    the same for the same generator seed."""
    parents = get_skeleton("UnrealEgo").parents
    a, b = (LSTMTreeWalk(IN, H, 2, parents=parents) for _ in range(2))
    a.reset_parameters(torch.Generator().manual_seed(5))
    b.reset_parameters(torch.Generator().manual_seed(5))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert p.abs().max() <= H ** -0.5 and p.abs().max() > 0.8 * H ** -0.5


def test_output_sizes_match_jax():
    for mode in MODES:
        assert skel_output_size(mode, 256) == jax_skel_output_size(mode, 256)
    with pytest.raises(ValueError):
        skel_output_size("FC", 256)


@pytest.mark.parametrize("parents", [None, (0, 0, 1)],
                         ids=["no_parents", "wrong_count"])
def test_refuses_missing_or_short_parents(parents):
    if parents is None:
        with pytest.raises(ValueError, match="parents"):
            LSTMTreeWalk(IN, H, 2, parents=parents)
        return
    with pytest.raises(ValueError, match="parents"):
        LSTMTreeWalk(IN, H, 2, parents=parents)(torch.zeros(1, 4, IN))
