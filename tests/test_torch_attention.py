"""The port's packed multi-head attention (egotap_tpu_torch.ops.attention)
against the JAX package's `multihead_attention_packed`, which on the CPU
takes its jnp default through `jax.lax.platform_dependent`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egotap_tpu.ops.attention import (_attention_jnp, multihead_attention,
                                      multihead_attention_packed as jax_mha)
from egotap_tpu_torch.ops import attention as att

# f32: the same softmax(q k^T / sqrt(Dh)) v in f32, summed in another
# order. bf16: the JAX default path rounds the scores and the scaled scores
# to bf16 before its f32 softmax, the port keeps them f32 (as the TPU
# kernel does); both round p and the output to bf16.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(b, s, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(3)]
    return ([jnp.asarray(x, getattr(jnp, dtype)) for x in xs],
            [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs])


def _check(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL[dtype] * np.abs(ref).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,heads", [(2, 576, 8), (2, 36, 8), (3, 64, 2)])
def test_matches_jax_packed(b, s, heads, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, s, heads * 128, dtype)
    _check(att.multihead_attention_packed(tq, tk, tv, heads),
           jax_mha(jq, jk, jv, heads=heads), dtype)


def test_matches_jax_unpacked_layout():
    """The unpacked (B*H, S, Dh) formulation is the same function: heads
    are column blocks of the packed last dim."""
    b, s, h, hd = 2, 48, 4, 128
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, s, h * hd, "float32", seed=3)

    def unpack(x):
        return x.reshape(b, s, h, hd).transpose(0, 2, 1, 3)

    ref = multihead_attention(unpack(jq), unpack(jk), unpack(jv))
    ref = np.asarray(ref).transpose(0, 2, 1, 3).reshape(b, s, h * hd)
    _check(att.multihead_attention_packed(tq, tk, tv, h), ref, "float32")


def test_rows_are_convex_combinations():
    """With v = one-hot columns, the context rows are the softmax rows:
    non-negative and summing to one."""
    b, s, h = 1, 32, 1
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((b, s, 128)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, s, 128)).astype(np.float32))
    v = torch.zeros(b, s, 128)
    v[0, :, :s] = torch.eye(s)
    p = att.attention_packed_plain(q, k, v, h)[0, :, :s]
    assert (p >= 0).all()
    torch.testing.assert_close(p.sum(-1), torch.ones(s), rtol=0, atol=1e-6)
    ref = np.asarray(_attention_jnp(jnp.asarray(q.numpy()),
                                    jnp.asarray(k.numpy()),
                                    jnp.asarray(v.numpy())))[0, :, :s]
    np.testing.assert_allclose(p.numpy(), ref, atol=1e-6)

