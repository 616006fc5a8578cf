"""The port's hand-written CUDA kernels at edge shapes the serving
forward does not give them, and the shapes they refuse. `chip_smoke.py`
holds them at the main path's shapes and drives the full forward. Every
test here needs a CUDA card and skips without one; the file imports
nothing of JAX, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from egotap_tpu_torch.ops import attention as att
from egotap_tpu_torch.ops import kernel_errors
from egotap_tpu_torch.ops import pu_kernel
from egotap_tpu_torch.ops import upsample as up

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    """A seeded generator on the card; skips without one (decided here,
    at run time, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, tol):
    _, max_rel, rms_rel = kernel_errors(got, ref)
    assert max_rel <= tol[0] and rms_rel <= tol[1], (max_rel, rms_rel, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [36, 100])            # a partial query tile
def test_attention_matches_plain(gen, s, dtype):
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(2, s, 1024, generator=gen, device="cuda").to(dt)
               for _ in range(3))
    before = att.multihead_attention_packed.launches
    got = att.multihead_attention_packed(q, k, v, 8)
    assert att.multihead_attention_packed.launches == before + 1
    _close(got, att.attention_packed_plain(q, k, v, 8), att.TOL[dt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_matches_plain_5d(gen, dtype):
    """Leading dims folded, a one-row input (taps of in_size 1)."""
    dt = getattr(torch, dtype)
    x = torch.randn(2, 3, 1, 5, 64, generator=gen, device="cuda").to(dt)
    before = up.upsample2x_align_corners.launches
    got = up.upsample2x_align_corners(x)
    assert up.upsample2x_align_corners.launches == before + 1
    _close(got, up.upsample2x_plain(x), up.TOL[dt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pu_chain_matches_plain_small(gen, dtype):
    """H=128: one hidden unit per block, where the main path's H=512
    gives each block four."""
    dt = getattr(torch, dtype)
    b, j, h = 8, 5, 128

    def u(*shape):
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1
                ) * h ** -0.5
    fh = torch.sigmoid(torch.randn(b, j, h, generator=gen, device="cuda"))
    gp = 0.5 * torch.randn(b, j, 4 * h, generator=gen, device="cuda")
    w0 = u(h, 4 * h).to(dt)
    cell1 = {n: {"kernel": u(h, m).to(dt), "bias": u(m)}
             for n, m in (("x2f", h), ("x2h", 4 * h), ("h2h", 4 * h))}
    before = pu_kernel.pu_chain_fused.launches
    got = pu_kernel.pu_chain_fused(fh, gp, w0, cell1)
    assert pu_kernel.pu_chain_fused.launches == before + 1
    _close(got, pu_kernel.pu_chain_plain(fh, gp, w0, cell1),
           pu_kernel.TOL[dt])


def test_uncovered_shapes_raise(gen):
    q = torch.randn(1, 16, 4 * 64, generator=gen, device="cuda")
    with pytest.raises(NotImplementedError):
        att.multihead_attention_packed(q, q, q, 4)          # head_dim 64
    with pytest.raises(NotImplementedError):
        up.upsample2x_align_corners(
            torch.randn(1, 4, 4, 6, generator=gen, device="cuda").bfloat16())
