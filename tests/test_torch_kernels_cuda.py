"""The port's hand-written CUDA kernels at edge shapes the serving
forward does not give them, and the shapes they refuse. `chip_smoke.py`
holds them at the main path's shapes and drives the full forward. Every
test here needs a CUDA card and skips without one; the file imports
nothing of JAX, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from egotap_tpu_torch.models.resnet import BasicBlock
from egotap_tpu_torch.ops import attention as att
from egotap_tpu_torch.ops import fused_layer1 as fl
from egotap_tpu_torch.ops import kernel_errors
from egotap_tpu_torch.ops import pu_kernel
from egotap_tpu_torch.ops import upsample as up
from egotap_tpu_torch.serving import init_weights

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


# sequence lengths around the kernels' tiles: 64 query rows a block (16 a
# warp), 64 keys a chunk; 576 is the Grid-ViT's
SEQ_LENS = [1, 36, 63, 64, 65, 100, 127, 129, 576, 640]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQ_LENS)
@pytest.mark.parametrize("heads", [1, 8])
def test_attention_matches_plain(gen, heads, s, dtype):
    dt = getattr(torch, dtype)
    b = 2 if s == 100 else 1
    q, k, v = (torch.randn(b, s, heads * 128, generator=gen,
                           device="cuda").to(dt) for _ in range(3))
    before = att.multihead_attention_packed.launches
    got = att.multihead_attention_packed(q, k, v, heads)
    assert att.multihead_attention_packed.launches == before + 1
    _close(got, att.attention_packed_plain(q, k, v, heads), att.TOL[dt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,heads", [(1, 641, 8), (2, 1000, 1),
                                       (1, 2048, 2)])
def test_attention_bf16_long_seq(gen, b, s, heads, dtype):
    """Neither kernel keeps a score tile, so S has no limit, on the packed
    and on the unpacked layout."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(b, s, heads * 128, generator=gen,
                           device="cuda").to(dt) for _ in range(3))
    before = att.multihead_attention_packed.launches
    got = att.multihead_attention_packed(q, k, v, heads)
    assert att.multihead_attention_packed.launches == before + 1
    ref = att.attention_packed_plain(q, k, v, heads)
    _close(got, ref, att.TOL[dt])
    split = [x.view(b, s, heads, 128).transpose(1, 2) for x in (q, k, v)]
    got = att.multihead_attention(*split)
    _close(got.transpose(1, 2).reshape(q.shape), ref, att.TOL[dt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bf16_masks_ragged_tiles(gen, dtype):
    """Rows and keys past S are never read as data: q, k and v are the
    first S rows of buffers whose tails hold NaNs (for one instance such a
    view is contiguous, so the wrapper passes it on as it is)."""
    dt = getattr(torch, dtype)
    s, heads = 100, 8
    big = torch.full((3, 1, 128, heads * 128), float("nan"), device="cuda",
                     dtype=dt)
    big[:, :, :s] = torch.randn(3, 1, s, heads * 128, generator=gen,
                                device="cuda").to(dt)
    q, k, v = (x[:, :s] for x in big)
    assert q.is_contiguous() and v.data_ptr() == big[2].data_ptr()
    got = att.multihead_attention_packed(q, k, v, heads)
    assert torch.isfinite(got).all()
    _close(got, att.attention_packed_plain(q, k, v, heads), att.TOL[dt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("s", [100, 576])
def test_attention_late_row_max(gen, s, layout, dtype):
    """Every row's max sits on the last key, in the last chunk: the f32
    kernel's running max moves there, and its context and sum must be
    rescaled (q has a common offset and the last key points along it, so
    its score is about 8.5 where the others spread about 1.1)."""
    dt, heads = getattr(torch, dtype), 8
    q, k, v = (torch.randn(2, s, heads * 128, generator=gen, device="cuda")
               for _ in range(3))
    q = 0.5 * q + 1
    k[:, -1] = 0.75
    q, k, v = (x.to(dt) for x in (q, k, v))
    ref = att.attention_packed_plain(q, k, v, heads)
    scores = (q[:, :, :128].float() @ k[:, :, :128].float().transpose(1, 2))
    assert (scores.argmax(-1) == s - 1).all()
    if layout == "packed":
        got = att.multihead_attention_packed(q, k, v, heads)
    else:
        split = [x.view(2, s, heads, 128).transpose(1, 2) for x in (q, k, v)]
        got = att.multihead_attention(*split).transpose(1, 2).reshape(q.shape)
    _close(got, ref, att.TOL[dt])


def test_attention_bf16_kernel_resources(gen):
    """The build log and the runtime agree on the kernel's registers, and
    at least three of its blocks fit one SM (the design's occupancy)."""
    res = att.kernel_resources(torch.bfloat16)
    assert res["registers"] == res["runtime_registers"] > 0
    assert res["blocks_per_sm"] >= 3, res
    assert res["smem_bytes"] <= 227 * 1024 // 3


def test_attention_f32_kernel_resources(gen):
    """The same for the f32 kernel: at least two of its blocks fit one SM,
    with no register spilled."""
    res = att.kernel_resources(torch.float32)
    assert res["registers"] == res["runtime_registers"] > 0
    assert res["blocks_per_sm"] >= 2, res
    assert res["spill_store_bytes"] == res["local_bytes"] == 0, res
    assert res["smem_bytes"] <= 227 * 1024 // 2


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
@pytest.mark.parametrize("shape", [
    (3, 1, 4, 8), (2, 5, 1, 16), (2, 7, 9, 8), (1, 1, 1, 8),   # h, w = 1, odd
    (2, 33, 17, 24), (1, 160, 96, 64),      # ragged band, narrowed slices
    (70000, 2, 2, 8)])                      # images past the grid's 65535
def test_upsample_edge_shapes(gen, shape, dtype):
    dt = getattr(torch, dtype)
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    before = up.upsample2x_align_corners.launches
    got = up.upsample2x_align_corners(x)
    assert up.upsample2x_align_corners.launches == before + 1
    _close(got, up.upsample2x_plain(x), up.TOL[dt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsample_kernel_resources(gen, dtype):
    """At the decoder's largest staging (32 x 32 x 512): the build log and
    the runtime agree on the registers, nothing spills, and at least four
    blocks fit one SM."""
    dt = getattr(torch, dtype)
    geo = up.launch_geometry(32, 32, 32, 512, dt)
    res = up.kernel_resources(dt, geo["smem"])
    assert res["registers"] == res["runtime_registers"] > 0
    assert res["spill_store_bytes"] == res["local_bytes"] == 0, res
    assert res["blocks_per_sm"] >= 4, res


def _pu_inputs(gen, b, j, h, dt):
    def u(*shape):
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1
                ) * h ** -0.5
    fh = torch.sigmoid(torch.randn(b, j, h, generator=gen, device="cuda"))
    gp = 0.5 * torch.randn(b, j, 4 * h, generator=gen, device="cuda")
    cell1 = {n: {"kernel": u(h, m).to(dt), "bias": u(m)}
             for n, m in (("x2f", h), ("x2h", 4 * h), ("h2h", 4 * h))}
    return fh, gp, u(h, 4 * h).to(dt), cell1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,j,h", [(1, 1, 128), (5, 2, 128), (8, 5, 128),
                                   (32, 15, 512), (33, 17, 512), (3, 4, 36)])
def test_pu_chain_matches_plain_small(gen, b, j, h, dtype):
    """H=128: one hidden unit per block; 512: the lifter's four. B=1, 3, 5
    and 33 leave ragged row tiles; J=1 is fill and drain alone; J=15 and
    17 walk long enough for a stale operand (an L1 hit on another block's
    slot, a wrong buffer) to show. H=36 is padded to 48: bf16 weight rows
    (72 bytes) reach the kernel padded, f32 ones are padded in shared
    memory."""
    dt = getattr(torch, dtype)
    args = _pu_inputs(gen, b, j, h, dt)
    before = pu_kernel.pu_chain_fused.launches
    got = pu_kernel.pu_chain_fused(*args)
    assert pu_kernel.pu_chain_fused.launches == before + 1
    assert got.shape == (b, j, h) and torch.isfinite(got).all()
    _close(got, pu_kernel.pu_chain_plain(*args), pu_kernel.TOL[dt])


def test_pu_chain_refusals(gen):
    """float16 weights, and an H whose smallest whole unit slice within
    the SM count (H = 137, prime: one block of 137 units) leaves a block
    more weights than its shared memory holds; nothing launches."""
    before = pu_kernel.pu_chain_fused.launches
    args = _pu_inputs(gen, 2, 3, 128, torch.float16)
    with pytest.raises(NotImplementedError):
        pu_kernel.pu_chain_fused(*args)
    with pytest.raises(NotImplementedError):
        pu_kernel.pu_chain_fused(*_pu_inputs(gen, 2, 3, 137, torch.float32))
    assert pu_kernel.pu_chain_fused.launches == before


def _vjp(fn, leaves, ct):
    """fn's output and its gradients in ``leaves`` for the cotangent ct."""
    leaves = [x.detach().requires_grad_(True) for x in leaves]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, ct)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,j,h", [(32, 15, 512), (3, 4, 36)])
def test_pu_chain_grad_matches_plain(gen, b, j, h, dtype):
    """Kernel C's autograd function at the lifter's shape and at H = 36
    (padded rows): the forward launches the kernel once, and the
    gradients in fh, gates_pre and every weight and bias, the weights
    passed as transposed views of (out, in) tensors as the lifter passes
    its Linear weights, equal those of autograd over the plain version
    bit for bit (the backward is that recompute)."""
    dt = getattr(torch, dtype)
    fh, gp, w0, cell1 = _pu_inputs(gen, b, j, h, dt)
    leaves = [fh, gp, w0.t().contiguous()] + [
        x for n in ("x2f", "x2h", "h2h")
        for x in (cell1[n]["kernel"].t().contiguous(), cell1[n]["bias"])]
    ct = torch.randn(b, j, h, generator=gen, device="cuda")

    def call(fn):
        def run(fh, gp, w0_rows, *c1):
            cells = {n: {"kernel": c1[2 * i].t(), "bias": c1[2 * i + 1]}
                     for i, n in enumerate(("x2f", "x2h", "h2h"))}
            return fn(fh, gp, w0_rows.t(), cells)
        return run
    before = pu_kernel.pu_chain_fused.launches
    got, grads = _vjp(call(pu_kernel.pu_chain_fused), leaves, ct)
    assert pu_kernel.pu_chain_fused.launches == before + 1
    ref, want = _vjp(call(pu_kernel.pu_chain_plain), leaves, ct)
    _close(got, ref, pu_kernel.TOL[dt])
    for g, w in zip(grads, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
        assert torch.isfinite(g).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["packed", "unpacked"])
def test_attention_grad_matches_plain(gen, layout, dtype):
    """Kernel B's autograd function at the Grid-ViT's shape: one launch
    in the forward, and gradients in q, k and v equal to those of
    autograd over the plain version bit for bit, recomputed from the
    q, k, v the kernel saw (in their dtype)."""
    dt = getattr(torch, dtype)
    shape = (32, 576, 1024) if layout == "packed" else (32, 8, 576, 128)
    leaves = [torch.randn(shape, generator=gen, device="cuda").to(dt)
              for _ in range(3)]
    ct = torch.randn(shape, generator=gen, device="cuda").to(dt)
    if layout == "packed":
        wrapper = att.multihead_attention_packed
        kernel = lambda q, k, v: wrapper(q, k, v, 8)      # noqa: E731
        plain = lambda q, k, v: att.attention_packed_plain(q, k, v, 8)  # noqa: E731
    else:
        wrapper = kernel = att.multihead_attention

        def plain(q, k, v):
            flat = [x.reshape(256, 576, 128) for x in (q, k, v)]
            return att.attention_packed_plain(*flat, heads=1).reshape(shape)
    before = wrapper.launches
    got, grads = _vjp(kernel, leaves, ct)
    assert wrapper.launches == before + 1
    ref, want = _vjp(plain, leaves, ct)
    _close(got, ref, att.TOL[dt])
    for g, w in zip(grads, want):
        assert g.dtype == dt and torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pu_chain_kernel_resources(gen, dtype):
    """At the lifter's (B, H) = (32, 512): the build log and the runtime
    agree on the registers, nothing spills, and the H/U blocks of 4 units
    are co-resident (one an SM); the barrier-only walk runs."""
    dt = getattr(torch, dtype)
    res = pu_kernel.kernel_resources(dt, 32, 512)
    assert res["registers"] == res["runtime_registers"] > 0
    assert res["spill_store_bytes"] == res["local_bytes"] == 0, res
    assert res["units"] == 4 and res["blocks"] == 128, res
    assert res["blocks_per_sm"] >= 1 and res["blocks"] <= res["sms"], res
    pu_kernel.barrier_walk(32, 15, 512, dt, "cuda")
    torch.cuda.synchronize()


def test_uncovered_shapes_raise(gen):
    q = torch.randn(1, 16, 4 * 64, generator=gen, device="cuda")
    with pytest.raises(NotImplementedError):
        att.multihead_attention_packed(q, q, q, 4)          # head_dim 64
    half = torch.randn(1, 16, 128, generator=gen, device="cuda").half()
    with pytest.raises(NotImplementedError):
        att.multihead_attention_packed(half, half, half, 1)  # float16
    with pytest.raises(NotImplementedError):
        up.upsample2x_align_corners(
            torch.randn(1, 4, 4, 6, generator=gen, device="cuda").bfloat16())


def test_unpacked_attention_one_instance(gen):
    """B*H = 1 and S = 8: one block with a partial query tile."""
    q, k, v = (torch.randn(1, 1, 8, 128, generator=gen, device="cuda")
               for _ in range(3))
    before = att.multihead_attention.launches
    got = att.multihead_attention(q, k, v)
    assert att.multihead_attention.launches == before + 1
    ref = att.attention_packed_plain(q[0], k[0], v[0], 1)[None]
    _close(got, ref, att.TOL[torch.float32])
    with pytest.raises(NotImplementedError):              # Dh 256
        att.multihead_attention(*(torch.randn(1, 1, 8, 256, device="cuda")
                                  for _ in range(3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", SEQ_LENS)
@pytest.mark.parametrize("heads", [1, 8])
def test_unpacked_attention_ragged_seq(gen, heads, s, dtype):
    """Any S, also not a multiple of 8 (where JAX's Pallas rule falls back
    to jnp): the card still launches the kernel, and refuses Dh 64 rather
    than take the plain formula."""
    dt = getattr(torch, dtype)
    b = 2 if s == 36 else 1
    q, k, v = (torch.randn(b, heads, s, 128, generator=gen,
                           device="cuda").to(dt) for _ in range(3))
    before = att.multihead_attention.launches
    got = att.multihead_attention(q, k, v)
    assert att.multihead_attention.launches == before + 1
    ref = att.attention_packed_plain(*(x.reshape(b * heads, s, 128)
                                       for x in (q, k, v)), 1)
    _close(got, ref.reshape(got.shape), att.TOL[dt])
    with pytest.raises(NotImplementedError):              # Dh 64
        att.multihead_attention(*(x[..., :64] for x in (q, k, v)))
    assert att.multihead_attention.launches == before + 1


def _packed(n_blocks, seed=0):
    blocks = torch.nn.Sequential(*(BasicBlock(64, 64, quant=True)
                                   for _ in range(n_blocks)))
    init_weights(blocks, torch.Generator().manual_seed(seed))
    return fl.pack_blocks(blocks.cuda(), 1e-5)


def _fused(x, packed):
    before = fl.fused_layer1_int8.launches
    got = fl.fused_layer1_int8(x, *packed)
    assert fl.fused_layer1_int8.launches == before + 1
    torch.cuda.synchronize()
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_blocks,shape", [
    (1, (3, 16, 16, 64)),              # one residual block: 2 convs
    (2, (2, 8, 8, 64)),                # a cluster of 2 blocks
    (3, (2, 20, 12, 64)),              # short last run, 6 convs
    (2, (64, 64, 64, 64)),             # serving: 16 blocks of 4 rows
    (2, (3, 50, 30, 64)),              # runs start mid-row, short last run
    (1, (2, 1, 1, 64)),                # one pixel
])
def test_fused_layer1_matches_plain(gen, n_blocks, shape, dtype):
    """Pixels scaled by a ramp over the image, so that one scale a block
    instead of one an image would show."""
    n, h, w, c = shape
    ramp = 1 + torch.arange(h * w, device="cuda").reshape(1, h, w, 1) / 256
    x = (torch.randn(shape, generator=gen, device="cuda") * ramp).to(
        getattr(torch, dtype))
    packed = _packed(n_blocks)
    _close(_fused(x, packed), fl.fused_layer1_plain(x, *packed),
           fl.TOL[x.dtype])


def test_fused_layer1_zero_and_outlier_images(gen):
    """An all-zero image takes a_scale = 1e-12/127 and gives relu(bias)
    chains; an outlier image changes nothing in its neighbours."""
    packed = _packed(2, seed=1)
    x = torch.randn(3, 16, 16, 64, generator=gen, device="cuda")
    x[1] = 0
    got = _fused(x, packed)
    _close(got, fl.fused_layer1_plain(x, *packed), fl.TOL[torch.float32])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[1], _fused(x[1:2].clone(), packed)[0],
                               rtol=0, atol=0)
    y = x.clone()
    y[2] *= 1e4                                  # the outlier
    out = _fused(y, packed)
    torch.testing.assert_close(out[:2], got[:2], rtol=0, atol=0)


def test_fused_layer1_refusals(gen):
    packed = _packed(1)
    with pytest.raises(NotImplementedError):              # C != 64
        fl.fused_layer1_int8(torch.randn(1, 8, 8, 32, device="cuda"),
                             *packed)
    x = torch.randn(1, 8, 16, 64, device="cuda")[:, :, ::2]
    with pytest.raises(ValueError):                       # not contiguous
        fl.fused_layer1_int8(x, *packed)


def test_fused_layer1_refuses_grad(gen):
    """With grad mode on, an input that requires grad is refused (the
    kernel has no backward); under no_grad the same call launches."""
    packed = _packed(1)
    x = torch.randn(2, 8, 8, 64, generator=gen, device="cuda")
    x.requires_grad_(True)
    before = fl.fused_layer1_int8.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fl.fused_layer1_int8(x, *packed)
    assert fl.fused_layer1_int8.launches == before
    with torch.no_grad():
        got = _fused(x, packed)
    assert got.grad_fn is None and torch.isfinite(got).all()


def test_fused_layer1_refuses_images_off_chip(gen):
    """An image of more than 16 x 256 pixels does not fit one cluster:
    the card raises and launches nothing (no plain fallback)."""
    packed = _packed(1)
    before = fl.fused_layer1_int8.launches
    with pytest.raises(NotImplementedError, match="4096"):
        fl.fused_layer1_int8(torch.randn(1, 65, 64, 64, device="cuda"),
                             *packed)
    assert fl.fused_layer1_int8.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_layer1_kernel_resources(gen, dtype):
    """At the serving image (64 x 64, clusters of 16): the build log and
    the runtime agree on the registers, nothing spills, a block fits an
    SM and the card holds at least one cluster at once."""
    res = fl.kernel_resources(getattr(torch, dtype), 64, 64)
    assert res["cluster"] == 16 and res["pixels"] == 256, res
    assert res["registers"] == res["runtime_registers"] > 0
    assert res["spill_store_bytes"] == res["local_bytes"] == 0, res
    assert res["blocks_per_sm"] >= 1 and res["max_active_clusters"] >= 1, res
    assert res["smem_bytes"] - res["smem"] <= fl.STATIC_SMEM, res


def test_fused_layer1_rounds_ties_as_plain(gen):
    """Conv 0's codes on and beside half-way points: x holds (j + 1/2) m /
    127 and the floats next to them, with max|x| = m, so that x / a_scale
    falls on a tie or within an ulp of one; the kernel's division must
    round as the plain version's."""
    packed = _packed(1, seed=2)
    m = 3.0
    ties = (torch.arange(-127, 127, device="cuda") + 0.5) * (m / 127)
    vals = torch.cat([ties, torch.nextafter(ties, ties + 1),
                      torch.nextafter(ties, ties - 1)])
    x = vals[torch.randint(len(vals), (2, 16, 16, 64), generator=gen,
                           device="cuda")]
    x[:, 0, 0, 0] = m
    _close(_fused(x, packed), fl.fused_layer1_plain(x, *packed),
           fl.TOL[torch.float32])
