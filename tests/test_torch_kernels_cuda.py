"""The port's hand-written CUDA kernels against their plain versions on
the card: at edge shapes and at the serving forward's shapes, with the
faulty variants that their limits must reject, their resources, and the
shapes they refuse. `chip_smoke.py` times them and drives the whole
paths. Every test here needs a CUDA card and skips without one; the file
imports nothing of JAX, so it also runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import math

import pytest
import torch

from egotap_tpu_torch.models.resnet import BasicBlock
from egotap_tpu_torch.ops import attention as att
from egotap_tpu_torch.ops import bn_act as E
from egotap_tpu_torch.ops import fused_layer1 as fl
from egotap_tpu_torch.ops import int8_pack as F8
from egotap_tpu_torch.ops import (attention_launches_by_heads, kernel_errors,
                                  launch_counts)
from egotap_tpu_torch.ops import _build, pu_kernel, quant
from egotap_tpu_torch.ops import upsample as up
from egotap_tpu_torch.ops.quant import (f32_scalar, im2col, int8_matmul,
                                        quantized_conv)
from egotap_tpu_torch.serving import init_weights
from pu_chain_schedule import schedule_vjp
from test_torch_attention_launch import _tf32
from test_torch_kernel_launch import int8_serving_products

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


def _outside(got, want, tol):
    """Some output of ``got`` reads outside ``tol`` against ``want``."""
    return any(m > tol[0] or r > tol[1] for m, r in
               (kernel_errors(g, w)[1:] for g, w in zip(got, want)))


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
                                       (1, 2048, 2), (32, 576, 8)])
def test_attention_bf16_long_seq(gen, b, s, heads, dtype):
    """Neither kernel keeps a score tile, so S has no limit, on the packed
    and on the unpacked layout; and the Grid-ViT's serving call, (32, 576,
    8 x 128), on both."""
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


def _attention_variant(q, k, v, heads, rnd=lambda x: x, keys=None):
    """The plain f32 attention formula on (B, S, H*Dh) with ``rnd``
    applied to both products' operands, over the first ``keys`` keys:
    the faulty f32 variants kernel B's limits must reject."""
    b, s, d = q.shape
    hd = d // heads

    def split(x):
        return x.reshape(b, -1, heads, hd).transpose(1, 2)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32, device=q.device)
    scores = (rnd(split(q)) @ rnd(split(k[:, :keys])).transpose(-1, -2)
              ) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = rnd(p) @ rnd(split(v[:, :keys]))
    return out.transpose(1, 2).reshape(b, s, d)


@pytest.mark.parametrize("layout", ["packed", "unpacked"])
@pytest.mark.parametrize("fault,dtype", [("p_unrounded", "bfloat16"),
                                         ("tf32_once", "float32"),
                                         ("last_chunk_dropped", "float32")])
def test_attention_controls_rejected(gen, fault, dtype, layout):
    """Faults the limits must see at the Grid-ViT's call, (32, 576, 8 x
    128), packed and on the unpacked (B, H, S, Dh) layout: in bf16 p left
    in f32 (not rounded before p v); in f32 both products' operands
    rounded to TF32 once (what 3xTF32 computes when it loses its small
    parts), and the last chunk of 64 keys left out of the softmax and of
    p v. Each reads outside `TOL` where the kernel reads inside."""
    dt = getattr(torch, dtype)
    b, s, heads = 32, 576, 8
    if layout == "packed":
        q, k, v = (torch.randn(b, s, heads * 128, generator=gen,
                               device="cuda").to(dt) for _ in range(3))
        got = att.multihead_attention_packed(q, k, v, heads)
    else:
        qkv = [torch.randn(b, heads, s, 128, generator=gen,
                           device="cuda").to(dt) for _ in range(3)]
        got = att.multihead_attention(*qkv).reshape(b * heads, s, 128)
        q, k, v = (x.reshape(b * heads, s, 128) for x in qkv)
        heads = 1
    ref = att.attention_packed_plain(q, k, v, heads)
    _close(got, ref, att.TOL[dt])
    if fault == "p_unrounded":
        faulty = att.attention_packed_plain(q.float(), k.float(), v.float(),
                                            heads).to(dt)
    elif fault == "tf32_once":
        faulty = _attention_variant(q, k, v, heads, rnd=_tf32)
    else:
        faulty = _attention_variant(q, k, v, heads, keys=(s - 1) // 64 * 64)
    assert _outside([faulty], [ref], att.TOL[dt])


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


# kernel A's three calls a decoder makes at the serving batch of 32: a
# resnet18 net's, and a resnet50/101 net's (4x the channels)
RESNET18_CALLS = [(32, 8, 8, 1024), (32, 16, 16, 1024), (32, 32, 32, 512)]
RESNET50_CALLS = [(32, 8, 8, 4096), (32, 16, 16, 4096), (32, 32, 32, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [
    (3, 1, 4, 8), (2, 5, 1, 16), (2, 7, 9, 8), (1, 1, 1, 8),   # h, w = 1, odd
    (2, 33, 17, 24), (1, 160, 96, 64),      # ragged band, narrowed slices
    (70000, 2, 2, 8)] + RESNET18_CALLS)     # images past the grid's 65535
def test_upsample_edge_shapes(gen, shape, dtype):
    dt = getattr(torch, dtype)
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    before = up.upsample2x_align_corners.launches
    got = up.upsample2x_align_corners(x)
    assert up.upsample2x_align_corners.launches == before + 1
    _close(got, up.upsample2x_plain(x), up.TOL[dt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RESNET50_CALLS)
def test_upsample_resnet50_width(gen, shape, dtype):
    """The calls of a resnet50/101 decoder (fs = 8; the largest conv_up2's
    2048 channels at 32 x 32, batch 32), one launch each."""
    dt = getattr(torch, dtype)
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    before = up.upsample2x_align_corners.launches
    got = up.upsample2x_align_corners(x)
    assert up.upsample2x_align_corners.launches == before + 1
    _close(got, up.upsample2x_plain(x), up.TOL[dt])


@pytest.mark.parametrize("shape", RESNET18_CALLS + RESNET50_CALLS)
def test_upsample_controls_rejected(gen, shape):
    """The fault the limits must see in bf16 at the decoders' serving
    calls: the rows rounded to bf16 between the row and the column pass
    (a second rounding) reads outside `TOL`, where the kernel reads
    inside."""
    dt = torch.bfloat16
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    ref = up.upsample2x_plain(x)
    _close(up.upsample2x_align_corners(x), ref, up.TOL[dt])
    rows = up._lerp(x.float(), 1, shape[1]).to(dt)
    faulty = up._lerp(rows.float(), 2, shape[2]).to(dt)
    assert _outside([faulty], [ref], up.TOL[dt])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(16, 8, 8, 1024), (16, 16, 16, 1024),
                                   (16, 32, 32, 512)])
def test_upsample_grad_matches_plain(gen, shape, dtype):
    """Kernel A under autograd at the stage-1 decoder's three calls (batch
    16): one launch, the kernel's output, and its backward (autograd over
    the plain version, recomputed) against autograd over the plain
    version. Both backwards accumulate the taps with atomics on the card
    (`index_select`'s backward), in an order that may change from run to
    run: the f32 sums of up to four taps reassociate, and a bf16 gradient
    may then round the other way, so the check is `TOL`, not equality."""
    dt = getattr(torch, dtype)
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    x.requires_grad_(True)
    n, h, w, c = shape
    ct = torch.randn(n, 2 * h, 2 * w, c, generator=gen, device="cuda").to(dt)
    before = up.upsample2x_align_corners.launches
    out = up.upsample2x_align_corners(x)
    assert up.upsample2x_align_corners.launches == before + 1
    assert type(out.grad_fn).__name__ == "_KernelABackward"
    _close(out.detach(), up.upsample2x_plain(x.detach()), up.TOL[dt])
    (got,) = torch.autograd.grad(out, x, ct)
    leaf = x.detach().requires_grad_(True)
    (want,) = torch.autograd.grad(up.upsample2x_plain(leaf), leaf, ct)
    assert got.dtype == dt and got.shape == x.shape
    _close(got, want, up.TOL[dt])


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


def _pu_inputs(gen, b, j, h, dt, views=False):
    """Kernel C's inputs at (B, J, H); with ``views`` its (in, out)
    kernels are transposed views of (out, in) tensors, as the lifter
    passes its Linear weights (which the kernel reads without a copy)."""
    def u(*shape):
        return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1
                ) * h ** -0.5

    def kernel(n_in, n_out):
        return u(n_out, n_in).to(dt).t() if views else u(n_in, n_out).to(dt)
    fh = torch.sigmoid(torch.randn(b, j, h, generator=gen, device="cuda"))
    gp = 0.5 * torch.randn(b, j, 4 * h, generator=gen, device="cuda")
    cell1 = {n: {"kernel": kernel(h, m), "bias": u(m)}
             for n, m in (("x2f", h), ("x2h", 4 * h), ("h2h", 4 * h))}
    return fh, gp, kernel(h, 4 * h), cell1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,j,h,views", [
    (1, 1, 128, False), (5, 2, 128, False), (8, 5, 128, False),
    (32, 15, 512, False), (32, 15, 512, True), (33, 17, 512, False),
    (3, 4, 36, False)])
def test_pu_chain_matches_plain_small(gen, b, j, h, views, dtype):
    """H=128: one hidden unit per block; 512: the lifter's four. B=1, 3, 5
    and 33 leave ragged row tiles; J=1 is fill and drain alone; J=15 and
    17 walk long enough for a stale operand (an L1 hit on another block's
    slot, a wrong buffer) to show. H=36 is padded to 48: bf16 weight rows
    (72 bytes) reach the kernel padded, f32 ones are padded in shared
    memory. (32, 15, 512) with the weights as views is the lifter's
    serving call."""
    dt = getattr(torch, dtype)
    args = _pu_inputs(gen, b, j, h, dt, views)
    before = pu_kernel.pu_chain_fused.launches
    got = pu_kernel.pu_chain_fused(*args)
    assert pu_kernel.pu_chain_fused.launches == before + 1
    assert got.shape == (b, j, h) and torch.isfinite(got).all()
    _close(got, pu_kernel.pu_chain_plain(*args), pu_kernel.TOL[dt])


@pytest.mark.parametrize("fault", ["operands_f32", "no_recurrent"])
def test_pu_chain_controls_rejected(gen, fault):
    """Faults the limits must see in bf16 at the lifter's serving call:
    the matrix operands left in f32 (not rounded to bf16), and layer 1's
    recurrent product dropped. Each reads outside `TOL` where the kernel
    reads inside."""
    dt = torch.bfloat16
    fh, gp, w0, cell1 = _pu_inputs(gen, 32, 15, 512, dt, views=True)
    ref = pu_kernel.pu_chain_plain(fh, gp, w0, cell1)
    _close(pu_kernel.pu_chain_fused(fh, gp, w0, cell1), ref,
           pu_kernel.TOL[dt])
    if fault == "operands_f32":
        faulty = pu_kernel.pu_chain_plain(fh, gp, w0.float(), {
            n: {"kernel": c["kernel"].float(), "bias": c["bias"]}
            for n, c in cell1.items()})
    else:
        faulty = pu_kernel.pu_chain_plain(fh, gp, w0, dict(cell1, h2h={
            "kernel": torch.zeros_like(cell1["h2h"]["kernel"]),
            "bias": cell1["h2h"]["bias"]}))
    assert _outside([faulty], [ref], pu_kernel.TOL[dt])


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


def _pu_leaves(gen, b, j, h, dt):
    """Kernel C's inputs as leaves, the weights as (out, in) tensors the
    chain takes transposed (as the lifter passes its Linear weights), a
    call of a chain function on them, and an output gradient."""
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
    return leaves, call, ct


def _plain_vjp_rows(leaves, ct, **faults):
    """`pu_chain_plain_vjp` at ``leaves`` (weights as (out, in) rows), or
    with ``faults`` the reverse walk's schedule with those faults
    (`schedule_vjp`), its weight gradients transposed back to the rows."""
    fh, gp, w0, *c1 = [x.detach() for x in leaves]
    cells = {n: {"kernel": c1[2 * i].t(), "bias": c1[2 * i + 1]}
             for i, n in enumerate(("x2f", "x2h", "h2h"))}
    vjp = schedule_vjp if faults else pu_kernel.pu_chain_plain_vjp
    dfh, dgp, dw0, d1 = vjp(fh, gp, w0.t(), cells, ct, **faults)
    return [dfh, dgp, dw0.t()] + [
        x for n in ("x2f", "x2h", "h2h")
        for x in (d1[n]["kernel"].t(), d1[n]["bias"])]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,j,h", [(32, 15, 512), (3, 4, 36), (1, 1, 16),
                                   (8, 17, 512)])
def test_pu_chain_grad_matches_plain(gen, b, j, h, dtype):
    """Kernel C's autograd function at the lifter's shape, at H = 36
    (padded rows), at one joint of one row (H = 16: a unit a block) and
    at EgoCap's J = 17: the forward launches the kernel once and the
    backward the reverse walk once, and the gradients in fh, gates_pre
    and every weight and bias (the weights passed as transposed views of
    (out, in) tensors, as the lifter passes its Linear weights) hold to
    `pu_kernel.GRAD_TOL` against autograd over the plain version (what
    the backward was, `ops.plain_vjp`) and against its plain counterpart
    `pu_chain_plain_vjp`, each in its input's dtype."""
    dt = getattr(torch, dtype)
    leaves, call, ct = _pu_leaves(gen, b, j, h, dt)
    before = pu_kernel.pu_chain_fused.launches
    back = pu_kernel.pu_chain_fused.backward_launches
    got, grads = _vjp(call(pu_kernel.pu_chain_fused), leaves, ct)
    assert pu_kernel.pu_chain_fused.launches == before + 1
    assert pu_kernel.pu_chain_fused.backward_launches == back + 1
    ref, want = _vjp(call(pu_kernel.pu_chain_plain), leaves, ct)
    _close(got, ref, pu_kernel.TOL[dt])
    plain = _plain_vjp_rows(leaves, ct)
    for g, w, p in zip(grads, want, plain):
        assert g.dtype == w.dtype == p.dtype and torch.isfinite(g).all()
        _close(g, w, pu_kernel.GRAD_TOL[dt])
        _close(g, p, pu_kernel.GRAD_TOL[dt])


@pytest.mark.parametrize("fault,dtype", [("unrounded", "bfloat16"),
                                         ("no_recurrent", "bfloat16"),
                                         ("no_recurrent", "float32")])
def test_pu_chain_grad_controls_rejected(gen, fault, dtype):
    """The negative controls at the lifter's shape: the backward with
    x's gradient left unrounded, or with layer 1's recurrent gradient
    term dropped (`schedule_vjp`'s faults), reads outside
    `pu_kernel.GRAD_TOL` against autograd over the plain version in some
    gradient, where the kernel reads inside."""
    dt = getattr(torch, dtype)
    leaves, call, ct = _pu_leaves(gen, 32, 15, 512, dt)
    _, want = _vjp(call(pu_kernel.pu_chain_plain), leaves, ct)
    _, grads = _vjp(call(pu_kernel.pu_chain_fused), leaves, ct)
    assert not _outside(grads, want, pu_kernel.GRAD_TOL[dt])
    assert _outside(_plain_vjp_rows(leaves, ct, **{fault: True}), want,
                    pu_kernel.GRAD_TOL[dt])


@pytest.mark.parametrize("wanted", [(0,), (2,), (1, 4, 8), (3, 5, 7)])
def test_pu_chain_grad_partial(gen, wanted):
    """Only some inputs require grad (fh alone, the layer-0 kernel alone,
    gates_pre with two biases, the top cell's kernels): one reverse walk,
    and those gradients as with every input requiring one."""
    dt = torch.bfloat16
    leaves, call, ct = _pu_leaves(gen, 8, 15, 512, dt)
    _, everything = _vjp(call(pu_kernel.pu_chain_fused), leaves, ct)
    args = [x.detach().requires_grad_(i in wanted)
            for i, x in enumerate(leaves)]
    back = pu_kernel.pu_chain_fused.backward_launches
    grads = torch.autograd.grad(call(pu_kernel.pu_chain_fused)(*args),
                                [args[i] for i in wanted], ct)
    assert pu_kernel.pu_chain_fused.backward_launches == back + 1
    for g, i in zip(grads, wanted):
        assert torch.equal(g, everything[i])


def test_pu_chain_backward_range(gen, tmp_path):
    """A profiled training backward holds one range named
    `pu_kernel.BACKWARD_LABEL` (what the benchmark's recompute_ms reads),
    and the reverse walk's launch and the weight products' are made
    inside it (matched to their kernels by the trace's correlation ids,
    as the benchmark matches them); the walk's kernel is not named as
    the forward's."""
    import json
    from torch.profiler import ProfilerActivity, profile
    leaves, call, ct = _pu_leaves(gen, 32, 15, 512, torch.bfloat16)
    _vjp(call(pu_kernel.pu_chain_fused), leaves, ct)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _vjp(call(pu_kernel.pu_chain_fused), leaves, ct)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())[
        "traceEvents"] if e.get("ph") == "X"]
    (rng,) = [e for e in events if e["name"] == pu_kernel.BACKWARD_LABEL
              and e.get("cat") == "user_annotation"]
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    inside = []
    for k in events:
        if k.get("cat") != "kernel":
            continue
        at = launches.get(k["args"].get("correlation"))
        if at and at["tid"] == rng["tid"] and \
                rng["ts"] <= at["ts"] <= rng["ts"] + rng["dur"]:
            inside.append(k["name"])
    assert sum("pu_chain_reverse" in n for n in inside) == 1, inside
    assert not any("pu_chain_kernel" in n for n in inside), inside
    assert len(inside) >= 5, inside                # the weight products too


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
    are co-resident (one an SM); the barrier-only walk runs. The same
    for the reverse walk's kernel."""
    dt = getattr(torch, dtype)
    res = pu_kernel.kernel_resources(dt, 32, 512)
    assert res["registers"] == res["runtime_registers"] > 0
    assert res["spill_store_bytes"] == res["local_bytes"] == 0, res
    assert res["units"] == 4 and res["blocks"] == 128, res
    assert res["blocks_per_sm"] >= 1 and res["blocks"] <= res["sms"], res
    pu_kernel.barrier_walk(32, 15, 512, dt, "cuda")
    torch.cuda.synchronize()
    rev = pu_kernel.reverse_resources(dt, 32, 512)
    assert rev["registers"] == rev["runtime_registers"] > 0, rev
    assert rev["spill_store_bytes"] == rev["local_bytes"] == 0, rev
    assert rev["blocks_per_sm"] >= 1 and rev["blocks"] <= rev["sms"], rev


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


def _one_scale_per_batch(x, w_q, w_scale, bias):
    """Layer1 with one dynamic int8 scale a conv for the whole batch (the
    generic `quantized_conv`) instead of one an image."""
    c = x.shape[-1]
    act = res = x.float()
    for i in range(w_q.shape[0]):
        w = w_q[i].reshape(3, 3, c, c).permute(3, 2, 0, 1)
        out = quantized_conv(act, w, w_scale[i], 1, 1, bias[i])
        act = torch.relu(out if i % 2 == 0 else out + res)
        res = act if i % 2 else res
    return act.to(x.dtype)


def _one_scale_per_band(x, w_q, w_scale, bias):
    """Layer1 with one scale a block's run of pixels (its rows) instead of
    one an image: the fault a cluster design can make."""
    n, h, w, c = x.shape
    pb = fl.cluster_geometry(h, w)["pixels"]
    act = res = x.float()
    for i in range(w_q.shape[0]):
        band = act.reshape(n, -1, pb * c).abs().amax(dim=2)
        a_scale = (torch.clamp_min(band, 1e-12) / f32_scalar(act, 127.0)
                   ).repeat_interleave(pb, dim=1).reshape(n, h, w, 1)
        codes = torch.round(act / a_scale).clamp_(-127, 127).to(torch.int8)
        cols, _ = im2col(codes, 3, 1, 1)
        acc = int8_matmul(cols, w_q[i].t()).reshape(n, h, w, c)
        out = acc.float() * (a_scale * w_scale[i]) + bias[i]
        act = torch.relu(out if i % 2 == 0 else out + res)
        res = act if i % 2 else res
    return act.to(x.dtype)


def _residual_dropped(x, w_q, w_scale, bias):
    """Layer1 with the second block's residual dropped."""
    block1 = fl.fused_layer1_plain(x.float(), w_q[:2], w_scale[:2], bias[:2])
    conv3 = fl.fused_layer1_plain(block1, w_q[2:3], w_scale[2:3], bias[2:3])
    return fl.fused_layer1_plain(conv3, w_q[3:], w_scale[3:], bias[3:]
                                 ).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", [_one_scale_per_batch, _one_scale_per_band,
                                   _residual_dropped],
                         ids=["one_scale_per_batch", "one_scale_per_band",
                              "residual_dropped"])
def test_fused_layer1_controls_rejected(gen, fault, dtype):
    """Faults the limits must see at the serving call, one net's 64 images
    of 64 x 64 through layer1's two blocks, image i scaled by 1 + i/8 so
    that the images' scales differ: one activation scale for the whole
    batch, one for each block's run of pixels, the second block's
    residual dropped. Each reads outside `TOL` where the kernel reads
    inside."""
    packed = _packed(2, seed=2)
    ramp = 1 + torch.arange(64, device="cuda")[:, None, None, None] / 8
    x = (torch.randn(64, 64, 64, 64, generator=gen, device="cuda") * ramp
         ).to(getattr(torch, dtype))
    ref = fl.fused_layer1_plain(x, *packed)
    _close(_fused(x, packed), ref, fl.TOL[x.dtype])
    assert _outside([fault(x, *packed)], [ref], fl.TOL[x.dtype])


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_tensor_parallel_shard(gen, dtype):
    """Kernel B at a tensor-parallel shard's shape: the Grid-ViT's heads
    split over 2 model shards, (16, 576, 512) with 4 heads
    (`parallel/tp.py`)."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(16, 576, 4 * 128, generator=gen,
                           device="cuda").to(dt) for _ in range(3))
    before = att.multihead_attention_packed.launches
    by_heads = attention_launches_by_heads()
    got = att.multihead_attention_packed(q, k, v, 4)
    assert att.multihead_attention_packed.launches == before + 1
    assert attention_launches_by_heads() == {
        **by_heads, 4: by_heads.get(4, 0) + 1}
    _close(got, att.attention_packed_plain(q, k, v, 4), att.TOL[dt])


def test_one_nccl_rank_step_equals_one_process(gen, tmp_path):
    """A stage-2 training step through a process group of one NCCL rank
    (`parallel/mesh.py`: gradients averaged by an all-reduce, losses too)
    equals the single-process step bit for bit, at a small size."""
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.parallel import mesh
    from egotap_tpu_torch.train.tasks import LifterTask
    cfg = Config(model="egotap_autoencoder", num_heatmap=15,
                 num_rot_heatmap=15, heatmap_type="sin", ae_hidden_size=8,
                 load_size_heatmap=(16, 16), batch_size=2).derive()
    batch = {"input_rgb": torch.randn(2, 2, 64, 64, 3, generator=gen,
                                      device="cuda"),
             "gt_local_pose": torch.randn(2, 16, 3, generator=gen,
                                          device="cuda")}
    store = torch.distributed.FileStore(str(tmp_path / "store"), 1)
    dp = mesh.init("cuda:0", rank=0, world_size=1, store=store,
                   backend="nccl")
    try:
        out = []
        for ranks in (None, dp):
            task = LifterTask(cfg, device="cuda", dp=ranks)
            state = task.init_state(seed=0, iters_per_epoch=1)
            state, losses = task.train_step(state, batch)
            out.append((losses, state.net.state_dict(),
                        state.frozen["heatmap"].state_dict()))
    finally:
        mesh.shutdown()
    (l1, n1, f1), (l2, n2, f2) = out
    assert {k: float(v) for k, v in l1.items()} == \
        {k: float(v) for k, v in l2.items()}
    for a, b in ((n1, n2), (f1, f2)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


# kernel E at every trunk shape of the resnet18 and resnet50 serving nets
# (64 images: 32 stereo pairs), (N, H, W, C): the stem; layer1 to layer4
# (resnet50: each bottleneck's 64-, 128-, 256- or 512-channel inner
# convs, its 4x-wide last conv, and the first block's conv1 at the
# stage's input grid); then the fused net's grouped widths (64 * 3
# channels: 24 vectors a bf16 row, which 256 threads do not divide, and
# resnet50's layer4 for two trunks: 1024 f32 vectors a row)
BN_SHAPES = [(64, 128, 128, 64), (64, 64, 64, 64), (64, 32, 32, 128),
             (64, 16, 16, 256), (64, 8, 8, 512),
             (64, 64, 64, 256), (64, 64, 64, 128), (64, 32, 32, 512),
             (64, 32, 32, 256), (64, 16, 16, 1024), (64, 16, 16, 512),
             (64, 8, 8, 2048),
             (8, 64, 64, 192), (8, 8, 8, 4096)]
BN_FORMS = ["bn_relu", "identity_relu", "bn_residual_relu"]


def _bn_module(c, gen):
    """A BatchNorm2d on the card in eval mode, its parameters frozen, with
    statistics far from the identity (var over three decades)."""
    bn = torch.nn.BatchNorm2d(c, eps=E.BN_EPS).cuda().eval()
    bn.requires_grad_(False)
    with torch.no_grad():
        bn.running_mean.normal_(0.0, 0.5, generator=gen)
        bn.running_var.copy_(10 ** (3 * torch.rand(c, generator=gen,
                                                   device="cuda") - 2))
        bn.weight.normal_(1.0, 0.3, generator=gen)
        bn.bias.normal_(0.0, 0.5, generator=gen)
    return bn


def _form(form, r, bn_r):
    """(residual, residual_bn) of a form."""
    return {"bn_relu": (None, None), "identity_relu": (r, None),
            "bn_residual_relu": (r, bn_r)}[form]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _bn_launch(x, bn, residual=None, residual_bn=None):
    before = E.bn_act.launches
    got = E.bn_act(x, bn, residual, residual_bn)
    assert E.bn_act.launches == before + 1
    return got


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_act_matches_plain(gen, shape, dtype):
    """Kernel E equals the plain sequence bit for bit in each of its three
    forms: BatchNorm, ReLU; + the block input, ReLU; + a second
    BatchNorm'd input, ReLU."""
    dt = getattr(torch, dtype)
    x, r = (torch.randn(shape, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    bn, bn_r = _bn_module(shape[-1], gen), _bn_module(shape[-1], gen)
    with torch.no_grad():
        for form in BN_FORMS:
            args = _form(form, r, bn_r)
            got = _bn_launch(x, bn, *args)
            want = E.bn_act_plain(x, bn, *args)
            _close(got, want, E.TOL[dt])
            assert torch.equal(_bits(got), _bits(want)), form


def test_bn_act_every_root(gen):
    """One row of 2^20 channels: the statistics of each channel, var over
    twelve decades and below eps, give the plain sequence's inv (the
    kernel's rsqrtf is PyTorch's). With no bias, the weight and its
    negation put each channel's value on the positive side of the ReLU
    once."""
    c = 1 << 20
    bn = _bn_module(c, gen)
    with torch.no_grad():
        bn.running_var.copy_(10 ** (12 * torch.rand(c, generator=gen,
                                                    device="cuda") - 7))
        bn.bias.zero_()
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(2, c, generator=gen, device="cuda").to(dt)
            for _ in range(2):
                bn.weight.neg_()
                assert torch.equal(_bits(_bn_launch(x, bn)),
                                   _bits(E.bn_act_plain(x, bn)))


# resnet50's layer1 calls at the serving batch: a bottleneck's last conv
# with the block input added, and its inner convs
LAYER1_CALLS = [((64, 64, 64, 256), True), ((64, 64, 64, 64), False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,residual", LAYER1_CALLS)
def test_bn_act_controls_rejected(gen, shape, residual, dtype):
    """Faults the bit-for-bit check must see, at resnet50's layer1 calls:
    (x - mean) * inv + bias contracted into one FMA (the product exact in
    f64, the sum rounded once) and, in bf16, the product rounded to bf16
    before + bias, and the residual added to the BatchNorm's f32 value
    before its rounding (in f32 that rounding is none)."""
    dt = getattr(torch, dtype)
    x, r = (torch.randn(shape, generator=gen, device="cuda").to(dt)
            for _ in range(2))
    r = r if residual else None
    bn = _bn_module(shape[-1], gen)
    with torch.no_grad():
        inv = torch.rsqrt(bn.running_var + E.BN_EPS) * bn.weight
        centred = x.float() - bn.running_mean
        fma = (centred.double() * inv.double() + bn.bias.double()).float()
        faults = {"contracted FMA": fma.to(dt)}
        if dt == torch.bfloat16:
            faults["product rounded"] = ((centred * inv).to(dt).float()
                                         + bn.bias).to(dt)
        faults = {name: torch.relu(f if r is None else f + r)
                  for name, f in faults.items()}
        if dt == torch.bfloat16 and residual:
            faults["residual before rounding"] = torch.relu(
                centred * inv + bn.bias + r.float()).to(dt)
        got = _bn_launch(x, bn, r)
        assert torch.equal(got, E.bn_act_plain(x, bn, r))
        for name, fault in faults.items():
            max_abs, _, _ = kernel_errors(got, fault)
            assert max_abs > 0, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,residual", LAYER1_CALLS)
def test_bn_act_kernel_resources(gen, shape, residual, dtype):
    """At resnet50's layer1 calls: a block fits an SM and nothing spills
    to local memory."""
    res = E.kernel_resources(getattr(torch, dtype), int(residual),
                             math.prod(shape), shape[-1])
    assert res["blocks_per_sm"] >= 1 and res["local_bytes"] == 0, res


def test_bn_act_refusals(gen):
    """On the card `bn_act` raises for C not a multiple of the vector or
    not the BatchNorm's, float16 and float64, statistics on the CPU, and
    launches nothing; a strided x or residual, or one off the 16-byte
    grid, is copied and gives the plain sequence's result."""
    bn = _bn_module(64, gen)
    x = torch.randn(2, 4, 4, 64, generator=gen, device="cuda")
    cpu_bn = torch.nn.BatchNorm2d(64).eval().requires_grad_(False)
    cases = [(x[..., :60].contiguous().bfloat16(), _bn_module(60, gen),
              "multiple of 8"),
             (x[..., :62].contiguous(), _bn_module(62, gen), "multiple of 4"),
             (x[..., :32].contiguous(), bn, "not f32 \\(32,\\)"),
             (x.half(), bn, "dtype"), (x.double(), bn, "dtype"),
             (x, cpu_bn, "on cpu")]
    before = E.bn_act.launches
    with torch.no_grad():
        for inp, norm, match in cases:
            with pytest.raises(NotImplementedError, match=match):
                E.bn_act(inp, norm)
        assert E.bn_act.launches == before
        strided = x.transpose(1, 2)
        shifted = torch.randn(2 * 4 * 4 * 64 + 1, generator=gen,
                              device="cuda")[1:].view(x.shape)
        for inp, residual in ((strided, None), (x, strided),
                              (shifted, None), (x, shifted)):
            assert torch.equal(_bn_launch(inp, bn, residual),
                               E.bn_act_plain(inp, bn, residual))


def test_bn_act_grad_through_the_kernel(gen):
    """A call that asks for a gradient launches kernel E (the output
    equals the plain sequence's) and its gradients are autograd's over
    the plain sequence, bit for bit."""
    x, r = (torch.randn(8, 8, 8, 64, generator=gen, device="cuda",
                        requires_grad=True) for _ in range(2))
    bn, bn_r = _bn_module(64, gen), _bn_module(64, gen)
    for t in (bn.weight, bn.bias):
        t.requires_grad_(True)
    leaves = [x, r, bn.weight, bn.bias]
    got = _bn_launch(x, bn, r, bn_r)
    want = E.bn_act_plain(x, bn, r, bn_r)
    assert type(got.grad_fn).__name__ == "_KernelEBackward"
    assert torch.equal(got, want)
    ct = torch.randn(x.shape, generator=gen, device="cuda")
    for a, b in zip(torch.autograd.grad(got, leaves, ct),
                    torch.autograd.grad(want, leaves, ct)):
        assert torch.equal(a, b)


def test_bn_act_reads_new_statistics(gen, monkeypatch):
    """A training-mode forward moves the running statistics; the eval
    forward after it reads the new ones (the plain sequence on the same
    buffers, bit for bit), and differs from the eval forward before."""
    from egotap_tpu_torch.models import resnet
    net = resnet.ResNetEncoder("resnet18")
    init_weights(net, torch.Generator().manual_seed(3))
    net = net.cuda()
    x = torch.randn(4, 64, 64, 3, generator=gen, device="cuda")
    with torch.no_grad():
        before = net.eval()(x)[-1]
        net.train()(x * 2 + 1)
        after = net.eval()(x)[-1]
        monkeypatch.setattr(resnet, "bn_act", E.bn_act_plain)
        plain = net(x)[-1]
    assert torch.equal(after, plain)
    assert not torch.equal(after, before)


@pytest.mark.parametrize("model,per_request", [("resnet18", 34),
                                               ("resnet50", 98)])
def test_bn_act_predictor_bit_for_bit(gen, monkeypatch, model,
                                      per_request):
    """A whole bf16 `Predictor` on the card: the heatmap stack and the
    pose with kernel E equal those of the same nets with the plain
    sequence put in its place, bit for bit; a request launches kernel E
    34 times (resnet18) or 98 (resnet50), the plain run never."""
    from egotap_tpu_torch.models import resnet
    from egotap_tpu_torch.serving import Predictor
    pred = Predictor(bf16=True, device="cuda", seed=0, model_name=model)
    rgb = torch.randn(4, 2, 256, 256, 3, generator=gen, device="cuda")

    def run():
        before = launch_counts()["bn_act"]
        pose = pred(rgb)
        launches = launch_counts()["bn_act"] - before
        with torch.no_grad():
            stack = pred._heatmap_stack(rgb)
        return pose, stack, launches
    pose, stack, launches = run()
    assert launches == per_request
    monkeypatch.setattr(resnet, "bn_act", E.bn_act_plain)
    plain_pose, plain_stack, plain_launches = run()
    assert plain_launches == 0
    assert torch.equal(stack, plain_stack)
    assert (pose == plain_pose).all()


# ---- kernel F: the passes around an int8 product

# every int8 product shape of the r18 int8 serving forward at batch 32,
# as (x's NHWC shape, kernel, stride, padding, N), read from one forward
# on the meta device: the trunk's BN-folded convs (3x3 and the 1x1
# downsamples, strides 1 and 2), the decoder's (its concatenated inputs of
# C = 1540, 1280 and 640, its 1x1 convs, the heads' N = 30 and 60), the
# lifter's dense products on (M, 1, 1, K) (N = 516)
INT8_PRODUCTS = list(int8_serving_products())
# around the chunks: M <= 16 (rows padded to 32) and 17, C of 3, 12, 20
# and 24 (chunks of 1, 4, 4 and 8 codes), K not a multiple of 8, odd
# images and strides, N of 1, 3, 5, 6 and 17
INT8_EDGES = [((1, 1, 1, 8), 1, 1, 0, 8), ((2, 3, 3, 3), 3, 1, 1, 5),
              ((1, 4, 4, 12), 3, 2, 1, 6), ((3, 5, 7, 24), 3, 2, 1, 17),
              ((2, 4, 4, 1540), 3, 1, 1, 60), ((5, 1, 1, 20), 1, 1, 0, 3),
              ((17, 1, 1, 16), 1, 1, 0, 1), ((2, 9, 5, 64), 3, 2, 0, 8)]
# a static scale whose f32 reciprocal is 0.75 of an f32 ulp too large: a
# multiply by it turns the ties 6.5, 12.5 and 14.5 into 7, 13 and 15
INT8_SCALE = 7.0


def _int8_input(shape, dtype, gen):
    """x at the scale `INT8_SCALE`: a third of it at exact ties (k + 0.5)
    * 7 for |k + 0.5| < 18 (8 significant bits: exact in bf16, and x / 7
    exact), a tenth past +-127 * 7, a fifth +-0 (a ReLU's zeros, which the
    kernel keeps off the division), the rest N(0, 40^2)."""
    kind = torch.rand(shape, generator=gen, device="cuda")
    ties = (torch.randint(-18, 18, shape, generator=gen, device="cuda")
            + 0.5) * INT8_SCALE
    past = torch.sign(kind - 0.05) * 1000 * INT8_SCALE
    noise = 40 * torch.randn(shape, generator=gen, device="cuda")
    zeros = torch.sign(kind - 0.53) * 0.0
    x = torch.where(kind < 0.33, ties, torch.where(
        kind < 0.43, past, torch.where(kind < 0.63, zeros, noise)))
    return x.to(dtype)


def _int8_weights(n_out, c, kernel, gen):
    """(w_q OIHW, or (out, in) for a dense product, its scale, a bias)."""
    shape = (n_out, c, kernel, kernel) if kernel > 1 else (n_out, c)
    w_q, w_scale = quant.quantize_weights(
        torch.randn(shape, generator=gen, device="cuda"))
    return w_q, w_scale, torch.randn(n_out, generator=gen, device="cuda")


def _int8_pack_case(shape, kernel, stride, padding, n_out, dt, gen):
    """F's pack rows, epilogue output and whole product (through
    `quantized_conv` or `quantized_dense`, one launch of each entry
    point) against the plain sequence's, bit for bit."""
    x = _int8_input(shape, dt, gen)
    a = f32_scalar(x, INT8_SCALE)
    w_q, w_scale, bias = _int8_weights(n_out, shape[-1], kernel, gen)
    rows, hw = F8.pack(x, a, kernel, stride, padding)
    want_rows, want_hw = F8.pack_plain(x, a, kernel, stride, padding)
    assert hw == want_hw and torch.equal(rows, want_rows)
    m = shape[0] * hw[0] * hw[1]
    acc = torch._int_mm(rows, F8.weight_rows(w_q).t())
    got = F8.epilogue(acc, m, n_out, a, w_scale, bias, dt)
    want = F8.epilogue_plain(acc, m, n_out, a, w_scale, bias, dt)
    _close(got, want, F8.TOL[dt])
    assert torch.equal(_bits(got), _bits(want))
    before = launch_counts()
    if kernel > 1 or shape[1:3] != (1, 1):
        got = quant.quantized_conv(x, w_q.view(n_out, -1, kernel, kernel),
                                   w_scale, stride, padding, bias, a)
        want = quant.conv_plain(x, w_q.view(n_out, -1, kernel, kernel),
                                w_scale, stride, padding, bias, a)
    else:
        x2 = x.view(shape[0], shape[-1])
        got = quant.quantized_dense(x2, w_q, w_scale, bias, a)
        want = quant.dense_plain(x2, w_q, w_scale, bias, a)
    after = launch_counts()
    assert [after[k] - before[k] for k in ("int8_pack", "int8_epilogue")] \
        == [1, 1]
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kernel,stride,padding,n_out",
                         INT8_PRODUCTS)
def test_int8_pack_matches_plain(gen, shape, kernel, stride, padding, n_out,
                                 dtype):
    """Kernel F at each product shape of the int8 serving forward: the
    pack's rows, the epilogue's output and the whole product equal the
    plain sequence's bit for bit (`int8_pack.TOL`)."""
    with torch.no_grad():
        _int8_pack_case(shape, kernel, stride, padding, n_out,
                        getattr(torch, dtype), gen)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kernel,stride,padding,n_out", INT8_EDGES)
def test_int8_pack_edge_shapes(gen, shape, kernel, stride, padding, n_out,
                               dtype):
    with torch.no_grad():
        _int8_pack_case(shape, kernel, stride, padding, n_out,
                        getattr(torch, dtype), gen)


def test_int8_pack_zero_input(gen):
    """All-zero x: every code 0, the output the bias alone, as the plain
    sequence gives it; the dynamic scale (1e-12 / 127) as well."""
    x = torch.zeros(4, 6, 6, 64, device="cuda", dtype=torch.bfloat16)
    w_q, w_scale, bias = _int8_weights(32, 64, 3, gen)
    with torch.no_grad():
        rows, _ = F8.pack(x, f32_scalar(x, 0.5), 3, 1, 1)
        assert not rows.any()
        for a in (None, f32_scalar(x, 0.5)):
            got = quant.quantized_conv(x, w_q, w_scale, 1, 1, bias, a)
            assert torch.equal(got, quant.conv_plain(x, w_q, w_scale, 1, 1,
                                                     bias, a))
        assert torch.equal(got[0, 0, 0], bias.to(x.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_pack_controls_rejected(gen, dtype):
    """Faults the bit-for-bit check must see. The pack at a decoder-like
    call (C = 1540: K 13860, a tail of 4 codes; ties and values past 127
    * scale): codes rounded half away from zero, the quotient as a
    multiply by the reciprocal, the image border read as the edge instead
    of zeros, a dirty K tail. The epilogue on 2^25 products (in bf16 a
    one-ulp f32 change shows in about 2^-16 of the outputs): the
    dequantise contracted into one FMA."""
    dt = getattr(torch, dtype)
    x = _int8_input((2, 6, 6, 1540), dt, gen)
    a = f32_scalar(x, INT8_SCALE)
    with torch.no_grad():
        rows, _ = F8.pack(x, a, 3, 1, 1)
        assert torch.equal(rows, F8.pack_plain(x, a, 3, 1, 1)[0])

        def packed(q, pad=1, mode="constant"):
            codes = q.clamp(-127, 127).to(torch.int8)
            if mode == "replicate":
                codes = torch.nn.functional.pad(
                    codes.permute(0, 3, 1, 2).float(), (pad,) * 4,
                    mode=mode).permute(0, 2, 3, 1).to(torch.int8)
                pad = 0
            return quant.im2col(codes, 3, 1, pad)[0]
        q = x.float() / a
        away = torch.sign(q) * torch.floor(q.abs() + 0.5)
        tail = rows.clone()
        tail[:, 13860:] = 1
        faults = {"round half away": packed(away),
                  "reciprocal": packed(torch.round(x.float()
                                                   * (1 / a))),
                  "border from the edge": packed(torch.round(q), 1,
                                                 "replicate"),
                  "dirty K tail": tail}
        for name, fault in faults.items():
            assert fault.shape == rows.shape, name
            assert not torch.equal(rows, fault), name
        acc = torch.randint(-2 ** 20, 2 ** 20, (65536, 512), generator=gen,
                            device="cuda", dtype=torch.int32)
        w_scale = torch.rand(512, generator=gen, device="cuda") / 127
        bias = torch.randn(512, generator=gen, device="cuda")
        got = F8.epilogue(acc, 65536, 512, a, w_scale, bias, dt)
        assert torch.equal(got, F8.epilogue_plain(acc, 65536, 512, a,
                                                  w_scale, bias, dt))
        fma = (acc.double() * (a * w_scale).double()
               + bias.double()).float().to(dt)
        assert not torch.equal(got, fma), "contracted FMA"


# kernel F's template instances: (dtype, codes a chunk) of the pack,
# (dtype, outputs a chunk, bias) of the epilogue, as ptxas names them
INT8_PACK_ENTRIES = (
    [f"pack_kernelI{t}Li{v}E" for t in ("f", "13__nv_bfloat16")
     for v in (16, 8, 4, 1)]
    + [f"epilogue_kernelI{t}Li{v}ELb{b}E" for t in ("f", "13__nv_bfloat16")
       for v in (8, 4, 2, 1) for b in (0, 1)])


@pytest.mark.parametrize("entry", INT8_PACK_ENTRIES)
def test_int8_pack_kernel_resources(gen, entry):
    """No instance spills, and each keeps to 64 registers a thread: four
    blocks of 256 threads an SM, enough loads in flight for the bytes."""
    res = _build.ptxas_resources("int8_pack", entry)
    assert res["spill_store_bytes"] == 0 and res["spill_load_bytes"] == 0
    assert 0 < res["registers"] <= 64, res


def test_int8_pack_refusals(gen):
    """On the card F raises for float16 and float64, a scale that is not
    one f32 on x's device, a product that is not int32 or narrower than
    asked, and a scale vector of another size, and launches nothing; a
    strided x, or one off the 16-byte grid, is copied and packs as the
    plain sequence does."""
    x = torch.randn(2, 4, 4, 64, generator=gen, device="cuda")
    a = f32_scalar(x, 0.05)
    acc = torch.zeros(32, 64, dtype=torch.int32, device="cuda")
    w_scale = torch.ones(64, device="cuda")
    before = launch_counts()
    with torch.no_grad():
        for fn, match in (
                (lambda: F8.pack(x.half(), a), "dtype"),
                (lambda: F8.pack(x.double(), a), "dtype"),
                (lambda: F8.pack(x, a.cpu()), "scale"),
                (lambda: F8.pack(x, a.double()), "scale"),
                (lambda: F8.pack(x[0], a), "NHWC"),
                (lambda: F8.pack(x, a, 7, 1, 0), "kernel 7"),
                (lambda: F8.epilogue(acc.long(), 32, 64, a, w_scale, None,
                                     x.dtype), "product"),
                (lambda: F8.epilogue(acc, 33, 64, a, w_scale, None,
                                     x.dtype), "product"),
                (lambda: F8.epilogue(acc, 32, 64, a, w_scale[:60], None,
                                     x.dtype), "not f32 \\(64,\\)"),
                (lambda: F8.epilogue(acc, 32, 64, a, w_scale, None,
                                     torch.float16), "dtype")):
            with pytest.raises(NotImplementedError, match=match):
                fn()
        assert launch_counts() == before
        strided = x.transpose(1, 2)
        shifted = torch.randn(x.numel() + 1, generator=gen,
                              device="cuda")[1:].view(x.shape)
        for inp in (strided, shifted):
            assert torch.equal(F8.pack(inp, a, 3, 1, 1)[0],
                               F8.pack_plain(inp, a, 3, 1, 1)[0])


def test_int8_pack_grad_through_the_kernel(gen):
    """The int8 training mode's call (weights quantized anew, dynamic
    scale, a bias) asks for gradients: F launches (the output equals the
    plain sequence's) and the gradients of x, the weight and the bias
    are autograd's over the plain sequence, bit for bit."""
    x = torch.randn(4, 8, 8, 128, generator=gen, device="cuda",
                    requires_grad=True)
    weight = torch.randn(64, 128, 3, 3, generator=gen, device="cuda",
                         requires_grad=True)
    bias = torch.randn(64, generator=gen, device="cuda", requires_grad=True)
    leaves = [x, weight, bias]
    w_q, w_scale = quant.quantize_weights(weight)
    before = launch_counts()["int8_epilogue"]
    got = quant.quantized_conv(x, w_q, w_scale, 1, 1, bias)
    assert launch_counts()["int8_epilogue"] == before + 1
    assert type(got.grad_fn).__name__ == "_KernelFBackward"
    want = quant.conv_plain(x, w_q, w_scale, 1, 1, bias)
    assert torch.equal(got, want)
    ct = torch.randn(got.shape, generator=gen, device="cuda")
    # the weight's scale is one graph for both: keep it for the second
    for g, w in zip(torch.autograd.grad(got, leaves, ct, retain_graph=True),
                    torch.autograd.grad(want, leaves, ct)):
        assert torch.equal(g, w)


def plain_int8(monkeypatch):
    """Put the plain sequence in kernel F's place on the card."""
    monkeypatch.setattr(F8, "conv", lambda x, wq, w_scale, stride, padding,
                        bias, a_scale, w_rows: quant.conv_plain(
                            x, wq, w_scale, stride, padding, bias, a_scale))
    monkeypatch.setattr(F8, "dense", lambda x, wq, w_scale, bias, a_scale,
                        pre_q, w_rows: quant.dense_plain(
                            x, wq, w_scale, bias, a_scale, pre_q))
    monkeypatch.setattr(F8, "quantize", quant.quantize_activation)
    monkeypatch.setattr(F8, "dense_sum", lambda xs, a_scale, w_qs, w_rows,
                        w_scale, bias: F8.dense_sum_plain(
                            xs, a_scale, w_qs, w_scale, bias))


def test_int8_pack_predictor_bit_for_bit(gen, monkeypatch):
    """The r18 int8 serving `Predictor` on the card, calibrated: the
    heatmap stack and the pose with kernel F equal those of the same nets
    with the plain sequence in its place, bit for bit; a request launches
    F's pack 72 times and its epilogue 78 (once a product), the plain run
    neither."""
    from egotap_tpu_torch.serving import Predictor
    pred = Predictor(bf16=True, int8=True, device="cuda", seed=0)
    rgb = torch.randn(4, 2, 256, 256, 3, generator=gen, device="cuda")
    pred.calibrate([rgb + 0.1 * torch.randn(rgb.shape, generator=gen,
                                            device="cuda")
                    for _ in range(2)])

    def run():
        before = launch_counts()
        pose = pred(rgb)
        after = launch_counts()
        with torch.no_grad():
            stack = pred._heatmap_stack(rgb)
        return pose, stack, [after[k] - before[k]
                             for k in ("int8_pack", "int8_epilogue")]
    pose, stack, launches = run()
    assert launches == [72, 78]
    plain_int8(monkeypatch)
    plain_pose, plain_stack, plain_launches = run()
    assert plain_launches == [0, 0]
    assert torch.equal(stack, plain_stack)
    assert (pose == plain_pose).all()


@pytest.mark.parametrize("calibrated", [True, False])
def test_int8_pack_sharded_predictor_bit_for_bit(gen, monkeypatch,
                                                 calibrated):
    """The r18 int8 `Predictor` with its Grid-ViT split over two model
    shards on the card (`parallel/tp.py`), with static scales and with
    dynamic ones (each row-parallel product's the max over its shards):
    the pose with kernel F equals that of the plain sequence in its place,
    bit for bit; a calibrated request launches F's pack 78 times and its
    epilogue 90 (`test_int8_sharded_lifter_launches`), the plain run
    neither."""
    from egotap_tpu_torch.serving import Predictor
    pred = Predictor(bf16=True, int8=True, device="cuda", seed=0)
    rgb = torch.randn(4, 2, 256, 256, 3, generator=gen, device="cuda")
    if calibrated:
        pred.calibrate([rgb + 0.1 * torch.randn(rgb.shape, generator=gen,
                                                device="cuda")
                        for _ in range(2)])
    pred.shard(1, num_model=2, devices=[torch.device("cuda", 0)] * 2)

    def run():
        before = launch_counts()
        pose = pred(rgb)
        after = launch_counts()
        return pose, [after[k] - before[k]
                      for k in ("int8_pack", "int8_epilogue")]
    pose, launches = run()
    if calibrated:
        assert launches == [78, 90]
    assert min(launches) > 0
    plain_int8(monkeypatch)
    plain_pose, plain_launches = run()
    assert plain_launches == [0, 0]
    assert (pose == plain_pose).all()
