"""What the kernel wrappers of kernels A to F check and pass on
before they launch, on the CPU: the libraries are replaced by a recorder
and the tensors live on the ``meta`` device (no data, but not the CPU, so
the wrappers take their kernel path), so no kernel runs. The kernels
themselves are held to their plain versions on the card
(`tests/test_torch_kernels_cuda.py`)."""

import contextlib
from unittest import mock

import pytest
import torch

from egotap_tpu_torch.ops import (_build, attention_launches_by_heads,
                                  launch_counts)
from egotap_tpu_torch.models import resnet
from egotap_tpu_torch.ops import attention as att
from egotap_tpu_torch.ops import bn_act as E
from egotap_tpu_torch.ops import fused_layer1 as fl
from egotap_tpu_torch.ops import int8_pack as F8
from egotap_tpu_torch.ops import pu_kernel, quant
from egotap_tpu_torch.ops import upsample as up
from test_torch_attention_launch import FakeLibrary

H100 = (132, 232448)             # SMs, shared memory a block may opt in to


class Recorder(FakeLibrary):
    """Stands in for every kernel library: records each launch by name."""

    def egotap_attention_packed(self, *args):
        self.calls.append(("attention", args))
        return 0

    def egotap_upsample2x(self, *args):
        self.calls.append(("upsample", args))
        return 0

    def egotap_pu_chain(self, *args):
        self.calls.append(("pu_chain", args))
        return 0

    def egotap_pu_chain_save(self, *args):        # the training forward
        self.calls.append(("pu_chain", args))
        return 0

    def egotap_pu_chain_backward(self, *args):
        self.calls.append(("pu_chain_backward", args))
        return 0

    def egotap_fused_layer1(self, *args):
        self.calls.append(("fused_layer1", args))
        return 0

    def egotap_bn_act(self, *args):
        self.calls.append(("bn_act", args))
        return 0

    def egotap_int8_pack(self, *args):
        self.calls.append(("int8_pack", args))
        return 0

    def egotap_int8_epilogue(self, *args):
        self.calls.append(("int8_epilogue", args))
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = Recorder()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda tensor: 0)
    monkeypatch.setattr(pu_kernel, "_card", lambda device: H100)
    return lib


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@contextlib.contextmanager
def recording():
    """`fake` outside a test: while the block runs, every kernel library is
    a `Recorder` (yielded) and the card an H100."""
    lib = Recorder()
    with mock.patch.object(_build, "library", lambda name: lib), \
            mock.patch.object(_build, "stream_ptr", lambda tensor: 0), \
            mock.patch.object(pu_kernel, "_card", lambda device: H100):
        yield lib


def _int8_nets(batch: int = 32, **overrides):
    """The int8 serving nets of `serving_config(**overrides)` on the meta
    device, in eval mode with static scales and their int8 weights, and
    an rgb batch of ``batch`` for them."""
    from egotap_tpu_torch.ops.quant import Calibrated, prequantize
    from egotap_tpu_torch.serving import build_nets, serving_config
    cfg = serving_config(**overrides)
    with torch.device("meta"):
        nets = build_nets(cfg, True, True)
    for net in nets:
        net.eval().requires_grad_(False)
        for m in net.modules():
            if isinstance(m, Calibrated):
                m.a_scale = _meta()
    prequantize(nets)
    return nets, _meta(batch, cfg.views, 256, 256, 3)


def int8_serving_products(batch: int = 32, **overrides) -> dict:
    """The int8 products of one bf16 int8 serving forward of
    `serving_config(**overrides)` at ``batch`` (static scales), as kernel
    F launches them, read on the meta device: {(x's NHWC shape, kernel,
    stride, padding, N): [products, packs]}, in the order of their first
    launch. A product that takes a `QuantStub`'s codes packs nothing; the
    stub's pack counts with the first product after it."""
    from egotap_tpu_torch.serving import pose_forward
    nets, rgb = _int8_nets(batch, **overrides)
    with recording() as lib, torch.no_grad():
        pose_forward(nets, rgb, torch.bfloat16)
    products, packed, fresh = {}, None, False
    for name, args in lib.calls:
        if name == "int8_pack":
            n, h, w, c, kernel, stride, padding = args[3:10]
            packed, fresh = ((n, h, w, c), kernel, stride, padding), True
        elif name == "int8_epilogue":
            counts = products.setdefault(packed + (args[6],), [0, 0])
            counts[0] += 1
            counts[1] += fresh
            fresh = False
    return products


def _pu_args(b=2, j=3, h=32, dtype=torch.bfloat16):
    cell1 = {n: {"kernel": _meta(h, m, dtype=dtype), "bias": _meta(m)}
             for n, m in (("x2f", h), ("x2h", 4 * h), ("h2h", 4 * h))}
    return [_meta(b, j, h), _meta(b, j, 4 * h), _meta(h, 4 * h, dtype=dtype),
            cell1]


def _layer1_args(n_convs=4):
    """w_q, w_scale, bias as `pack_blocks` gives them (w_q is int8 and
    cannot require grad)."""
    return [_meta(n_convs, 9 * 64, 64, dtype=torch.int8),
            _meta(n_convs, 64), _meta(n_convs, 64)]


def _bn(c, device="meta"):
    """An eval-mode BatchNorm2d of c channels whose parameters require no
    grad (a frozen or served net's)."""
    return torch.nn.BatchNorm2d(c, device=device).eval().requires_grad_(False)


def _call(which):
    """(wrapper, its inputs that may require grad, a call of it)."""
    if which in ("attention", "attention_unpacked"):
        shape = (1, 8, 256) if which == "attention" else (1, 2, 8, 128)
        qkv = [_meta(*shape, dtype=torch.bfloat16) for _ in range(3)]
        if which == "attention":
            return (att.multihead_attention_packed, qkv,
                    lambda: att.multihead_attention_packed(*qkv, 2))
        return (att.multihead_attention, qkv,
                lambda: att.multihead_attention(*qkv))
    if which == "upsample":
        x = _meta(1, 4, 4, 8, dtype=torch.bfloat16)
        return (up.upsample2x_align_corners, [x],
                lambda: up.upsample2x_align_corners(x))
    if which == "bn_act":
        x, r = (_meta(2, 4, 4, 64, dtype=torch.bfloat16) for _ in range(2))
        bn, bn_r = _bn(64), _bn(64)
        return E.bn_act, [x, r], lambda: E.bn_act(x, bn, r, bn_r)
    if which == "fused_layer1":
        x = _meta(2, 8, 8, 64, dtype=torch.bfloat16)
        packed = _layer1_args()
        return (fl.fused_layer1_int8, [x, *packed[1:]],
                lambda: fl.fused_layer1_int8(x, *packed))
    args = _pu_args()
    leaves = args[:3] + [t for c in args[3].values() for t in c.values()]
    return (pu_kernel.pu_chain_fused, leaves,
            lambda: pu_kernel.pu_chain_fused(*args))


WRAPPERS = ["attention", "attention_unpacked", "upsample", "pu_chain",
            "fused_layer1", "bn_act"]
DIFFERENTIABLE = ["attention", "attention_unpacked", "upsample", "pu_chain",
                  "bn_act"]
KERNEL_FUNCTION = {"attention": "_KernelB", "attention_unpacked": "_KernelB",
                   "upsample": "_KernelA", "pu_chain": "_KernelC",
                   "bn_act": "_KernelE"}


@pytest.mark.parametrize("which", ["fused_layer1"])
def test_refuses_inputs_that_require_grad(fake, which):
    """Kernel D (int8 inference) has no backward: with grad mode on, an
    input that requires grad is refused before anything launches (an
    output with no grad_fn would drop the gradient without a word)."""
    wrapper, leaves, call = _call(which)
    before = wrapper.launches
    for leaf in leaves:
        leaf.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        leaf.requires_grad_(False)
    assert not fake.calls and wrapper.launches == before


@pytest.mark.parametrize("which", DIFFERENTIABLE)
def test_launches_under_grad(fake, which):
    """Kernels A, B, C and E are the forward of an autograd function: with
    an input that requires grad they launch once, counted once, and
    return an output whose grad_fn is that function (its backward:
    `tests/test_torch_grad.py`; E's below)."""
    wrapper, leaves, call = _call(which)
    for leaf in leaves:
        before = wrapper.launches
        fake.calls.clear()
        leaf.requires_grad_(True)
        out = call()
        leaf.requires_grad_(False)
        library = "attention" if which.startswith("attention") else which
        assert [name for name, _ in fake.calls] == [library]
        assert wrapper.launches == before + 1
        fn = out.grad_fn                 # the function, or a view of it
        names = {type(fn).__name__} | {type(f).__name__ for f, _ in
                                       fn.next_functions if f is not None}
        assert f"{KERNEL_FUNCTION[which]}Backward" in names


@pytest.mark.parametrize("which", WRAPPERS)
def test_launches_under_no_grad(fake, which):
    """The same inputs launch under no_grad, and with grad mode on when
    none of them requires grad; each launch is counted once."""
    wrapper, leaves, call = _call(which)
    before = wrapper.launches
    for leaf in leaves:
        leaf.requires_grad_(True)
    with torch.no_grad():
        call()
    for leaf in leaves:
        leaf.requires_grad_(False)
    call()
    library = "attention" if which.startswith("attention") else which
    assert [name for name, _ in fake.calls] == [library, library]
    assert wrapper.launches == before + 2


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("h,units,hp", [(512, 4, 512), (128, 1, 128),
                                        (264, 2, 272)])
def test_pu_chain_launch_arguments(fake, dtype, code, h, units, hp):
    """B, J, H, H padded to 16, the weights' row pitch (H: a row of 264
    values is a whole number of 16 bytes in both dtypes), the units a
    block (the smallest slice with at most one block an SM), the dtype
    code, and no barrier-only walk."""
    pu_kernel.pu_chain_fused(*_pu_args(b=5, j=7, h=h, dtype=dtype))
    ((name, args),) = fake.calls
    assert args[12:] == (5, 7, h, hp, h, units, code, 0, 0)


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_pu_chain_training_forward_writes_states(fake, dtype, code):
    """With a gradient wanted, kernel C's forward goes through the
    library's saving entry point with a (12, B, J, H) f32 states buffer
    after the counter and the same geometry; under no_grad, through the
    serving entry point with the serving arguments."""
    args = _pu_args(b=5, j=7, h=264, dtype=dtype)
    args[2].requires_grad_(True)
    with torch.no_grad():
        pu_kernel.pu_chain_fused(*args)
    pu_kernel.pu_chain_fused(*args)
    (_, serving), (_, training) = fake.calls
    assert serving[12:] == (5, 7, 264, 272, 264, 2, code, 0, 0)
    assert len(training) == 21 and training[13:] == (5, 7, 264, 272, 264, 2,
                                                      code, 0)


@pytest.mark.parametrize("need", ["all", "w0", "fh"])
@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
def test_pu_chain_backward_launches_reverse_walk(fake, dtype, code, need):
    """Kernel C's backward on a non-CPU tensor is one launch of the
    reverse walk (counted in `backward_launches`, never `plain_vjp`),
    with the forward's geometry, then the weight products: a gradient
    for each input that requires one, in its dtype and shape, none for
    the others."""
    b, j, h = 5, 7, 264
    args = _pu_args(b=b, j=j, h=h, dtype=dtype)
    leaves = args[:3] + [args[3][n][leaf] for n, leaf in pu_kernel._CELL1]
    wanted = {"all": leaves, "w0": [args[2]], "fh": [args[0]]}[need]
    for t in wanted:
        t.requires_grad_(True)
    out = pu_kernel.pu_chain_fused(*args)
    before = pu_kernel.pu_chain_fused.backward_launches
    grads = torch.autograd.grad(out, wanted, _meta(b, j, h))
    assert pu_kernel.pu_chain_fused.backward_launches == before + 1
    (name, launch), = [c for c in fake.calls if c[0] == "pu_chain_backward"]
    assert launch[15:] == (b, j, h, 272, h, 2, code, 0)
    for g, t in zip(grads, wanted):
        assert g.shape == t.shape and g.dtype == t.dtype


def test_pu_chain_refusals_launch_nothing(fake):
    with pytest.raises(NotImplementedError):                 # float16
        pu_kernel.pu_chain_fused(*_pu_args(dtype=torch.float16))
    with pytest.raises(ValueError):                          # mixed dtypes
        args = _pu_args()
        args[3]["h2h"]["kernel"] = args[3]["h2h"]["kernel"].float()
        pu_kernel.pu_chain_fused(*args)
    # H = 137 is prime and above 132 SMs: one block would hold all 13H
    # rows of weights, far beyond its shared memory
    with pytest.raises(NotImplementedError, match="do not fit"):
        pu_kernel.pu_chain_fused(*_pu_args(h=137, dtype=torch.float32))
    assert not fake.calls


def test_attention_launches_counted_by_heads(fake):
    """Kernel B's packed launches are counted by head count beside their
    total (a tensor-parallel shard runs fewer heads); the plain CPU
    version counts nothing, and a reset clears both."""
    launch_counts(reset=True)
    for heads in (2, 4, 2):
        att.multihead_attention_packed(
            *(_meta(1, 8, heads * 128) for _ in range(3)), heads)
    att.multihead_attention_packed(*(torch.zeros(1, 8, 256)
                                     for _ in range(3)), 2)
    assert len(fake.calls) == 3
    assert attention_launches_by_heads() == {2: 2, 4: 1}
    assert launch_counts()["attention"] == 3
    launch_counts(reset=True)
    assert attention_launches_by_heads() == {}


def test_barrier_walk_is_not_counted(fake):
    before = pu_kernel.pu_chain_fused.launches
    pu_kernel.barrier_walk(32, 15, 512, torch.bfloat16, "meta")
    ((name, args),) = fake.calls
    assert args[12:20] == (32, 15, 512, 512, 512, 4, 1, 1)
    assert pu_kernel.pu_chain_fused.launches == before


@pytest.mark.parametrize("dtype,pitch", [(torch.float32, 36),
                                         (torch.bfloat16, 48)])
def test_weight_rows(dtype, pitch):
    """An (in, out) kernel reaches kernel C as its (out, in) rows: the
    transposed view of a Linear weight as it is, with no copy; rows of
    H = 36 bf16 values (72 bytes) zero-padded to 48 for 16-byte copies."""
    g = torch.Generator().manual_seed(0)
    weight = torch.randn(4 * 36, 36, generator=g).to(dtype)   # (out, in)
    rows = pu_kernel.weight_rows(weight.t())
    assert rows.shape == (4 * 36, pitch)
    assert torch.equal(rows[:, :36], weight) and not rows[:, 36:].any()
    if pitch == 36:
        assert rows.data_ptr() == weight.data_ptr()


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("shape", [(32, 8, 8, 1024), (32, 32, 32, 512),
                                   (2, 3, 1, 5, 64)])
def test_upsample_launch_arguments(fake, dtype, code, shape):
    """Leading dims folded into N, then H, W, C, the dtype code and
    `launch_geometry`'s band, channel vectors and staged rows; the tap
    tables of H and W are passed as device pointers."""
    x = _meta(*shape, dtype=dtype)
    out = up.upsample2x_align_corners(x)
    assert out.shape == shape[:-3] + (2 * shape[-3], 2 * shape[-2],
                                      shape[-1])
    ((name, args),) = fake.calls
    h, w, c = shape[-3:]
    n = x.numel() // (h * w * c)
    geo = up.launch_geometry(n, h, w, c, dtype)
    assert args[4:12] == (n, h, w, c, code, geo["band"], geo["cv"],
                          geo["staged"])


def test_upsample_refusals_launch_nothing(fake):
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        up.upsample2x_align_corners(_meta(1, 4, 4, 12, dtype=torch.bfloat16))
    with pytest.raises(NotImplementedError, match="2\\^31"):
        up.upsample2x_align_corners(_meta(1, 1024, 1024, 512))
    with pytest.raises(NotImplementedError):                 # float16
        up.upsample2x_align_corners(_meta(1, 4, 4, 8, dtype=torch.float16))
    assert not fake.calls


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("shape,geometry", [
    ((64, 64, 64, 64), (256, 16, 6)), ((3, 16, 16, 64), (32, 8, 4)),
    ((2, 20, 12, 64), (32, 8, 6)), ((1, 50, 30, 64), (96, 16, 6))])
def test_fused_layer1_launch_arguments(fake, dtype, code, shape, geometry):
    """N, H, W, `cluster_geometry`'s pixels a block, blocks a cluster and
    tile rows, the conv count and the dtype code; the weights reach the
    kernel as `kernel_weights`' rows, made at the first call and kept."""
    x = _meta(*shape, dtype=dtype)
    packed = _layer1_args(n_convs=6)
    fl.fused_layer1_int8(x, *packed)
    fl.fused_layer1_int8(x, *packed)
    (_, first), (_, second) = fake.calls
    n, h, w, _ = shape
    assert first[5:13] == (n, h, w, *geometry, 6, code)
    assert second == first
    assert packed[0]._kernel_rows[1].shape == (6, 64, fl.WPITCH)


def test_fused_layer1_refusals_launch_nothing(fake):
    packed = _layer1_args()
    with pytest.raises(NotImplementedError, match="4096"):   # off chip
        fl.fused_layer1_int8(_meta(1, 65, 64, 64), *packed)
    with pytest.raises(NotImplementedError):                 # C != 64
        fl.fused_layer1_int8(_meta(1, 8, 8, 32), *packed)
    with pytest.raises(ValueError):                          # odd convs
        fl.fused_layer1_int8(_meta(1, 8, 8, 64), *_layer1_args(n_convs=3))
    assert not fake.calls


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bn_act_launch_arguments(fake, dtype, code, mode):
    """Kernel E gets x, the residual (None without one), the output, the
    four vectors of each BatchNorm (None for a residual without one), the
    element count, C, the dtype code, the residual form (0 none, 1 the
    block input, 2 through its own BatchNorm) and eps, and returns an
    output of x's shape and dtype."""
    x, r = (_meta(2, 3, 5, 128, dtype=dtype) for _ in range(2))
    residual = r if mode else None
    residual_bn = _bn(128) if mode == 2 else None
    out = E.bn_act(x, _bn(128), residual, residual_bn)
    assert out.shape == x.shape and out.dtype == dtype
    ((name, args),) = fake.calls
    assert name == "bn_act" and len(args) == 17
    assert args[1] is (None if mode == 0 else 0)
    assert (args[7] is None) == (mode != 2)
    assert args[11:16] == (x.numel(), 128, code, mode, E.BN_EPS)


def test_bn_act_copies_what_it_cannot_read(fake):
    """Kernel E takes a non-contiguous x or residual as a contiguous copy
    (as kernel A does) and launches on it; each launch counts in
    ``launch_counts()["bn_act"]``, as the other kernels' do."""
    bn = _bn(64)
    x = _meta(2, 4, 4, 64, dtype=torch.bfloat16)
    before = launch_counts()["bn_act"]
    out = E.bn_act(x.transpose(1, 2), bn)
    E.bn_act(x, bn, x.transpose(1, 2))
    assert out.is_contiguous() and out.shape == (2, 4, 4, 64)
    assert launch_counts()["bn_act"] == before + 2
    assert [name for name, _ in fake.calls] == ["bn_act", "bn_act"]


def test_bn_act_refusals_launch_nothing(fake):
    """Off the CPU `bn_act` raises for what kernel E does not cover, and
    runs no plain sequence in its place: C not a multiple of the vector
    or not the BatchNorm's, float16 and float64, a residual of another
    shape, BatchNorm vectors in another dtype or on another device."""
    x = _meta(2, 4, 4, 64)
    before = E.bn_act.launches
    cases = [(_meta(2, 4, 4, 12, dtype=torch.bfloat16), _bn(12), {},
              "multiple of 8"),
             (x, _bn(32), {}, "not f32 \\(64,\\)"),
             (x.half(), _bn(64), {}, "dtype"),
             (x.double(), _bn(64), {}, "dtype"),
             (x, _bn(64), {"residual": _meta(2, 4, 4, 128)}, "residual"),
             (x, _bn(64).double(), {}, "not f32"),
             (x, _bn(64, "cpu"), {}, "on cpu")]
    for inp, norm, kw, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            E.bn_act(inp, norm, **kw)
    assert not fake.calls and E.bn_act.launches == before


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_bn_act_backward_is_the_plain_sequences(monkeypatch, mode):
    """With a gradient asked for, `bn_act` is the forward of `_KernelE`
    (here its launch played by the plain sequence): the gradients of x,
    the residual and both BatchNorms' weight and bias are autograd's over
    `bn_act_plain`, bit for bit; the running statistics get none."""
    monkeypatch.setattr(E, "_launch",
                        lambda x, r, vectors: E._plain(x, r, *vectors))
    g = torch.Generator().manual_seed(mode)
    bn, bn_r = (torch.nn.BatchNorm2d(16).eval() for _ in range(2))
    for norm in (bn, bn_r):
        for t in E.stats(norm):
            t.data = torch.rand(16, generator=g) + 0.5
    x, r = (torch.randn(2, 3, 3, 16, generator=g, requires_grad=True)
            for _ in range(2))
    r = r if mode else None
    bn_r = bn_r if mode == 2 else None
    vectors = E.stats(bn) + (E.stats(bn_r) if mode == 2 else ())
    leaves = [x, bn.weight, bn.bias] + ([r] if mode else []) + (
        [bn_r.weight, bn_r.bias] if mode == 2 else [])
    out = E._KernelE.apply(x, r, *vectors)
    assert type(out.grad_fn).__name__ == "_KernelEBackward"
    got = torch.autograd.grad(out.square().sum(), leaves)
    want = torch.autograd.grad(
        E.bn_act_plain(x, bn, r, bn_r).square().sum(), leaves)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("model,fused,blocks,downsamples", [
    ("resnet18", 17, 8, 3), ("resnet50", 49, 16, 4)])
def test_bn_act_trunk_sites(fake, model, fused, blocks, downsamples):
    """Every BatchNorm site of an eval trunk (the stem; conv1 and conv2 of
    a basic block, conv1 to conv3 of a bottleneck; a downsample's
    BatchNorm inside its block's last call) is one kernel E launch: 17 a
    resnet18 trunk, 49 a resnet50 one, in the residual forms its blocks
    have; a trunk in training mode calls none."""
    with torch.device("meta"):
        net = resnet.ResNetEncoder(model).eval().requires_grad_(False)
    x = _meta(2, 64, 64, 3, dtype=torch.bfloat16)
    before = launch_counts()["bn_act"]
    net(x)
    assert launch_counts()["bn_act"] == before + fused
    modes = [args[14] for _, args in fake.calls]
    assert modes.count(2) == downsamples
    assert modes.count(1) == blocks - downsamples
    fake.calls.clear()
    net.train()
    net(x)
    assert not fake.calls


def test_eval_trunk_on_cpu_is_the_plain_sequence():
    """On the CPU the eval trunk takes the plain sequence and launches
    nothing: a block with a downsample equals the steps written out
    (BatchNorm, ReLU; BatchNorm plus the downsample's BatchNorm, ReLU)."""
    g = torch.Generator().manual_seed(0)
    block = resnet.BasicBlock(64, 128, stride=2).eval()
    for bn in (block.bn1, block.bn2, block.downsample[1]):
        for t in (bn.running_mean, bn.running_var, bn.weight, bn.bias):
            t.data = torch.rand(t.shape, generator=g) + 0.5
    x = torch.randn(2, 8, 8, 64, generator=g).to(torch.bfloat16)
    before = E.bn_act.launches
    with torch.no_grad():
        got = block(x)
    assert E.bn_act.launches == before
    with torch.no_grad():
        out = torch.relu(E.batch_norm_eval(
            resnet.conv_nhwc(x, block.conv1), block.bn1))
        out = E.batch_norm_eval(resnet.conv_nhwc(out, block.conv2), block.bn2)
        identity = E.batch_norm_eval(
            resnet.conv_nhwc(x, block.downsample[0]), block.downsample[1])
        want = torch.relu(out + identity)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("shape,kernel,stride,padding,geometry", [
    ((64, 64, 64, 64), 3, 1, 1, (64, 64, 262144, 576, 16, 56)),
    ((64, 64, 64, 64), 1, 2, 0, (32, 32, 65536, 64, 16, 124)),
    ((32, 16, 16, 1540), 3, 1, 1, (16, 16, 8192, 13864, 4, 1)),
    ((1, 3, 3, 3), 3, 1, 1, (3, 3, 32, 32, 1, 1)),
    ((1, 5, 7, 24), 3, 2, 0, (2, 3, 32, 216, 8, 1))])
def test_int8_pack_launch_arguments(fake, dtype, code, shape, kernel, stride,
                                    padding, geometry):
    """Kernel F's pack gets x, the scale, the rows, then N, H, W, C, the
    kernel, stride and padding, the output grid, the padded rows Mp (32
    when M <= 16) and row length Kp (K up to a multiple of 8), the dtype
    code, `pack_geometry`'s codes a chunk (the widest of 16, 8, 4, 1 that
    C divides) and rows a block (about `TILE` chunks, fewer for a call of
    fewer than `MIN_BLOCKS` such blocks); it returns (Mp, Kp) int8
    rows."""
    x = _meta(*shape, dtype=dtype)
    before = F8.pack.launches
    rows, hw = F8.pack(x, _meta(), kernel, stride, padding)
    ((name, args),) = fake.calls
    assert name == "int8_pack" and F8.pack.launches == before + 1
    assert args[3:10] == (*shape, kernel, stride, padding)
    assert args[10:17] == (*geometry[:4], code, *geometry[4:])
    assert hw == geometry[:2] and rows.shape == geometry[2:4]
    assert rows.dtype == torch.int8


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("m,n,np_,geometry", [
    (262144, 64, 64, (8, 256)), (131072, 30, 32, (2, 136)),
    (8192, 516, 520, (4, 15)), (4, 3, 8, (1, 1))])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_epilogue_launch_arguments(fake, dtype, code, m, n, np_,
                                        geometry, bias):
    """Kernel F's epilogue gets the padded int32 product, the scale, the
    per-output scale, the bias (None without one), the output, M, N, the
    product's row pitch Np, the dtype code and `epilogue_geometry`'s
    outputs a chunk (the widest of 8, 4, 2, 1 that N divides) and rows a
    block; it returns (M, N) in the dtype."""
    acc = _meta(max(m, 32), np_, dtype=torch.int32)
    out = F8.epilogue(acc, m, n, _meta(), _meta(n),
                      _meta(n) if bias else None, dtype)
    ((name, args),) = fake.calls
    assert name == "int8_epilogue"
    assert (args[3] is None) != bias
    assert args[5:11] == (m, n, np_, code, *geometry)
    assert out.shape == (m, n) and out.dtype == dtype


def test_int8_pack_refusals_launch_nothing(fake):
    """Off the CPU kernel F raises for what it does not cover, and runs no
    plain sequence in its place: float16, a scale on another device or
    not f32, x not NHWC, a kernel larger than the padded image, a product
    not int32 or narrower than asked, a scale vector of another size."""
    x, a = _meta(2, 4, 4, 64), _meta()
    acc, w_scale = _meta(32, 64, dtype=torch.int32), _meta(64)
    before = launch_counts()
    cases = [(lambda: F8.pack(x.half(), a), "dtype"),
             (lambda: F8.pack(x, torch.ones(())), "scale"),
             (lambda: F8.pack(x, a.double()), "scale"),
             (lambda: F8.pack(x[0], a), "NHWC"),
             (lambda: F8.pack(x, a, 7, 1, 0), "kernel 7"),
             (lambda: F8.epilogue(acc.long(), 32, 64, a, w_scale, None,
                                  x.dtype), "product"),
             (lambda: F8.epilogue(acc, 33, 64, a, w_scale, None, x.dtype),
              "product"),
             (lambda: F8.epilogue(acc, 32, 64, a, w_scale[:60], None,
                                  x.dtype), "not f32"),
             (lambda: F8.epilogue(acc, 32, 64, a, w_scale, None,
                                  torch.float16), "dtype")]
    for fn, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            fn()
    assert not fake.calls and launch_counts() == before


def _plain_launches(monkeypatch):
    """Kernel F's launches played by its plain twins (on CPU tensors)."""
    monkeypatch.setattr(F8, "pack", F8.pack_plain)
    monkeypatch.setattr(F8, "epilogue", F8.epilogue_plain)


@pytest.mark.parametrize("form", ["conv", "conv_static", "dense",
                                  "dense_pre_q"])
def test_int8_backward_is_the_plain_sequences(monkeypatch, form):
    """With a gradient asked for, kernel F's launches are the forward of
    `_KernelF` (here played by the plain twins): the gradients of x, the
    weight (through its scale, quantized anew as the training mode does)
    and the bias are autograd's over the plain sequence, bit for bit, with
    a dynamic or a static scale, and for codes made beforehand."""
    _plain_launches(monkeypatch)
    g = torch.Generator().manual_seed(len(form))
    conv = form.startswith("conv")
    x = torch.randn((2, 5, 5, 24) if conv else (3, 7, 24), generator=g,
                    requires_grad=True)
    weight = torch.randn((16, 24, 3, 3) if conv else (16, 24), generator=g,
                         requires_grad=True)
    bias = torch.randn(16, generator=g, requires_grad=True)
    a_scale = torch.tensor(0.05) if form == "conv_static" else None
    w_q, w_scale = quant.quantize_weights(weight)
    if conv:
        got = F8.conv(x, w_q, w_scale, 2, 1, bias, a_scale, None)
        want = quant.conv_plain(x, w_q, w_scale, 2, 1, bias, a_scale)
    else:
        pre_q = quant.quantize_activation(x) if form == "dense_pre_q" \
            else None
        got = F8.dense(x, w_q, w_scale, bias, None, pre_q, None)
        want = quant.dense_plain(x, w_q, w_scale, bias, None, pre_q)
    assert type(got.grad_fn).__name__ == "_KernelFBackward"
    assert torch.equal(got, want)
    leaves = [x, weight, bias]
    ct = torch.randn(got.shape, generator=g)
    # the weight's scale is one graph for both: keep it for the second
    for a, b in zip(torch.autograd.grad(got, leaves, ct, retain_graph=True,
                                        allow_unused=True),
                    torch.autograd.grad(want, leaves, ct, allow_unused=True)):
        assert (a is None and b is None) or torch.equal(a, b)


def test_int8_codes_of_a_stub(fake):
    """A `QuantStub` on the card is one pack launch with k = 1, its codes
    in x's shape as `quantize_activation` gives them; the `QDense` after it
    takes them as its rows (no pack) and launches one epilogue."""
    stub, dense = quant.QuantStub(), quant.QDense(24, 16)
    stub.a_scale = dense.a_scale = _meta()
    dense = dense.to("meta").eval().requires_grad_(False)
    dense.prequantize()
    x = _meta(3, 7, 24, dtype=torch.bfloat16)
    xq, a = stub(x)
    assert xq.shape == x.shape and xq.dtype == torch.int8
    out = dense(x, pre_q=(xq, a))
    assert out.shape == (3, 7, 16) and out.dtype == torch.bfloat16
    assert [name for name, _ in fake.calls] == ["int8_pack", "int8_epilogue"]
    assert fake.calls[0][1][3:10] == (21, 1, 1, 24, 1, 1, 0)


def test_int8_forward_launches(fake, monkeypatch):
    """One r18 int8 serving forward (batch 32, static scales) on the card:
    kernel F's epilogue once for each of its 78 int8 products, its pack
    once for each quantized input (72: the Grid-ViT's q, k and v take one
    `QuantStub`'s codes), the weights' rows laid out in the first forward
    and none in the next."""
    from egotap_tpu_torch.serving import pose_forward
    nets, rgb = _int8_nets()
    laid_out = []
    rows = F8.weight_rows
    monkeypatch.setattr(F8, "weight_rows",
                        lambda wq: laid_out.append(wq) or rows(wq))
    with torch.no_grad():
        pose_forward(nets, rgb, torch.bfloat16)
        first = len(laid_out)
        launch_counts(reset=True)
        pose = pose_forward(nets, rgb, torch.bfloat16)
    counts = launch_counts()
    assert pose.shape == (32, 16, 3)
    assert (counts["int8_pack"], counts["int8_epilogue"]) == (72, 78)
    assert first == 78 and len(laid_out) == first      # one a product
    names = [name for name, _ in fake.calls]
    assert names.count("int8_epilogue") == 2 * 78
    assert counts["upsample"] == 6 and counts["bn_act"] == 2


def test_int8_sharded_lifter_launches(fake, monkeypatch):
    """The lifter's Grid-ViT split over two model shards
    (`parallel/tp.py`) runs its int8 products on kernel F, as the unsplit
    lifter does, and no step of the plain sequence: a block packs its
    `QuantStub`'s input and its MLP's input once, each row-parallel
    product's input once on each shard, and launches an epilogue for each
    column part and one for each row-parallel sum; over the 3 blocks that
    is 2 packs and 4 epilogues a block more than the unsplit 72 and 78."""
    from egotap_tpu_torch.parallel.tp import shard_lifter
    from egotap_tpu_torch.serving import pose_forward
    nets, rgb = _int8_nets()

    def refuse(*args, **kwargs):
        raise AssertionError("the plain sequence ran on the card")
    with torch.no_grad():
        lifter = shard_lifter(nets[2], [torch.device("meta")] * 2)
        for name in ("quantize_activation", "im2col", "int8_matmul",
                     "dequantize"):
            monkeypatch.setattr(quant, name, refuse)
        launch_counts(reset=True)
        pose = pose_forward((*nets[:2], lifter), rgb, torch.bfloat16)
    counts = launch_counts()
    assert pose.shape == (32, 16, 3)
    assert (counts["int8_pack"], counts["int8_epilogue"]) \
        == (72 + 2 * 3, 78 + 4 * 3)
    assert counts["attention"] == 2 * 3


def test_int8_dense_sum_launches(fake):
    """`int8_pack.dense_sum` off the CPU: a pack of (M, 1, 1, K_i) and a
    product on each device, one epilogue of the (Mp, Np) int32 sum; on
    the CPU the plain sequence, no launch."""
    xs = [_meta(2, 9, 16, dtype=torch.bfloat16) for _ in range(2)]
    w_qs = [_meta(12, 16, dtype=torch.int8) for _ in range(2)]
    rows = [F8.weight_rows(w) for w in w_qs]
    out = F8.dense_sum(xs, _meta(), w_qs, rows, _meta(12), _meta(12))
    assert out.shape == (2, 9, 12) and out.dtype == torch.bfloat16
    assert [name for name, _ in fake.calls] \
        == ["int8_pack", "int8_pack", "int8_epilogue"]
    assert fake.calls[0][1][3:10] == (18, 1, 1, 16, 1, 1, 0)
    assert fake.calls[2][1][5:8] == (18, 12, 16)        # m, n, Np
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(2, 9, 16, generator=g) for _ in range(2)]
    w_qs = [quant.quantize_weights(torch.randn(12, 16, generator=g))[0]
            for _ in range(2)]
    a, w_scale = torch.tensor(0.02), torch.rand(12, generator=g)
    fake.calls.clear()
    got = F8.dense_sum(xs, a, w_qs, [None, None], w_scale, None)
    want = F8.dense_sum_plain(xs, a, w_qs, w_scale, None)
    assert not fake.calls and torch.equal(got, want)


def test_int8_serving_products():
    """`int8_serving_products`, the list of shapes that the card tests and
    `chip_smoke.py` hold kernel F to: the r18 forward's 78 products and 72
    packs in 26 shapes, the Grid-ViT's at 18432 rows, the decoder's
    concatenated inputs (C = 1540, 1280, 640)."""
    products = int8_serving_products()
    assert len(products) == 26
    assert [sum(c[i] for c in products.values()) for i in (0, 1)] == [78, 72]
    assert products[((18432, 1, 1, 1024), 1, 1, 0, 1024)] == [12, 6]
    assert {key[0][-1] for key in products} >= {1540, 1280, 640}


def test_int8_on_cpu_is_the_plain_sequence(fake):
    """On the CPU the int8 modules take the plain sequence and launch
    nothing."""
    g = torch.Generator().manual_seed(0)
    conv = quant.QConv(64, 8, 3, padding=1).eval()
    conv.a_scale = torch.tensor(0.02)
    x = torch.randn(2, 4, 4, 64, generator=g)
    before = launch_counts()
    with torch.no_grad():
        got = conv(x)
        want = quant.conv_plain(x, conv.w_q, conv.w_scale, 1, 1, conv.bias,
                                conv.a_scale)
    assert torch.equal(got, want)
    assert not fake.calls and launch_counts() == before
