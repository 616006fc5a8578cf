"""What the kernel wrappers of kernels A, B, C and D check and pass on
before they launch, on the CPU: the libraries are replaced by a recorder
and the tensors live on the ``meta`` device (no data, but not the CPU, so
the wrappers take their kernel path), so no kernel runs. The kernels
themselves are held to their plain versions on the card
(`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`)."""

import pytest
import torch

from egotap_tpu_torch.ops import _build
from egotap_tpu_torch.ops import attention as att
from egotap_tpu_torch.ops import fused_layer1 as fl
from egotap_tpu_torch.ops import pu_kernel
from egotap_tpu_torch.ops import upsample as up
from tests.test_torch_attention_launch import FakeLibrary

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

    def egotap_fused_layer1(self, *args):
        self.calls.append(("fused_layer1", args))
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
            "fused_layer1"]
DIFFERENTIABLE = ["attention", "attention_unpacked", "pu_chain"]


@pytest.mark.parametrize("which", ["upsample", "fused_layer1"])
def test_refuses_inputs_that_require_grad(fake, which):
    """Kernels A and D have no backward: with grad mode on, an input that
    requires grad is refused before anything launches (an output with no
    grad_fn would drop the gradient without a word)."""
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
    """Kernels B and C are the forward of an autograd function: with an
    input that requires grad they launch once, counted once, and return
    an output whose grad_fn is that function (its backward recomputes
    the plain version, `tests/test_torch_grad.py`)."""
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
        kernel = "_KernelC" if which == "pu_chain" else "_KernelB"
        assert f"{kernel}Backward" in names


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
