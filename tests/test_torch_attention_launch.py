"""What `ops/attention.py` checks and passes on before kernel B launches,
on the CPU: the library is replaced by a recorder, so no kernel runs. The
kernel itself is held to its plain version on the card
(`tests/test_torch_kernels_cuda.py`)."""

import pytest
import torch

from egotap_tpu_torch.ops import _build
from egotap_tpu_torch.ops import attention as att


# what the runtime reports for each kernel, by dtype code
INFO = {0: (2, 212, 0, 114688, 128), 1: (3, 168, 0, 66560, 128)}


class FakeLibrary:
    """Stands in for the built ``attention`` library: records the calls."""

    def __init__(self):
        self.calls = []

    def egotap_attention_packed(self, *args):
        self.calls.append(args)
        return 0

    def egotap_attention_occupancy(self, dtype, address):
        import ctypes
        out = (ctypes.c_int * 5).from_address(address)
        out[:] = INFO[dtype]
        return 0


@pytest.fixture
def fake(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(_build, "library", lambda name: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda tensor: 0)
    return lib


def _qkv(b, s, heads, dtype):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(b, s, heads * att.HEAD_DIM, generator=g).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("dtype,code", [(torch.float32, 0),
                                        (torch.bfloat16, 1)])
@pytest.mark.parametrize("s", [1, 576, 640, 641, 4096])
def test_takes_any_sequence_length(fake, s, dtype, code):
    """Neither kernel keeps a score tile in shared memory: no limit on S
    (the f32 kernel took at most 640 before it went to one pass)."""
    q, k, v = _qkv(1, s, 2, dtype)
    out = att._launch(q, k, v, 2)
    assert out.shape == q.shape and out.dtype == dtype
    (args,) = fake.calls
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[3] == out.data_ptr()
    assert args[4:9] == (1, s, 2, att.HEAD_DIM, code)   # b, s, heads, Dh, dtype


def test_refusals_launch_nothing(fake):
    q, k, v = _qkv(1, 8, 2, torch.bfloat16)
    with pytest.raises(NotImplementedError):            # head width 64
        att._launch(q, k, v, 4)
    with pytest.raises(NotImplementedError):            # S = 0
        att._launch(q[:, :0], k[:, :0], v[:, :0], 2)
    with pytest.raises(NotImplementedError):            # float16
        att._launch(q.half(), k.half(), v.half(), 2)
    with pytest.raises(ValueError):                     # mixed dtypes
        att._launch(q, k.float(), v, 2)
    assert not fake.calls


def test_launch_makes_operands_contiguous(fake):
    q, k, v = _qkv(2, 16, 2, torch.bfloat16)
    qt = q.transpose(0, 1).contiguous().transpose(0, 1)  # same values, strided
    assert not qt.is_contiguous()
    att._launch(qt, k, v, 2)
    assert fake.calls[0][0] != qt.data_ptr()             # a contiguous copy
    assert fake.calls[0][1:3] == (k.data_ptr(), v.data_ptr())


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN1a20attention_f32_kernelEPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN1a20attention_f32_kernelEPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 212 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN1a21attention_bf16_kernelEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN1a21attention_bf16_kernelEPK13__nv_bfloat16
    16 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes cumulative stack size
"""


@pytest.mark.parametrize("dtype,want", [
    (torch.float32, {"registers": 212, "spill_store_bytes": 0,
                     "spill_load_bytes": 0, "static_smem_bytes": 0,
                     "blocks_per_sm": 2, "runtime_registers": 212,
                     "local_bytes": 0, "smem_bytes": 114688,
                     "threads": 128}),
    (torch.bfloat16, {"registers": 168, "spill_store_bytes": 16,
                      "spill_load_bytes": 24, "static_smem_bytes": 0,
                      "blocks_per_sm": 3, "runtime_registers": 168,
                      "local_bytes": 0, "smem_bytes": 66560,
                      "threads": 128}),
])
def test_kernel_resources_reads_log_and_runtime(fake, monkeypatch, dtype,
                                                want):
    """Each dtype reads its own kernel's entry of the log and asks the
    runtime about its own kernel."""
    monkeypatch.setattr(_build, "build_log", lambda name: PTXAS_LOG)
    assert att.kernel_resources(dtype) == want
    monkeypatch.setattr(_build, "build_log", lambda name: "no kernels here")
    with pytest.raises(RuntimeError):
        att.kernel_resources(dtype)


def _tf32(x, ties=0x1000):
    """x rounded to TF32 (10 mantissa bits): to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``; ``ties=0`` truncates, as the tensor
    cores read an f32 register given as a TF32 operand."""
    return ((x.contiguous().view(torch.int32) + ties) & -0x2000
            ).view(torch.float32)


def _tf32_once(a, b):
    """a @ b with each operand rounded to TF32 once (1xTF32)."""
    return _tf32(a) @ _tf32(b)


def _3xtf32(a, b):
    """a @ b in 3xTF32 as the f32 kernel runs it: x = big + small, big
    rounded to TF32, small = x - big read truncated; small.big +
    big.small + big.big."""
    ab, bb = _tf32(a), _tf32(b)
    sa, sb = _tf32(a - ab, ties=0), _tf32(b - bb, ties=0)
    return sa @ bb + ab @ sb + ab @ bb


def _online_softmax_f32(q, k, v, heads, product=torch.matmul, rescale=True):
    """Kernel B's f32 order of operations on (B, S, H*Dh), in torch f32:
    scores of 64-key chunks times the scale, a running row max m and sum
    l, the context and l scaled by exp(m_old - m_new) when the max moves,
    p = exp(s - m_new) unnormalised into p v, one division by l at the
    end. ``product`` computes both matrix products; ``rescale=False`` is
    the fault of leaving the context and l unscaled."""
    b, s, d = q.shape
    hd = d // heads

    def split(x):
        return x.reshape(b, s, heads, hd).transpose(1, 2)
    qh, kh, vh = split(q), split(k), split(v)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    m = torch.full((b, heads, s, 1), float("-inf"))
    l = torch.zeros(b, heads, s, 1)
    o = torch.zeros(b, heads, s, hd)
    for k0 in range(0, s, 64):
        scores = product(qh, kh[:, :, k0:k0 + 64].transpose(-1, -2)) * scale
        mn = torch.maximum(m, scores.amax(-1, keepdim=True))
        alpha = torch.exp(m - mn) if rescale else torch.ones_like(m)
        p = torch.exp(scores - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + product(p, vh[:, :, k0:k0 + 64])
        m = mn
    return (o / l).transpose(1, 2).reshape(b, s, d)


def test_f32_online_order_is_within_tol():
    """The f32 kernel's order of operations (one pass with the online
    softmax, every product in 3xTF32) agrees with the plain version
    within ``TOL[float32]`` at the Grid-ViT's widths, and so does the
    online form with f32 products; one TF32 rounding of the operands, or
    a rescale skipped when the max moves, is rejected by the same
    limits."""
    from egotap_tpu_torch.ops import kernel_errors
    q, k, v = _qkv(2, 576, 8, torch.float32)
    ref = att.attention_packed_plain(q, k, v, 8)
    tol = att.TOL[torch.float32]

    def within(got):
        _, max_rel, rms_rel = kernel_errors(got, ref)
        return max_rel <= tol[0] and rms_rel <= tol[1]
    assert within(_online_softmax_f32(q, k, v, 8, product=_3xtf32))
    assert within(_online_softmax_f32(q, k, v, 8))
    assert not within(_online_softmax_f32(q, k, v, 8, product=_tf32_once))
    assert not within(att.attention_packed_plain(_tf32(q), _tf32(k),
                                                 _tf32(v), 8))
    assert not within(_online_softmax_f32(q, k, v, 8, rescale=False))
