"""What `ops/attention.py` checks and passes on before kernel B launches,
on the CPU: the library is replaced by a recorder, so no kernel runs. The
kernel itself is held to its plain version on the card
(`tests/test_torch_kernels_cuda.py`, `chip_smoke.py`)."""

import pytest
import torch

from egotap_tpu_torch.ops import _build
from egotap_tpu_torch.ops import attention as att


class FakeLibrary:
    """Stands in for the built ``attention`` library: records the calls."""

    def __init__(self, info=(3, 168, 0, 66560, 128)):
        self.calls, self.info = [], info

    def egotap_attention_packed(self, *args):
        self.calls.append(args)
        return 0

    def egotap_attention_bf16_occupancy(self, address):
        import ctypes
        out = (ctypes.c_int * 5).from_address(address)
        out[:] = self.info
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


@pytest.mark.parametrize("s", [1, 576, att.MAX_SEQ_F32, att.MAX_SEQ_F32 + 1,
                               4096])
def test_bf16_takes_any_sequence_length(fake, s):
    q, k, v = _qkv(1, s, 2, torch.bfloat16)
    out = att._launch(q, k, v, 2)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    (args,) = fake.calls
    assert args[:3] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
    assert args[3] == out.data_ptr()
    assert args[4:9] == (1, s, 2, att.HEAD_DIM, 1)      # b, s, heads, Dh, bf16


@pytest.mark.parametrize("s,ok", [(att.MAX_SEQ_F32, True),
                                  (att.MAX_SEQ_F32 + 1, False)])
def test_f32_keeps_its_sequence_limit(fake, s, ok):
    q, k, v = _qkv(1, s, 1, torch.float32)
    if ok:
        att._launch(q, k, v, 1)
        assert fake.calls[0][4:9] == (1, s, 1, att.HEAD_DIM, 0)
    else:
        with pytest.raises(NotImplementedError, match="float32"):
            att._launch(q, k, v, 1)
        assert not fake.calls


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
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN1a21attention_bf16_kernelEPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN1a21attention_bf16_kernelEPK13__nv_bfloat16
    16 bytes stack frame, 16 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 16 bytes cumulative stack size
"""


def test_bf16_kernel_resources_reads_log_and_runtime(fake, monkeypatch):
    monkeypatch.setattr(_build, "build_log", lambda name: PTXAS_LOG)
    res = att.bf16_kernel_resources()
    assert res == {"registers": 168, "spill_store_bytes": 16,
                   "spill_load_bytes": 24, "static_smem_bytes": 0,
                   "blocks_per_sm": 3, "runtime_registers": 168,
                   "local_bytes": 0, "smem_bytes": 66560, "threads": 128}
    monkeypatch.setattr(_build, "build_log", lambda name: "no kernels here")
    with pytest.raises(RuntimeError):
        att.bf16_kernel_resources()
