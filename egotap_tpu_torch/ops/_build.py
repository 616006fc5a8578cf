"""Build and load the hand-written CUDA kernels (no JAX counterpart).

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds, not minutes). Libraries go to
``egotap_tpu_torch/build/`` under a name keyed by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one is
reused. `build_all` starts one ``nvcc`` per source, all at once.

Every C entry point takes device pointers and the stream as
``c_void_p``, ints as ``c_int``, launches on that stream and returns
``cudaGetLastError()``; `check` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# argtypes of each library's C entry points
_VP, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES: Dict[str, Dict[str, list]] = {
    "upsample": {"egotap_upsample2x": [_VP] * 4 + [_I] * 8 + [_VP],
                 "egotap_upsample2x_occupancy": [_I, _I, _VP]},
    "attention": {"egotap_attention_packed":
                  [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP],
                  "egotap_attention_occupancy": [_I, _VP]},
    "pu_chain": {"egotap_pu_chain": [_VP] * 12 + [_I] * 8 + [_VP],
                 "egotap_pu_chain_occupancy": [_I] * 5 + [_VP]},
    "fused_layer1": {"egotap_fused_layer1": [_VP] * 5 + [_I] * 8 + [_VP],
                     "egotap_fused_layer1_occupancy": [_I] * 5 + [_VP]},
}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH); the "
                           "port's kernels are built from csrc/ at first use")
    return path


def _target(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    with open(out[:-3] + ".log", "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none
    return log


def build_all() -> Dict[str, str]:
    """Build every kernel library in parallel; returns nvcc's log per
    library ("" when it was already built)."""
    started = {n: _start(n) for n in SIGNATURES}
    return {n: _finish(n, s) if s is not None else ""
            for n, s in started.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    started = _start(name)
    if started is not None:
        _finish(name, started)
    lib = ctypes.CDLL(_target(name))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    _loaded[name] = lib
    return lib


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v``: registers, spills, static shared
    memory of each kernel) from the build of ``csrc/<name>.cu``, kept
    beside its library."""
    library(name)
    with open(_target(name)[:-3] + ".log") as f:
        return f.read()


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
