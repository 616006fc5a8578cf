"""Python side of the packed record format: writer + ctypes reader.

The port's own copy of `egotap_tpu/native/recordio.py`, in the same file
format (see recordio.cc for the layout): a pack written by either package
reads in the other. The writer packs per-frame dicts (the raw arrays
`egotap_tpu_torch.data.dataset.load_frame` returns) into one
fixed-stride file per split; the reader mmaps it and gathers whole
batches in native code. Frame paths live in a sidecar ``.paths`` text
file. g++ builds the reader at first use into ``native/build/``.

Unlike the JAX copy, `write_records` writes to ``path + ".tmp"`` and
renames once the record count is back-patched, so an interrupted pack
leaves the previous one intact and a live mmap keeps its own inode; and
`RecordReader.gather` of no indices returns ``(0, *shape)`` arrays.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import struct
import subprocess
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b"EGTPREC1"
_DTYPES = {0: np.float32, 1: np.uint8, 2: np.float16, 3: np.int32}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}

_FIELD_FMT = "<64sII6QQ"  # name, dtype, ndim, dims[6], offset
_HDR_FMT = "<8sQQII"


def _so_path() -> str:
    return os.path.join(os.path.dirname(__file__), "build", "librecordio.so")


def build_library(force: bool = False) -> str:
    """Compile recordio.cc with g++ when the library is missing or older
    than its source. The library is written under a temporary name and
    renamed, so processes that build it at once never load a half-written
    file."""
    so = _so_path()
    src = os.path.join(os.path.dirname(__file__), "recordio.cc")
    if force or not os.path.exists(so) or \
            os.path.getmtime(so) < os.path.getmtime(src):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
        os.close(fd)
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            "-pthread", src, "-o", tmp], check=True)
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.egr_open.restype = ctypes.c_void_p
        lib.egr_open.argtypes = [ctypes.c_char_p]
        lib.egr_close.restype = None
        lib.egr_close.argtypes = [ctypes.c_void_p]
        lib.egr_num_records.restype = ctypes.c_uint64
        lib.egr_num_records.argtypes = [ctypes.c_void_p]
        lib.egr_record_bytes.restype = ctypes.c_uint64
        lib.egr_record_bytes.argtypes = [ctypes.c_void_p]
        lib.egr_num_fields.restype = ctypes.c_uint32
        lib.egr_num_fields.argtypes = [ctypes.c_void_p]
        lib.egr_field_info.restype = ctypes.c_int
        lib.egr_field_info.argtypes = [
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64)]
        lib.egr_gather_fields.restype = ctypes.c_int
        lib.egr_gather_fields.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32]
        _lib = lib
    return _lib


def _replace_text(path: str, text: str) -> None:
    with open(path + ".tmp", "w") as f:
        f.write(text)
    os.replace(path + ".tmp", path)


def write_records(path: str, frames, paths: Optional[Sequence[str]] = None,
                  cast: Optional[Dict[str, np.dtype]] = None) -> int:
    """Pack frame dicts (consistent keys/shapes/dtypes) into one .egr.

    `frames` may be any iterable (streamed: one frame resident at a time;
    the record count is back-patched into the header at the end). `cast`
    converts named fields on the way in, e.g. {"input_rgb_left":
    np.float16} to halve the dominant RGB bytes (the device preprocess
    casts back to f32). The pack is written to ``path + ".tmp"`` and
    renamed into place when complete. Returns the number of records."""
    it = iter(frames)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("write_records: empty frame iterable") from None
    cast = {k: np.dtype(v) for k, v in (cast or {}).items()}

    def prep(fr, k):
        arr = np.asarray(fr[k])
        if k in cast and arr.dtype != cast[k]:
            arr = arr.astype(cast[k])
        return np.ascontiguousarray(arr)

    keys = [k for k in first if k != "path"]
    fields = []
    offset = 0
    for k in keys:
        arr = prep(first, k)
        dims = list(arr.shape) + [0] * (6 - arr.ndim)
        fields.append((k, _DTYPE_CODES[arr.dtype], arr.ndim, dims, offset,
                       arr.nbytes))
        offset += arr.nbytes

    tmp = path + ".tmp"
    n = 0
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack(_HDR_FMT, MAGIC, 0, offset, len(fields), 0))
            for (k, code, ndim, dims, off, _) in fields:
                f.write(struct.pack(_FIELD_FMT, k.encode()[:64], code, ndim,
                                    *dims, off))
            for fr in itertools.chain([first], it):
                for (k, _, _, _, _, nbytes) in fields:
                    arr = prep(fr, k)
                    if arr.nbytes != nbytes:
                        raise ValueError(f"inconsistent field {k}: "
                                         f"{arr.nbytes} bytes, not {nbytes}")
                    f.write(arr.tobytes())
                n += 1
            f.seek(8)  # back-patch num_records (right after the magic)
            f.write(struct.pack("<Q", n))
        if paths is not None:
            _replace_text(path + ".paths", "\n".join(paths) + "\n")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return n


class RecordReader:
    """mmap'd batch reader over a packed split."""

    def __init__(self, path: str, num_threads: int = 2):
        self._lib = _get_lib()
        self._h = self._lib.egr_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open record file {path}")
        self.num_threads = num_threads
        self.record_bytes = self._lib.egr_record_bytes(self._h)
        self.num_records = self._lib.egr_num_records(self._h)
        self.fields: List[Tuple[str, np.dtype, Tuple[int, ...], int]] = []
        for i in range(self._lib.egr_num_fields(self._h)):
            name = ctypes.create_string_buffer(64)
            dtype = ctypes.c_uint32()
            ndim = ctypes.c_uint32()
            dims = (ctypes.c_uint64 * 6)()
            off = ctypes.c_uint64()
            self._lib.egr_field_info(self._h, i, name, ctypes.byref(dtype),
                                     ctypes.byref(ndim), dims,
                                     ctypes.byref(off))
            shape = tuple(int(dims[d]) for d in range(ndim.value))
            self.fields.append((name.value.decode(),
                                np.dtype(_DTYPES[dtype.value]), shape,
                                int(off.value)))
        need = (struct.calcsize(_HDR_FMT)
                + struct.calcsize(_FIELD_FMT) * len(self.fields)
                + self.num_records * self.record_bytes)
        if os.path.getsize(path) < need:
            self.close()
            raise IOError(f"record file {path} is truncated: "
                          f"{os.path.getsize(path)} bytes of {need}")
        self.paths: Optional[List[str]] = None
        if os.path.exists(path + ".paths"):
            with open(path + ".paths") as f:
                self.paths = [p.strip() for p in f if p.strip()]

    def gather(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """A batch: one native field-major gather straight into the final
        per-field arrays (batch, *field_shape)."""
        indices = np.ascontiguousarray(indices, dtype=np.uint64)
        n = len(indices)
        out = {name: np.empty((n,) + shape, dtype=dtype)
               for name, dtype, shape, _ in self.fields}
        if n == 0:
            return out
        ptrs = (ctypes.c_void_p * len(self.fields))()
        fbytes = (ctypes.c_uint64 * len(self.fields))()
        for i, (name, dtype, shape, _) in enumerate(self.fields):
            ptrs[i] = out[name].ctypes.data_as(ctypes.c_void_p)
            fbytes[i] = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
        rc = self._lib.egr_gather_fields(
            self._h, indices.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n, ptrs, fbytes, self.num_threads)
        if rc != 0:
            raise IndexError("record index out of range")
        return out

    def close(self) -> None:
        if self._h:
            self._lib.egr_close(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def pack_split(cfg, mode: str, rgb_dtype: Optional[str] = None) -> str:
    """Pack one split of an npy-dict dataset into ``{data_dir}/packed/``,
    streaming the frames. ``rgb_dtype="float16"`` halves the stereo-RGB
    bytes (the device preprocess casts back to f32); leave it unset for
    f32 parity runs."""
    from egotap_tpu_torch.data.dataset import FrameDataset
    ds = FrameDataset(cfg, mode)
    out = packed_path(cfg, mode)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cast = None
    if rgb_dtype is not None:
        cast = {"input_rgb_left": np.dtype(rgb_dtype),
                "input_rgb_right": np.dtype(rgb_dtype)}
    write_records(out, (ds[i] for i in range(len(ds))), paths=ds.paths,
                  cast=cast)
    return out


def packed_path(cfg, mode: str) -> str:
    return os.path.join(cfg.data_dir, "packed", f"{cfg.data_prefix}{mode}.egr")
