"""The port's packed record format (egotap_tpu_torch.native.recordio)
against the JAX package's: a pack written by the port is byte for byte
JAX's, and each package reads the other's; an empty gather returns empty
arrays; an interrupted `write_records` leaves the previous pack intact;
a truncated pack raises."""

import filecmp
import os

import numpy as np
import pytest

from egotap_tpu.native import recordio as jax_recordio
from egotap_tpu_torch.native import recordio


def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"input_rgb_left": rng.standard_normal((8, 8, 3)).astype(
                np.float32),
             "gt_local_pose": rng.standard_normal((16, 3)).astype(np.float32),
             "label": rng.integers(0, 255, (4,)).astype(np.uint8),
             "count": np.asarray([i], dtype=np.int32),
             "path": f"/data/Mocap/00{i % 2 + 1}/seq/frame_{i}.npy"}
            for i in range(n)]


@pytest.mark.parametrize("cast", [None, {"input_rgb_left": "float16"}])
def test_pack_is_jax_byte_for_byte(tmp_path, cast):
    frames = _frames(5)
    paths = [f["path"] for f in frames]
    ours, ref = str(tmp_path / "ours.egr"), str(tmp_path / "ref.egr")
    assert recordio.write_records(ours, iter(frames), paths, cast) == 5
    jax_recordio.write_records(ref, iter(frames), paths, cast)
    assert filecmp.cmp(ours, ref, shallow=False)
    assert filecmp.cmp(ours + ".paths", ref + ".paths", shallow=False)
    assert not os.path.exists(ours + ".tmp")


def test_each_package_reads_the_other(tmp_path):
    frames = _frames(7)
    ours, ref = str(tmp_path / "ours.egr"), str(tmp_path / "ref.egr")
    recordio.write_records(ours, frames, [f["path"] for f in frames])
    jax_recordio.write_records(ref, frames, [f["path"] for f in frames])
    idx = np.array([6, 0, 3, 3])
    for reader_cls, path in ((recordio.RecordReader, ref),
                             (jax_recordio.RecordReader, ours)):
        reader = reader_cls(path, num_threads=2)
        assert reader.num_records == 7
        assert reader.paths == [f["path"] for f in frames]
        batch = reader.gather(idx)
        for k, v in frames[0].items():
            if k == "path":
                continue
            want = np.stack([frames[i][k] for i in idx])
            assert batch[k].dtype == want.dtype
            np.testing.assert_array_equal(batch[k], want)


def test_empty_gather_returns_empty_arrays(tmp_path):
    path = str(tmp_path / "p.egr")
    recordio.write_records(path, _frames(3))
    reader = recordio.RecordReader(path)
    out = reader.gather(np.zeros((0,), np.int64))
    assert out["input_rgb_left"].shape == (0, 8, 8, 3)
    assert out["count"].shape == (0, 1) and out["count"].dtype == np.int32
    with pytest.raises(IndexError):
        reader.gather(np.array([3]))
    reader.close()


def test_interrupted_write_keeps_the_previous_pack(tmp_path):
    path = str(tmp_path / "p.egr")
    recordio.write_records(path, _frames(4), [f"a{i}" for i in range(4)])
    before = open(path, "rb").read()
    reader = recordio.RecordReader(path)

    def failing():
        yield from _frames(2, seed=1)
        raise RuntimeError("reader died mid-pack")

    with pytest.raises(RuntimeError, match="mid-pack"):
        recordio.write_records(path, failing(), ["b0", "b1"])
    assert open(path, "rb").read() == before
    assert reader.paths == [f"a{i}" for i in range(4)]
    assert not os.path.exists(path + ".tmp")
    np.testing.assert_array_equal(reader.gather(np.array([1]))["count"], [[1]])
    with pytest.raises(ValueError):                 # inconsistent field
        bad = _frames(2)
        bad[1]["gt_local_pose"] = np.zeros((15, 3), np.float32)
        recordio.write_records(path, bad)
    assert open(path, "rb").read() == before


def test_truncated_pack_raises(tmp_path):
    path = str(tmp_path / "p.egr")
    recordio.write_records(path, _frames(3))
    data = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(data[:-10])
    with pytest.raises(IOError, match="truncated"):
        recordio.RecordReader(path)
    with open(path, "wb") as f:
        f.write(b"X" * len(data))
    with pytest.raises(IOError):
        recordio.RecordReader(path)
