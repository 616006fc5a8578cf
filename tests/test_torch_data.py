"""The port's data path against the JAX package's, at a small size
(64-px RGB, 16 x 16 maps, batch 4): the numpy camera model, the
synthetic dataset generator (the same files for the same arguments),
and the loaders over `.npy` frames and over a packed split (the same
batches, masks and paths over whole epochs, train shuffle and eval
padding, a category filter), `PrefetchLoader` under `copy.deepcopy`, and
`make_loader`'s choice between a pack and the frames."""

import copy
import filecmp
import os

import numpy as np
import pytest

from egotap_tpu.core import camera as jax_camera
from egotap_tpu.data import pipeline as jax_pipeline
from egotap_tpu.data.dataset import FrameDataset as JaxFrameDataset
from egotap_tpu.data.synthetic import generate_dataset as jax_generate
from egotap_tpu.data.synthetic import synthetic_config as jax_synthetic_config
from egotap_tpu.native import recordio as jax_recordio
from egotap_tpu_torch.core import camera
from egotap_tpu_torch.data import pipeline
from egotap_tpu_torch.data.dataset import FrameDataset, natsorted
from egotap_tpu_torch.data.synthetic import generate_dataset, synthetic_config
from egotap_tpu_torch.native import recordio

# 2 sequences x 5 frames a split: 10 frames, so batch 4 leaves a padded
# eval batch of 2 and drops 2 frames a training epoch
SEQS, FRAMES, MAPS, BATCH = 2, 5, 16, 4
UNUSED = "./no_such_prefix"    # list files that hold full paths


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data"))
    generate_dataset(path, "UnrealEgo", num_sequences=SEQS,
                     frames_per_seq=FRAMES, image_size=MAPS)
    return path


def _configs(root, **kw):
    fields = dict(load_size_heatmap=(MAPS, MAPS), batch_size=BATCH, **kw)
    return (synthetic_config(root, **fields),
            jax_synthetic_config(root, **fields))


@pytest.mark.parametrize("name", ["unreal_ego_pose", "fisheye"])
def test_camera_matches_jax(name):
    """Projection both ways, bit for bit, and the calibration dict."""
    ours = camera.synthetic_calibration(name=name)
    ref = jax_camera.synthetic_calibration(name=name)
    assert camera.calibration_to_dict(ours) == \
        jax_camera.calibration_to_dict(ref)
    rng = np.random.default_rng(0)
    pts = rng.normal(0, 40, size=(64, 3)).astype(np.float32)
    pts[0] = (0, 0, 5)                       # on the optical axis
    np.testing.assert_array_equal(camera.world2cam_np(pts, ours),
                                  jax_camera.world2cam_np(pts, ref))
    pix = rng.uniform(100, 900, size=(64, 2))
    np.testing.assert_array_equal(camera.cam2world_np(pix, ours),
                                  jax_camera.cam2world_np(pix, ref))
    again = camera.calibration_from_dict(camera.calibration_to_dict(ours))
    np.testing.assert_array_equal(again.pol, ours.pol)


@pytest.mark.parametrize("preset", ["UnrealEgo", "EgoCap"])
def test_generate_dataset_matches_jax(preset, tmp_path):
    """The same files: frame dicts equal bit for bit, list files and
    calibration JSONs equal as text."""
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    kw = dict(num_sequences=2, frames_per_seq=3, image_size=MAPS, seed=3)
    generate_dataset(ours, preset, **kw)
    jax_generate(ref, preset, **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), ours)
                   for d, _, fs in os.walk(ours) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), ref)
                           for d, _, fs in os.walk(ref) for f in fs)
    assert len(files) == 3 * 2 * 3 + 3 + 2
    for f in files:
        a, b = os.path.join(ours, f), os.path.join(ref, f)
        if f.endswith(".npy"):
            fa = np.load(a, allow_pickle=True).item()
            fb = np.load(b, allow_pickle=True).item()
            assert list(fa) == list(fb)
            for k in fa:
                assert fa[k].dtype == fb[k].dtype
                np.testing.assert_array_equal(fa[k], fb[k])
        else:
            assert filecmp.cmp(a, b, shallow=False), f


def test_dataset_lists_and_loads_like_jax(root):
    cfg, jcfg = _configs(root)
    for mode in ("train", "validation", "test"):
        ours, ref = FrameDataset(cfg, mode), JaxFrameDataset(jcfg, mode)
        assert ours.paths == ref.paths and len(ours) == SEQS * FRAMES
    for cat in ("001", "002", "003"):
        assert FrameDataset(cfg, "test", cat).paths == \
            JaxFrameDataset(jcfg, "test", cat).paths
    assert natsorted(["f_10", "f_2", "f_1"]) == ["f_1", "f_2", "f_10"]
    mono, jmono = _configs(root, joint_preset="xR-Egopose")
    a, b = FrameDataset(mono, "test")[3], JaxFrameDataset(jmono, "test")[3]
    assert a["path"] == b["path"]
    for k in a:
        if k != "path":
            np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(a["input_rgb_right"], a["input_rgb_left"])


def _assert_batches_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert sorted(a) == sorted(b)
        assert a["paths"] == b["paths"]
        for k in a:
            if k != "paths":
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])


def _epochs(loader, n=2):
    return [b for _ in range(n) for b in loader]


@pytest.mark.parametrize("mode,category", [
    ("train", None), ("test", None), ("validation", "002")])
def test_batch_loader_matches_jax(root, mode, category):
    """Two epochs of `.npy` batches: train shuffled with drop_last, eval
    ordered with the last batch padded and masked, a category filter."""
    cfg, jcfg = _configs(root)
    ours = pipeline.make_loader(cfg, mode, category)
    ref = jax_pipeline.make_loader(jcfg, mode, category)
    assert isinstance(ours, pipeline.BatchLoader)
    assert len(ours) == len(ref)
    got, want = _epochs(ours), _epochs(ref)
    _assert_batches_equal(got, want)
    masks = [float(b["mask"].sum()) for b in got]
    if mode == "train":
        assert masks == [BATCH] * len(got)
        assert got[0]["paths"] != got[len(ours)]["paths"]   # reshuffled
    else:
        assert 0 < masks[-1] < BATCH and len(got[-1]["paths"]) == masks[-1]


@pytest.fixture(scope="module")
def packed(tmp_path_factory, root):
    """The test and train splits packed by the port, under a directory
    holding copies of the dataset's list files with the frames' full
    paths (so the `.npy` tests see no pack)."""
    path = str(tmp_path_factory.mktemp("packed"))
    for name in os.listdir(root):
        if name.endswith((".txt", ".json")):
            with open(os.path.join(root, name)) as f, \
                    open(os.path.join(path, name), "w") as g:
                g.write(f.read().replace("./SyntheticData", root))
    cfg, _ = _configs(path, default_data_path=UNUSED)
    for mode in ("train", "test"):
        recordio.pack_split(cfg, mode)
    return path


@pytest.mark.parametrize("mode,category,prefetch", [
    ("train", None, 2), ("test", None, 0), ("test", "001", 2)])
def test_packed_loader_matches_jax(packed, root, mode, category, prefetch):
    """The same batches from a pack as JAX's packed loader, and as the
    `.npy` loader over the same frames."""
    cfg, jcfg = _configs(packed, default_data_path=UNUSED,
                         prefetch_batches=prefetch)
    ours = pipeline.make_loader(cfg, mode, category)
    kind = pipeline.PrefetchLoader if prefetch else pipeline.PackedBatchLoader
    assert isinstance(ours, kind)
    got = _epochs(ours)
    _assert_batches_equal(got, _epochs(jax_pipeline.make_loader(
        jcfg, mode, category)))
    npy, _ = _configs(root)
    _assert_batches_equal(got, _epochs(pipeline.make_loader(npy, mode,
                                                            category)))


def test_pack_written_by_jax_reads_in_the_port(packed, root, tmp_path):
    cfg, jcfg = _configs(packed, default_data_path=UNUSED)
    ours = recordio.packed_path(cfg, "test")
    ref = str(tmp_path / "test.egr")
    jax_recordio.write_records(
        ref, (JaxFrameDataset(jcfg, "test")[i] for i in range(10)),
        paths=JaxFrameDataset(jcfg, "test").paths)
    assert filecmp.cmp(ours, ref, shallow=False)
    idx = np.array([3, 0, 9])
    a = recordio.RecordReader(ref).gather(idx)
    b = jax_recordio.RecordReader(ours).gather(idx)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_loader_copies_and_delegates(root):
    """`copy.deepcopy` of a `PrefetchLoader` (which looks attributes up
    before __init__ runs) raises no RecursionError; attributes delegate
    to the inner loader; the copy yields the same batches."""
    cfg, _ = _configs(root)
    inner = pipeline.make_loader(cfg, "test")
    loader = pipeline.PrefetchLoader(inner, depth=2)
    twin = copy.deepcopy(loader)
    assert twin.batch_size == BATCH and len(twin) == len(inner)
    _assert_batches_equal(list(twin), list(loader))
    with pytest.raises(AttributeError):
        loader.no_such_attribute


def test_prefetch_loader_reraises_and_stops():
    def failing():
        yield {"x": np.zeros(1)}
        raise ValueError("reader failed")

    class Inner:
        def __iter__(self):
            return failing()

        def __len__(self):
            return 2

    it = iter(pipeline.PrefetchLoader(Inner()))
    assert next(it)["x"].shape == (1,)
    with pytest.raises(ValueError, match="reader failed"):
        next(it)


def test_make_loader_raises_for_an_unreadable_pack(root, tmp_path):
    """A pack that exists but cannot be opened raises; it does not fall
    back to the `.npy` frames (only a missing pack does)."""
    cfg, _ = _configs(str(tmp_path), default_data_path=UNUSED)
    with open(os.path.join(root, "test.txt")) as f:
        (tmp_path / "test.txt").write_text(
            f.read().replace("./SyntheticData", root))
    assert isinstance(pipeline.make_loader(cfg, "test"), pipeline.BatchLoader)
    os.makedirs(tmp_path / "packed")
    (tmp_path / "packed" / "test.egr").write_bytes(b"not a record file")
    with pytest.raises(IOError):
        pipeline.make_loader(cfg, "test")
