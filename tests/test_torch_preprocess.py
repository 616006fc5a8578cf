"""The port's offline tail against the JAX package's, on the same inputs:
rotations (`core/rotations.py`), the host renderer (`data/heatmaps.py`),
the UnrealEgo and EgoCap preprocessors (`preprocess/`, each run end to
end on a dataset the test writes) and the integrity checker
(`data/integrity.py`). All of it is numpy on both sides, the same
operations in the same order: every output must be equal, bit for bit.
The cases mirror tests/test_preprocess.py and tests/test_heatmaps.py."""

import json
import os

import h5py
import numpy as np
import pytest
from PIL import Image

from egotap_tpu.core import rotations as j_rot
from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.data import heatmaps as j_hm
from egotap_tpu.data import integrity as j_integrity
from egotap_tpu.preprocess import egocap as j_egocap
from egotap_tpu.preprocess import unrealego as j_unrealego
from egotap_tpu_torch.core import rotations
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.data import heatmaps, integrity
from egotap_tpu_torch.preprocess import egocap, unrealego
from tests.test_preprocess import _make_raw_unrealego

SUB = "all_data_with_img-256_hm-64_pose-16_npy"


def same(got, want, where="") -> None:
    """Equal structure, dtypes and values (NaN equal to NaN)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want or (got != got and want != want), where


def _pose2d(rng, joints):
    """Joints over 1024-space, some out of view, one on its parent."""
    pts = rng.uniform(-100.0, 1124.0, size=(joints, 2))
    pts[3] = pts[1]
    return pts


class TestRotations:
    def test_ur2r(self, rng):
        thetas = rng.uniform(-180, 180, size=(10, 3))
        got = rotations.ur2r(thetas)
        same(got, j_rot.ur2r(thetas))
        assert all(rotations.is_rotation(r) for r in got)
        np.testing.assert_allclose(rotations.ur2r(np.zeros(3)), np.eye(3),
                                   atol=1e-7)

    def test_local_rot_and_vec2vec(self, rng):
        parents = get_skeleton("UnrealEgo").parents_array()
        pose = rng.normal(size=(16, 3))
        got = rotations.local_rot(pose, parents)
        same(got, j_rot.local_rot(pose, parents))
        np.testing.assert_allclose(np.linalg.norm(got[1:], axis=-1), 1.0,
                                   rtol=1e-5)
        v1, v2 = rng.normal(size=3), rng.normal(size=3)
        r = rotations.vec2vec_rotation(v1, v2)
        same(r, j_rot.vec2vec_rotation(v1, v2))
        np.testing.assert_allclose(r @ (v1 / np.linalg.norm(v1)),
                                   v2 / np.linalg.norm(v2), atol=1e-6)
        assert rotations.is_rotation(r) == j_rot.is_rotation(r) is True


def _renderer_cases(rng):
    """(name, args, kwargs) for every host renderer function."""
    parents = get_skeleton("UnrealEgo").parents_array()
    pts2d = _pose2d(rng, 16)
    pts3d = rng.normal(size=(16, 3))
    pts3d[5] = pts3d[3]                        # a zero-length bone
    depth = rng.uniform(-10.0, 120.0, size=16)
    peaks = heatmaps.coord2d_to_heatmap(pts2d)
    return [
        ("coord2d_to_heatmap", (pts2d,), {}),
        ("coord2d_to_heatmap", (np.array([[-70.0, 5.0], [1085.0, 1085.0],
                                          [1000.0, -60.0]]),), {"res": 48}),
        ("line_aa", (3, 60, 17, 2), {}),
        ("line_aa", (40, 5, 2, 9), {}),
        ("line_aa", (7, 7, 7, 7), {}),
        ("line_heatmap", (pts2d[2] / 16, pts2d[9] / 16), {}),
        ("limb_data", (pts2d, pts3d, parents), {}),
        ("sin_limb_heatmaps", (rng.random((15, 64, 64)).astype(np.float32),
                               rng.uniform(-1.5, 1.5, 15)), {}),
        ("pts2d_to_heatmap", (np.array([512.0, 256.0]),), {}),
        ("pts2d_to_heatmap", (pts2d[:4],), {"area": 80}),
        ("heatmap_to_camera2d", (peaks,), {}),
        ("pseudo_limb_mask", (pts2d, get_skeleton("UnrealEgo")
                              .limb_mask_indices), {}),
        ("sample_limb_heatmaps", (pts2d, depth, parents), {}),
        ("sample_limb_heatmaps", (pts2d, depth, parents),
         {"weight_depth": True, "depth_scale": 2.0, "depth_offset": 1.0}),
        ("pose_image", (pts2d, parents), {}),
        ("pose_image", (pts2d, parents),
         {"weight_depth": True, "camera_pose_depth": depth}),
    ]


@pytest.mark.parametrize("case", range(16))
def test_renderer_matches_jax(case, rng):
    name, args, kwargs = _renderer_cases(rng)[case]
    got = getattr(heatmaps, name)(*args, **kwargs)
    same(got, getattr(j_hm, name)(*args, **kwargs), name)


def test_renderer_peaks_and_round_trip():
    """tests/test_preprocess.py's point-heatmap cases on the port."""
    hm = heatmaps.pts2d_to_heatmap(np.array([512.0, 256.0]))
    assert hm.max() == pytest.approx(1.0, rel=1e-5)
    assert np.unravel_index(hm.argmax(), hm.shape) == (16, 32)
    np.testing.assert_allclose(heatmaps.heatmap_to_camera2d(hm[None])[0],
                               [16, 32])
    assert np.all(heatmaps.heatmap_to_camera2d(
        np.zeros((1, 64, 64), np.float32)) == -1.0)
    with pytest.raises(ValueError):
        heatmaps.pose_image(np.zeros((2, 2)), np.array([0, 0]),
                            weight_depth=True)


def test_enrich_frame_matches_jax(tmp_path, rng):
    seq = _make_raw_unrealego(str(tmp_path), rng, n_frames=2)
    item = np.load(os.path.join(seq, SUB, "frame_1.npy"),
                   allow_pickle=True).item()
    with open(os.path.join(seq, "json", "frame_1.json")) as f:
        meta = json.load(f)
    prev = rng.normal(size=3)
    got = unrealego.enrich_frame(dict(item), meta, Config().derive(), prev)
    want = j_unrealego.enrich_frame(dict(item), meta, JaxConfig().derive(),
                                    prev)
    same(got, want)
    assert got["gt_heatmap_left"].shape == (16, 64, 64)


def _tree(root):
    """Every file under root: relative path -> its contents (npy loaded,
    text read)."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if name.endswith(".npy"):
                out[rel] = np.load(path, allow_pickle=True)
                out[rel] = out[rel].item() if out[rel].dtype == object \
                    else out[rel]
            elif name != "modify_dataset_log.txt":     # a time and a commit
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def test_unrealego_reprocess_matches_jax(tmp_path, rng):
    raw = str(tmp_path / "raw")
    _make_raw_unrealego(raw, rng)
    trees = []
    for side, (mod, config) in {"jax": (j_unrealego, JaxConfig),
                                "port": (unrealego, Config)}.items():
        out = str(tmp_path / side)
        os.makedirs(out)
        for mode in ("train", "validation", "test"):
            with open(os.path.join(out, f"{mode}.txt"), "w") as f:
                f.write("./UnrealEgoData/Mocap/001/seq000\n")
        cfg = config(data_dir=out, metadata_dir=(raw,),
                     default_data_path="./UnrealEgoData").derive()
        assert mod.reprocess(cfg) == 0
        trees.append(_tree(out))
    want, got = trees
    assert "meanstd.npy" in got and "modify_dataset_log.txt" not in got
    frame = os.path.join("Mocap", "001", "seq000", SUB, "frame_1.npy")
    assert got[frame]["gt_limb_heatmap_left"].shape == (15, 64, 64)
    assert not os.path.exists(str(tmp_path / "port" / "Mocap" / "001" /
                                  "seq000" / SUB / "frame_0.npy"))
    same(got, want)


def _calib_txt(path, center_x):
    path.write_text("\n".join([
        "#polynomial C2W", "", "pol 5 -3.0e2 0 1.1e-3 -2.0e-6 1.0e-9", "",
        "#polynomial W2C", "", "invpol 8 470.0 290.0 -20.0 16.0 9.0 1.0 "
        "0.5 0.1", "",
        "#center", "", f"512.5 {center_x}", "",
        "#affine", "", "1.0 0.001 -0.002", "",
        "#size", "", "1024 1280", ""]))


def _make_raw_egocap(root, rng, frames=(300, 301)):
    """A small raw EgoCap tree: calibrations, the S7 v003 2D and 3D
    annotations and images, the training HDF5 and images."""
    val3d = root / "validation_v003_3D"
    (val3d / "cameraCalibration").mkdir(parents=True)
    _calib_txt(val3d / "cameraCalibration" / "stereo_c00_f_calibration.txt",
               641.0)
    _calib_txt(val3d / "cameraCalibration" / "stereo_c01_f_calibration.txt",
               637.0)

    def image(path, width=640):
        path.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(rng.integers(0, 255, (512, width, 3), np.uint8)
                        ).save(path)

    lines, blocks = ["Skeletool 3D"], []
    for f in frames:
        lines.append(" ".join(map(str, [f, *rng.normal(0, 300, 54)])))
        image(val3d / "images" / "franzi_01-cam0" / f"frame-{f}.jpg")
        image(val3d / "images" / "franzi_01-cam1" / f"frame-{f - 85}.jpg",
              512)
        for cam, fid in ((0, f), (1, f - 85)):
            blocks += ["# 1", f"./images/S7_v003_cam{cam}_frame-{fid}.jpg",
                       "640", "512", "3", "18"]
            blocks += [f"{j} {rng.uniform(0, 512):.3f} "
                       f"{rng.uniform(0, 640):.3f}" for j in range(18)]
            blocks.append("")
    (val3d / "dataset3D.mddd").write_text("\n".join(lines) + "\n")
    (root / "validation_v003_2D").mkdir()
    (root / "validation_v003_2D" / "dataset.txt").write_text(
        "\n".join(blocks))

    n = 2
    (root / "EgoCapDataloader3D").mkdir()
    with h5py.File(root / "EgoCapDataloader3D" /
                   "Ego_pose_stereo_cleaned.hdf5", "w") as hf:
        hf["pose_2d"] = rng.uniform(0, 1, (n, 2, 18, 2))
        hf["pose_3d"] = rng.normal(0, 300, (n, 18, 3))
        hf["subject_index"] = np.array([1, 2])
        hf["frame_index"] = np.array([[7, 7], [12, 12]])
    for i, s in enumerate((1, 2)):
        for cam in (0, 1):
            f = (7, 12)[i]
            image(root / "training_v000" / "images" /
                  f"S{s}_v000_cam{cam}_frame-{f:04d}.jpg")


def test_egocap_reprocess_matches_jax(tmp_path, rng):
    raw = tmp_path / "raw"
    _make_raw_egocap(raw, rng)
    trees = []
    for side, (mod, config) in {"jax": (j_egocap, JaxConfig),
                                "port": (egocap, Config)}.items():
        out = str(tmp_path / side)
        cfg = config(data_dir=out, joint_preset="EgoCap").derive()
        mod.reprocess(cfg, raw_dir=str(raw))
        tree = _tree(out)
        for name in ("train.txt", "validation.txt", "test.txt"):
            tree[name] = tree[name].replace(out.encode(), b"")
        trees.append(tree)
    want, got = trees
    frames = [k for k in got if k.endswith(".npy")]
    assert len(frames) == 4                   # 2 validation, 2 training
    frame = got[os.path.join("validation_v003_3D", SUB, "frame_300.npy")]
    assert frame["gt_heatmap_left"].shape == (17, 64, 64)
    assert frame["input_rgb_left"].shape == (3, 256, 256)
    same(got, want)


class TestEgoCapParsers:
    def test_parse_and_crop_calibration(self, tmp_path):
        _calib_txt(tmp_path / "c.txt", 641.0)
        got = egocap.parse_egocap_calib(str(tmp_path / "c.txt"))
        same(got, j_egocap.parse_egocap_calib(str(tmp_path / "c.txt")))
        assert got["image_center"] == [512.5, 641.0]
        cropped = egocap.crop_center_for_calib(got)
        same(cropped, j_egocap.crop_center_for_calib(got))
        assert cropped["image_center"][1] == 641.0 - 640 + 512

    def test_coordinates(self, rng):
        coords = rng.uniform(0, 1280, size=(18, 2))
        same(egocap.process_coordinates(coords, 641.0),
             j_egocap.process_coordinates(coords, 641.0))
        flipped = egocap.flip_raw_coordinates(coords)
        same(flipped, j_egocap.flip_raw_coordinates(coords))
        np.testing.assert_allclose(flipped[2, 0], 1280.0 - coords[6, 0])
        same(egocap.cam1_extrinsics(), j_egocap.cam1_extrinsics())
        np.testing.assert_allclose(egocap.cam1_extrinsics()[3], [0, 0, 0, 1])

    def test_images(self, rng):
        img = rng.integers(0, 255, size=(512, 1024, 3)).astype(np.uint8)
        got = egocap.crop_resize_image(img, 1100.0)
        same(got, j_egocap.crop_resize_image(img, 1100.0))
        assert got.shape == (3, 256, 256)
        same(egocap.normalize_image(got), j_egocap.normalize_image(got))

    def test_parse_2d_datafile(self, tmp_path):
        (tmp_path / "d.txt").write_text("\n".join([
            "# 1", "./images/S7_v003_cam0_frame-100.jpg",
            "640", "512", "3", "18", "0 10.0 20.0", "1 30.0 40.0", "",
            "# 2", "./images/S7_v003_cam1_frame-15.jpg",
            "640", "512", "3", "18", "2 50.0 60.0", ""]))
        got = egocap.parse_2d_datafile(str(tmp_path / "d.txt"))
        same(got, j_egocap.parse_2d_datafile(str(tmp_path / "d.txt")))
        np.testing.assert_allclose(got[0]["coordinates"][0], [20.0, 40.0])

    def test_build_frame(self, rng):
        img = rng.integers(0, 255, size=(3, 256, 256)).astype(np.float32)
        coords = rng.uniform(0, 1024, size=(18, 2)).astype(np.float32)
        pose = rng.normal(size=(18, 3)).astype(np.float32) * 10
        got = egocap.build_frame(img, img, coords, coords, pose,
                                 Config(joint_preset="EgoCap").derive())
        same(got, j_egocap.build_frame(
            img, img, coords, coords, pose,
            JaxConfig(joint_preset="EgoCap").derive()))
        assert got["gt_limb_heatmap_left"].shape == (17, 64, 64)


def _integrity_tree(tmp_path, rng):
    """tests/test_preprocess.py's raw tree, PNGs for every frame, then one
    broken JSON, one broken depth PNG and one missing RGB PNG."""
    raw = str(tmp_path / "raw")
    seq = _make_raw_unrealego(raw, rng)
    for sub, stem in (("fisheye_depth_image", "depth"),
                      ("fisheye_final_image", "final")):
        for side in ("camera_left", "camera_right"):
            d = os.path.join(seq, sub, side)
            os.makedirs(d)
            for t in range(3):
                Image.new("L", (4, 4)).save(os.path.join(d,
                                                         f"{stem}_{t}.png"))
    with open(os.path.join(seq, "json", "frame_1.json"), "w") as f:
        f.write("{not json")
    with open(os.path.join(seq, "fisheye_depth_image", "camera_right",
                           "depth_2.png"), "wb") as f:
        f.write(b"not a png")
    os.remove(os.path.join(seq, "fisheye_final_image", "camera_left",
                           "final_0.png"))
    return raw


@pytest.mark.parametrize("check_raw", [False, True, ("json",)])
def test_integrity_matches_jax(tmp_path, rng, check_raw):
    raw = _integrity_tree(tmp_path, rng)
    reports, files = [], []
    for mod, config in ((j_integrity, JaxConfig), (integrity, Config)):
        cfg = config(data_dir=raw, default_data_path="./UnrealEgoData"
                     ).derive()
        reports.append(mod.check_split(cfg, "train", check_keys=False,
                                       check_raw=check_raw))
        files.append({k: v for k, v in _tree(raw).items()
                      if k.endswith("_train.txt")})
    same(reports[1], reports[0])
    same(files[1], files[0])
    assert reports[1]["frames"] == 3
    assert reports[1]["category_counts"] == {"001": 3}
    if check_raw is True:
        assert [len(reports[1]["corrupt_raw"][k])
                for k in ("json", "depth", "rgb")] == [1, 1, 1]


def test_integrity_metadata_dir_fallback(tmp_path, rng):
    """A raw tree under a separate metadata root resolves through
    cfg.metadata_dir (reference check_dataset.py:76-82)."""
    raw, meta = str(tmp_path / "npys"), str(tmp_path / "meta")
    _make_raw_unrealego(raw, rng)
    rel = os.path.join("Mocap", "001", "seq000")
    os.makedirs(os.path.join(meta, rel))
    os.rename(os.path.join(raw, rel, "json"), os.path.join(meta, rel, "json"))
    cfg = Config(data_dir=raw, metadata_dir=(meta,),
                 default_data_path="./UnrealEgoData").derive()
    report = integrity.check_split(cfg, "train", check_keys=False,
                                   check_raw=("json",), write_reports=False)
    assert report["corrupt_raw"]["json"] == []
