"""Offline EgoCap dataset reprocessing, numpy on the host.

The port's own copy of `egotap_tpu/preprocess/egocap.py`, the
equivalent of the reference's reprocess_egocap_data.py: parses the OCam
calibration text files into the fisheye JSON format, reads the cleaned
stereo-pose HDF5 (train, subjects S1-6) and the S7 v003 2D/3D validation
annotations, crops/flips/resizes the 640x512 images to 256x256, converts
2D annotations to the 1024-pixel convention and 3D poses mm -> cm (/10),
renders joint heatmaps + limb data, and writes per-frame ``.npy`` dicts
plus train/validation/test list files.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.rotations import local_rot
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.data.heatmaps import coord2d_to_heatmap, limb_data

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# reorder applied when horizontally flipping cam1 annotations (left/right
# limbs swap; reference reprocess_egocap_data.py:165)
JOINT_REORDER = [0, 1, 6, 7, 8, 9, 2, 3, 4, 5, 14, 15, 16, 17, 10, 11, 12, 13]

# cam1 extrinsics from cameraCalibration/calibrationFileV5.calibration
# (reference :51-69), already z-convention preconditioned
_CAM1_RAW = np.array([
    [-6.811572770603570E-01, -1.978935067001849E-01, -7.048850430485982E-01, -2.369619435605097E+01],
    [-1.823782681785945E-01, -8.865639851773102E-01, 4.251381745770462E-01, 4.735684810307217E+02],
    [-7.090577770562122E-01, 4.181416747855088E-01, 5.677980350473865E-01, 1.699215408061096E+01],
    [0, 0, 0, 1]])


def cam1_extrinsics() -> np.ndarray:
    flip_z = np.eye(4)
    flip_z[2, 2] = -1.0
    return flip_z @ _CAM1_RAW @ flip_z


def parse_egocap_calib(file_path: str) -> Dict:
    """OCam calibration txt -> fisheye JSON dict (reference :16-29)."""
    with open(file_path) as f:
        lines = f.readlines()
    return {
        "name": "egocap_pose",
        "polynomialC2W": [float(x) for x in lines[2].strip().split()[1:]],
        "polynomialW2C": [float(x) for x in lines[6].strip().split()[1:]],
        "image_center": [float(x) for x in lines[10].strip().split()],
        "affine": [float(x) for x in lines[14].strip().split()],
        "size": [int(x) for x in lines[18].strip().split()],
        "imageCircleRadius": 512,
    }


def crop_center_for_calib(calib: Dict) -> Dict:
    """Adjust image_center for the center crop (reference :38-47)."""
    calib = dict(calib)
    calib["orig_image_center"] = list(calib["image_center"])
    h_center = int(calib["image_center"][1] / 2) * 2
    calib["image_center"] = [calib["image_center"][0],
                             calib["image_center"][1] - h_center + 512]
    return calib


def process_coordinates(coords: np.ndarray, orig_center_x: float,
                        do_crop: bool = True) -> np.ndarray:
    """Recenter full-res 2D coords to the cropped 1024 frame (reference
    :113-120)."""
    coords = np.asarray(coords, dtype=np.float32).copy()
    if do_crop:
        h_center = int(orig_center_x / 2) * 2
        coords[..., 0] = coords[..., 0] - h_center + 512
    return coords


def flip_raw_coordinates(coords: np.ndarray, width: float = 1280.0
                         ) -> np.ndarray:
    coords = np.asarray(coords).copy()
    coords[..., 0] = width - coords[..., 0]
    return coords[JOINT_REORDER]


def crop_resize_image(img: np.ndarray, orig_center_x: float,
                      do_crop: bool = True) -> np.ndarray:
    """(H, W, 3) uint8 -> (3, 256, 256) float, center-cropped to square and
    bilinear-resized (half-pixel centers, like torch align_corners=False)."""
    import cv2
    if do_crop:
        if img.shape[1] == 512:
            c = int(orig_center_x / 2)
            img = img[:, c - 256:c + 256]
        elif img.shape[1] == 1024:
            c = int(orig_center_x)
            img = img[:, c - 512:c + 512]
    img = cv2.resize(img.astype(np.float32), (256, 256),
                     interpolation=cv2.INTER_LINEAR)
    return img.transpose(2, 0, 1)


def normalize_image(img_chw: np.ndarray) -> np.ndarray:
    """uint8-scale (3, H, W) -> ImageNet-normalized float32
    (reference utils/util.py:188-197, 437-440)."""
    x = img_chw.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN[:, None, None]) / IMAGENET_STD[:, None, None]


def parse_2d_datafile(annotation_file: str) -> List[Dict]:
    """The EgoCap 2D marker annotation format (reference :120-163):
    '#'-separated blocks with an image path, dimension ints, and
    (id, row, col) coordinate triples at half resolution."""
    with open(annotation_file) as f:
        lines = f.readlines()
    data: List[Dict] = []
    for line in lines:
        line = line.strip()
        if line.startswith("#"):
            data.append({})
        elif "./images/" in line:
            data[-1]["img_path"] = line
        elif len(line) == 0:
            continue
        elif line.isdigit():
            key = "num_coordinates" if (
                "dimensions" in data[-1]
                and isinstance(data[-1]["dimensions"], list)
                and len(data[-1]["dimensions"]) == 3) else "dimensions"
            if key not in data[-1]:
                data[-1][key] = int(line)
            else:
                val = data[-1][key]
                data[-1][key] = ([val, int(line)] if isinstance(val, int)
                                 else val + [int(line)])
        else:
            coord = tuple(map(float, line.split()))
            # calibration is full-res -> x2; stored as (y*2, x*2) = (x, y)
            data[-1].setdefault("coordinates", []).append(
                (coord[1] * 2.0, coord[2] * 2.0))
    for d in data:
        d["coordinates"] = np.array(d.get("coordinates", []),
                                    dtype=np.float32)
    return data


def build_frame(img_left_chw: np.ndarray, img_right_chw: np.ndarray,
                coords_left: np.ndarray, coords_right: np.ndarray,
                local_pose_cm: np.ndarray, cfg: Config) -> Dict:
    """Assemble one EgoCap frame dict (shared by train/validation paths)."""
    sk = get_skeleton("EgoCap")
    parents = sk.parents_array()
    frame = {
        "input_rgb_left": normalize_image(img_left_chw),
        "input_rgb_right": normalize_image(img_right_chw),
        "gt_heatmap_left": coord2d_to_heatmap(coords_left[1:], res=64),
        "gt_heatmap_right": coord2d_to_heatmap(coords_right[1:], res=64),
        "gt_camera_2d_left": coords_left,
        "gt_camera_2d_right": coords_right,
        "gt_local_rot": local_rot(local_pose_cm, parents),
        "gt_local_pose": local_pose_cm.astype(np.float32),
        "gt_global_pose": local_pose_cm.astype(np.float32),
        "gt_pelvis_left": np.zeros(3, dtype=np.float32),
        "gt_pelvis_right": np.zeros(3, dtype=np.float32),
    }
    for side, p2 in (("left", coords_left), ("right", coords_right)):
        hm, lengths, theta = limb_data(p2, local_pose_cm, parents)
        frame[f"gt_limb_heatmap_{side}"] = hm
        frame[f"gt_pixel_length_{side}"] = lengths
        if side == "left":
            frame["gt_limb_theta"] = theta
    return frame


def write_calibrations(cfg: Config, validation_3d_dir: str,
                       do_crop: bool = True) -> Tuple[Dict, Dict]:
    c0 = parse_egocap_calib(os.path.join(
        validation_3d_dir, "cameraCalibration", "stereo_c00_f_calibration.txt"))
    c1 = parse_egocap_calib(os.path.join(
        validation_3d_dir, "cameraCalibration", "stereo_c01_f_calibration.txt"))
    if do_crop:
        c0, c1 = crop_center_for_calib(c0), crop_center_for_calib(c1)
    for side, c in (("left", c0), ("right", c1)):
        out = {k: v for k, v in c.items() if k != "orig_image_center"}
        with open(os.path.join(cfg.data_dir,
                               f"fisheye.calibration_{side}.json"), "w") as f:
            json.dump(out, f)
    return c0, c1


def process_training_set(cfg: Config, training_dir: str, c0: Dict, c1: Dict,
                         hdf5_path: str, do_crop: bool = True,
                         limit: Optional[int] = None) -> int:
    """Subjects S1-6 from the cleaned stereo-pose HDF5 (reference :185-267).
    cam1 images/annotations are horizontally flipped back; the 3D pose is
    mm -> cm with the z axis negated."""
    import h5py
    from PIL import Image

    hf = h5py.File(hdf5_path, "r")
    n = hf["pose_2d"].shape[0]
    if limit:
        n = min(n, limit)
    cx0 = c0.get("orig_image_center", c0["image_center"])[1]
    cx1 = c1.get("orig_image_center", c1["image_center"])[1]
    count = 0
    for idx in range(n):
        subject = int(hf["subject_index"][idx])
        frames = [int(hf["frame_index"][idx, 0]), int(hf["frame_index"][idx, 1])]
        img_paths = [os.path.join(
            training_dir, "images",
            f"S{subject}_v000_cam{i}_frame-{frames[i]:04d}.jpg")
            for i in range(2)]
        imgs = []
        for i, p in enumerate(img_paths):
            img = np.array(Image.open(p))
            if i == 1:  # cam1 stored mirrored
                img = np.flip(img, axis=1).copy()
            imgs.append(crop_resize_image(img, [cx0, cx1][i], do_crop))

        raw0 = np.asarray(hf["pose_2d"][idx][0]) * [1280, 1024]
        raw1 = np.asarray(hf["pose_2d"][idx][1]) * [1280, 1024]
        coords0 = process_coordinates(raw0, cx0, do_crop)
        coords1 = process_coordinates(raw1, cx1, do_crop)

        local_pose = np.asarray(hf["pose_3d"][idx]) / 10.0
        local_pose[..., 2] *= -1.0

        frame = build_frame(imgs[0], imgs[1], coords0, coords1,
                            local_pose, cfg)
        out = os.path.join(cfg.data_dir, "training_v000", f"S{subject}",
                           cfg.data_sub_path, f"frame_{frames[0]}.npy")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        if not cfg.experiment:
            np.save(out, np.array(frame, dtype=object))
        count += 1
    return count


def process_validation_set(cfg: Config, val3d_dir: str, val2d_dir: str,
                           c0: Dict, c1: Dict, do_crop: bool = True,
                           limit: Optional[int] = None) -> int:
    """S7 v003 split: 2D marker annotations + Skeletool 3D .mddd
    (reference :269-392). cam1 frames lag by 85."""
    from PIL import Image

    cx0 = c0.get("orig_image_center", c0["image_center"])[1]
    cx1 = c1.get("orig_image_center", c1["image_center"])[1]

    ann2d = parse_2d_datafile(os.path.join(val2d_dir, "dataset.txt"))
    coords_by_img = {}
    for val in ann2d:
        if "S7" not in val.get("img_path", ""):
            continue
        coords = val["coordinates"]
        if "cam1" in val["img_path"]:
            coords = flip_raw_coordinates(coords)
        cx = cx0 if "cam0" in val["img_path"] else cx1
        coords_by_img[val["img_path"]] = process_coordinates(coords, cx, do_crop)

    entries = []
    with open(os.path.join(val3d_dir, "dataset3D.mddd")) as f:
        for line in f.readlines()[1:]:
            line = line.strip()
            if line.startswith("Skeletool"):
                continue
            coord = tuple(map(float, line.split())) if line else ()
            if len(coord) != 55:
                continue
            entries.append((int(coord[0]),
                            np.array(coord[1:], np.float32).reshape(-1, 3)))
    if limit:
        entries = entries[-limit:]

    out_dir = os.path.join(cfg.data_dir, "validation_v003_3D",
                           cfg.data_sub_path)
    os.makedirs(out_dir, exist_ok=True)
    count = 0
    for frame_id, pose_mm in entries:
        img0 = np.array(Image.open(os.path.join(
            val3d_dir, "images", "franzi_01-cam0", f"frame-{frame_id}.jpg")))
        img1 = np.array(Image.open(os.path.join(
            val3d_dir, "images", "franzi_01-cam1",
            f"frame-{frame_id - 85}.jpg")))
        coords0 = coords_by_img[f"./images/S7_v003_cam0_frame-{frame_id}.jpg"]
        coords1 = coords_by_img[f"./images/S7_v003_cam1_frame-{frame_id - 85}.jpg"]
        frame = build_frame(
            crop_resize_image(img0, cx0, do_crop),
            crop_resize_image(img1, cx1, do_crop),
            coords0, coords1, pose_mm / 10.0, cfg)
        if not cfg.experiment:
            np.save(os.path.join(out_dir, f"frame_{frame_id}.npy"),
                    np.array(frame, dtype=object))
        count += 1
    return count


def reprocess(cfg: Config, raw_dir: Optional[str] = None,
              hdf5_path: Optional[str] = None, do_crop: bool = True) -> None:
    """Full EgoCap reprocessing (reference modify_dataset, :398-452)."""
    raw_dir = raw_dir or cfg.data_dir
    val3d = os.path.join(raw_dir, "validation_v003_3D")
    val2d = os.path.join(raw_dir, "validation_v003_2D")
    training = os.path.join(raw_dir, "training_v000")
    hdf5_path = hdf5_path or os.path.join(
        raw_dir, "EgoCapDataloader3D", "Ego_pose_stereo_cleaned.hdf5")

    os.makedirs(cfg.data_dir, exist_ok=True)
    c0, c1 = write_calibrations(cfg, val3d, do_crop)
    limit = 10 if cfg.experiment else None
    process_validation_set(cfg, val3d, val2d, c0, c1, do_crop, limit)
    process_training_set(cfg, training, c0, c1, hdf5_path, do_crop, limit)
    write_list_files(cfg)


def write_list_files(cfg: Config) -> None:
    with open(os.path.join(cfg.data_dir, "train.txt"), "w") as f:
        for i in range(1, 7):
            f.write(os.path.join(cfg.data_dir, "training_v000", f"S{i}") + "\n")
    for mode in ("validation", "test"):
        with open(os.path.join(cfg.data_dir, f"{mode}.txt"), "w") as f:
            f.write(os.path.join(cfg.data_dir, "validation_v003_3D") + "\n")
