"""Synthetic dataset generator — the framework's test/benchmark fixture.

The port's own copy of `egotap_tpu/data/synthetic.py`: the same
arguments write the same files. Writes a miniature dataset with the exact
on-disk layout the real UnrealEgo/EgoCap reprocessors produce (reference
reprocess_unrealego_data.py): per-frame ``.npy`` pickle dicts under
``{category}/{sequence}/{data_sub_path}/frame_N.npy``, fisheye calibration
JSONs, and ``train/validation/test.txt`` list files. Poses are smooth
random walks around a humanoid rest pose in head-camera coordinates (cm),
projected with the synthetic OCam model so most joints land in view.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from egotap_tpu_torch.core import camera
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.skeleton import get_skeleton

# humanoid rest offsets (cm) per UnrealEgo joint, head-relative, z down
_UE_REST = np.array([
    [0, 0, 0],       # head
    [0, 5, -15],     # neck
    [-16, 5, -22], [16, 5, -22],     # upperarm l/r
    [-22, 8, -46], [22, 8, -46],     # lowerarm l/r
    [-24, 14, -68], [24, 14, -68],   # hand l/r
    [-10, 6, -75], [10, 6, -75],     # thigh l/r
    [-11, 10, -115], [11, 10, -115],  # calf l/r
    [-12, 12, -152], [12, 12, -152],  # foot l/r
    [-12, 22, -157], [12, 22, -157],  # ball l/r
], dtype=np.float32)


def _rest_pose(num_joints: int) -> np.ndarray:
    if num_joints == 16:
        return _UE_REST
    # EgoCap-like 18-joint layout: reuse and extend limbs
    rest = np.zeros((num_joints, 3), dtype=np.float32)
    rest[: min(num_joints, 16)] = _UE_REST[: min(num_joints, 16)]
    for j in range(16, num_joints):
        rest[j] = rest[j - 2] + np.array([0, 4, -4], dtype=np.float32)
    return rest


def generate_dataset(root: str, preset: str = "UnrealEgo",
                     num_sequences: int = 2, frames_per_seq: int = 8,
                     image_size: int = 64, seed: int = 0,
                     categories: Optional[list] = None) -> None:
    """Write a synthetic dataset under `root`."""
    sk = get_skeleton(preset)
    rng = np.random.default_rng(seed)
    ocam = camera.synthetic_calibration(
        name="unreal_ego_pose" if preset == "UnrealEgo" else "fisheye")
    os.makedirs(root, exist_ok=True)
    for side in ("left", "right"):
        with open(os.path.join(root, f"fisheye.calibration_{side}.json"), "w") as f:
            json.dump(camera.calibration_to_dict(ocam), f)

    categories = categories or ["001", "002"]
    sub = "all_data_with_img-256_hm-64_pose-16_npy"
    rest = _rest_pose(sk.num_joints)
    baseline = np.array([6.0, 0.0, 0.0], dtype=np.float32)  # stereo offset

    lists = {"train": [], "validation": [], "test": []}
    seq_idx = 0
    for mode in ("train", "validation", "test"):
        for s in range(num_sequences):
            cat = categories[seq_idx % len(categories)]
            seq_dir = os.path.join("Mocap", cat, f"seq{seq_idx:03d}")
            frame_dir = os.path.join(root, seq_dir, sub)
            os.makedirs(frame_dir, exist_ok=True)
            lists[mode].append(os.path.join("./SyntheticData", seq_dir))

            pose = rest.copy()
            for t in range(frames_per_seq):
                pose = rest + np.cumsum(
                    rng.normal(0, 1.0, size=pose.shape).astype(np.float32),
                    axis=0) * 0.5
                pelvis_l = np.array([0.0, 2.0, -8.0], dtype=np.float32)
                pelvis_r = pelvis_l - baseline
                pts3d_l = pose + pelvis_l
                pts3d_r = pose + pelvis_r
                p2d_l = camera.world2cam_np(pts3d_l, ocam).astype(np.float32)
                p2d_r = camera.world2cam_np(pts3d_r, ocam).astype(np.float32)

                rot = np.zeros_like(pose)
                d = pose[1:] - pose[np.asarray(sk.parents)[1:]]
                rot[1:] = d / np.linalg.norm(d, axis=-1, keepdims=True)

                frame = {
                    "input_rgb_left": rng.normal(
                        0, 1, size=(3, image_size * 4, image_size * 4)
                    ).astype(np.float32),
                    "input_rgb_right": rng.normal(
                        0, 1, size=(3, image_size * 4, image_size * 4)
                    ).astype(np.float32),
                    "gt_camera_2d_left": p2d_l,
                    "gt_camera_2d_right": p2d_r,
                    "gt_local_pose": pose.astype(np.float32),
                    "gt_local_rot": rot.astype(np.float32),
                    "gt_pelvis_left": pelvis_l,
                    "gt_pelvis_right": pelvis_r,
                }
                np.save(os.path.join(frame_dir, f"frame_{t}.npy"),
                        np.asarray(frame, dtype=object))
            seq_idx += 1

    for mode, seqs in lists.items():
        with open(os.path.join(root, f"{mode}.txt"), "w") as f:
            f.write("\n".join(seqs) + "\n")


def synthetic_config(root: str, preset: str = "UnrealEgo", **kw) -> Config:
    """Config pointing at a generated synthetic dataset."""
    defaults = dict(
        data_dir=root, default_data_path="./SyntheticData",
        joint_preset=preset, batch_size=4, num_threads=2,
    )
    defaults.update(kw)
    return Config(**defaults).derive()
