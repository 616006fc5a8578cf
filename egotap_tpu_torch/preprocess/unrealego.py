"""Offline UnrealEgo dataset reprocessing, numpy on the host.

The port's own copy of `egotap_tpu/preprocess/unrealego.py`, the
equivalent of the reference's reprocess_unrealego_data.py:17-221: walks the
raw sequences listed in train/validation/test.txt under the metadata
directories, and for every frame enriches the released ``.npy`` dict with:
  * pelvis heatmaps appended to the joint heatmap stacks (:131),
  * pelvis camera coordinates per side (:133-134),
  * full 16-joint 2D/3D arrays from the per-frame JSON,
  * regenerated limb heatmaps / pixel lengths / thetas,
  * ground-aligned global pose, root translation (+delta) and rotation
    (UE rotator -> matrix), unit bone directions,
then writes the enriched dict beside a dataset-wide mean/std file
(``meanstd.npy``) and a provenance log. The first frame of each sequence
is kept (used as context) but not written (:175-176 'index == 0' skip).
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.rotations import local_rot, ur2r
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.data.dataset import natsorted
from egotap_tpu_torch.data.heatmaps import limb_data, pts2d_to_heatmap
from egotap_tpu_torch.eval.metrics import ArrayRunningStd


def _resolve_sequences(cfg: Config, mode: str) -> List[str]:
    list_path = os.path.join(cfg.data_dir, cfg.data_prefix + mode + ".txt")
    if not os.path.exists(list_path):
        for metadir in cfg.metadata_dir:
            alt = os.path.join(metadir, cfg.data_prefix + mode + ".txt")
            if os.path.exists(alt):
                list_path = alt
                break
    with open(list_path) as f:
        paths = [s.strip() for s in f.readlines() if s.strip()]
    out = []
    for p in paths:
        for metadir in cfg.metadata_dir:
            cand = p.replace(cfg.default_data_path, metadir, 1)
            if os.path.isdir(cand):
                out.append(cand)
                break
    return out


def _provenance(data_dir: str) -> None:
    lines = [time.strftime("%Y-%m-%d %H:%M:%S")]
    try:
        lines.append(subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__))).stdout.strip())
    except Exception:
        pass
    with open(os.path.join(data_dir, "modify_dataset_log.txt"), "a") as f:
        f.write("\n".join(lines) + "\n")


def enrich_frame(npy_item: Dict, joint_json: Dict, cfg: Config,
                 prev_root_translation: Optional[np.ndarray]) -> Dict:
    """Enrich one frame dict from its JSON metadata (pure; unit-testable)."""
    sk = get_skeleton(cfg.joint_preset)
    parents = sk.parents_array()
    joints = joint_json["joints"]
    ground_z = joint_json["ground_z_value"]

    # pelvis heatmaps appended to the per-joint stacks
    for side in ("left", "right"):
        key = f"gt_heatmap_{side}"
        pelvis_2d = np.asarray(joints["pelvis"][f"camera_{side}_pts2d"])
        npy_item[key] = np.concatenate(
            [npy_item[key], pts2d_to_heatmap(pelvis_2d)[None]], axis=0)
        npy_item[f"gt_pelvis_{side}"] = np.asarray(
            joints["pelvis"][f"camera_{side}_pts3d"])

    J = sk.num_joints
    pts2d = {s: np.zeros((J, 2), np.float32) for s in ("left", "right")}
    pts3d = {s: np.zeros((J, 3), np.float32) for s in ("left", "right")}
    global_pose = np.zeros((J, 3), np.float32)
    for i, name in enumerate(sk.joint_names):
        for s in ("left", "right"):
            pts2d[s][i] = joints[name][f"camera_{s}_pts2d"]
            pts3d[s][i] = joints[name][f"camera_{s}_pts3d"]
        gp = np.asarray(joints[name]["trans"], dtype=np.float32).copy()
        gp[2] -= ground_z
        global_pose[i] = gp

    for s in ("left", "right"):
        hm, lengths, theta = limb_data(pts2d[s], pts3d[s], parents)
        npy_item[f"gt_limb_heatmap_{s}"] = hm
        npy_item[f"gt_pixel_length_{s}"] = lengths
        if s == "left":
            npy_item["gt_limb_theta"] = theta

    npy_item["gt_global_pose"] = global_pose
    npy_item["gt_camera_2d_left"] = pts2d["left"]
    npy_item["gt_camera_2d_right"] = pts2d["right"]

    root_translation = np.asarray(joints["pelvis"]["trans"],
                                  dtype=np.float64).copy()
    root_translation[2] -= ground_z
    npy_item["gt_root_translation"] = root_translation
    if prev_root_translation is not None:
        npy_item["gt_root_translation_delta"] = \
            root_translation - prev_root_translation
    npy_item["gt_root_rotation"] = ur2r(np.asarray(joints["pelvis"]["rot"]))
    npy_item["gt_local_rot"] = local_rot(npy_item["gt_local_pose"], parents)
    npy_item["raw_joint_data"] = joints
    return npy_item


def reprocess(cfg: Config, modes=("train", "validation", "test")) -> int:
    """Run the full reprocessing pass. Returns the number of failed
    sequences (missing JSON metadata)."""
    os.makedirs(cfg.data_dir, exist_ok=True)
    _provenance(cfg.data_dir)
    stats: Dict[str, ArrayRunningStd] = {}
    fail_cnt = 0

    for mode in modes:
        seqs = _resolve_sequences(cfg, mode)
        # copy list file into data_dir (reference :50-54)
        with open(os.path.join(cfg.data_dir,
                               cfg.data_prefix + mode + ".txt"), "w") as f:
            for s in seqs:
                for metadir in cfg.metadata_dir:
                    s = s.replace(metadir, cfg.default_data_path, 1)
                f.write(s + "\n")

        for seq in seqs:
            frame_dir = os.path.join(seq, cfg.data_sub_path)
            npy_paths = natsorted(
                [os.path.join(frame_dir, p) for p in os.listdir(frame_dir)
                 if p.endswith(".npy")])
            json_dir = os.path.join(seq, "json")
            prev_root = None
            ok = True
            frames = []
            for p in npy_paths:
                jp = os.path.join(
                    json_dir, os.path.basename(p)[:-4] + ".json")
                if not os.path.exists(jp):
                    ok = False
                    break
                frames.append((p, jp))
            if not ok:
                fail_cnt += 1
                continue

            out_dir = frame_dir
            for metadir in cfg.metadata_dir:
                out_dir = out_dir.replace(metadir, cfg.data_dir, 1)
            os.makedirs(out_dir, exist_ok=True)

            for idx, (p, jp) in enumerate(frames):
                item = np.load(p, allow_pickle=True).item()
                with open(jp) as f:
                    meta = json.load(f)
                item = enrich_frame(item, meta, cfg, prev_root)
                prev_root = item["gt_root_translation"]
                if idx == 0:
                    continue  # first frame has no translation delta
                for k in ("gt_local_pose", "gt_root_translation",
                          "gt_root_translation_delta", "gt_root_rotation"):
                    stats.setdefault(k, ArrayRunningStd()).update(
                        np.asarray(item[k], dtype=np.float64))
                if not cfg.experiment:
                    np.save(os.path.join(out_dir, os.path.basename(p)),
                            np.array(item, dtype=object), allow_pickle=True)

    meanstd = {}
    for k, s in stats.items():
        std = s.std if s.count > 1 else np.ones_like(np.asarray(s.mean))
        std = np.where(std < 0.001, 1.0, std)
        meanstd[k] = (np.asarray(s.mean), std)
    if not cfg.experiment:
        np.save(os.path.join(cfg.data_dir, "meanstd"),
                np.array(meanstd, dtype=object), allow_pickle=True)
    return fail_cnt
