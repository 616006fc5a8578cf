"""Dataset discovery + per-frame host loading.

The port's own copy of `egotap_tpu/data/dataset.py`. Mirrors the
reference list-file protocol (dataloader/image_folder.py:7-75): a
``{data_prefix}{mode}.txt`` file lists sequence directories (with
``default_data_path`` tokens rewritten to ``data_dir``); each sequence
holds ``{data_sub_path}/frame_*.npy`` pickle dicts (natural-sorted).
Motion-category filtering matches on the 4th-from-last path component.

Host work is intentionally minimal — raw arrays only; heatmap/limb target
rendering happens on the device (`egotap_tpu_torch.data.pipeline`), unlike
the reference which renders everything in DataLoader workers
(dataloader/data_loader.py:76-215).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

from egotap_tpu_torch.core.config import Config

_NAT_SPLIT = re.compile(r"(\d+)")


def natsorted(items: Sequence[str]) -> List[str]:
    def key(s: str):
        return [int(t) if t.isdigit() else t for t in _NAT_SPLIT.split(s)]
    return sorted(items, key=key)


def make_dataset(cfg: Config, mode: str,
                 category_id: Optional[str] = None) -> List[str]:
    """Resolve the frame-file list for a split (optionally one motion
    category)."""
    list_path = os.path.join(cfg.data_dir, cfg.data_prefix + mode + ".txt")
    with open(list_path) as f:
        seq_paths = [s.strip() for s in f.readlines() if s.strip()]

    frames: List[str] = []
    for path in seq_paths:
        path = path.replace(cfg.default_data_path, cfg.data_dir, 1)
        full = os.path.join(path, cfg.data_sub_path, "*")
        if category_id is not None:
            if full.split("/")[-4] != category_id:
                continue
        frames += natsorted(glob.glob(full))
        if cfg.experiment and len(frames) >= 100:
            frames = frames[:100]
            break
    return frames


# Keys pulled from each frame dict (reprocess_unrealego_data.py schema).
_FRAME_KEYS = (
    "input_rgb_left", "input_rgb_right",
    "gt_camera_2d_left", "gt_camera_2d_right",
    "gt_local_pose", "gt_local_rot",
    "gt_pelvis_left", "gt_pelvis_right",
)


def load_frame(path: str, stereo: bool = True) -> Dict[str, np.ndarray]:
    """Load one frame dict -> raw float32 arrays (images as (H, W, 3))."""
    data = np.load(path, allow_pickle=True).item()
    out: Dict[str, np.ndarray] = {}
    for k in _FRAME_KEYS:
        if not stereo and k.endswith("_right"):
            # mono: mirror left into right (reference
            # dataloader/data_loader.py:106-108, 120-121)
            src = data[k.replace("_right", "_left")]
        else:
            src = data[k]
        arr = np.asarray(src, dtype=np.float32)
        if k.startswith("input_rgb"):
            arr = np.ascontiguousarray(arr.transpose(1, 2, 0))  # CHW->HWC
        out[k] = arr
    out["path"] = path  # type: ignore[assignment]
    return out


class FrameDataset:
    """Indexable view over the resolved frame list."""

    def __init__(self, cfg: Config, mode: str,
                 category_id: Optional[str] = None):
        self.cfg = cfg
        self.mode = mode
        self.paths = make_dataset(cfg, mode, category_id)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return load_frame(self.paths[idx], stereo=self.cfg.stereo)
