"""Dataset integrity checking; the port's own copy of
`egotap_tpu/data/integrity.py` (reference check_dataset.py:15-137 +
image_folder.py check_integrity mode).

Validates that every listed sequence exists and its frame files load,
writes ``inuse_{mode}.txt`` (sequences actually present),
``corrupt_{mode}.txt`` (unloadable frames) and ``missing_{mode}.txt``
(sequences with gaps), and reports per-motion-category frame counts.

``check_raw`` covers the reference checker's optional raw-dataset
branches (check_dataset.py:48-137): per valid frame, verify the sibling
raw JSON metadata parses (``{meta}/json/frame_XXXX.json``) and the
fisheye depth / RGB PNGs decode
(``{meta}/fisheye_{depth,final}_image/camera_{left,right}/
{depth,final}_XXXX.png``), resolving the metadata root through
``cfg.metadata_dir`` fallbacks exactly like the reference (first
candidate directory that exists; the npy root itself when none is
configured). Writes ``corrupt_{json,depth,rgb}.txt`` into ``data_dir``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.data.dataset import natsorted

REQUIRED_KEYS = ("input_rgb_left", "gt_camera_2d_left",
                 "gt_local_pose", "gt_pelvis_left")


def _metadata_root(frame_path: str, data_dir: str,
                   metadata_dirs) -> Optional[str]:
    """The sequence's raw-metadata dir: dirname(frame)/.. with data_dir
    swapped for the first metadata_dir candidate that exists (reference
    check_dataset.py:76-82). Falls back to the npy tree itself."""
    head = os.path.dirname(frame_path)
    seq_dir = os.path.normpath(os.path.join(head, os.pardir))
    for metadir in tuple(metadata_dirs) + (data_dir,):
        cand = seq_dir.replace(data_dir, metadir, 1)
        if os.path.isdir(cand):
            return cand
    return None


def check_raw_frame(frame_path: str, data_dir: str, metadata_dirs=(),
                    check_json: bool = True, check_depth: bool = True,
                    check_rgb: bool = True) -> Dict[str, List[str]]:
    """Raw-file verification for ONE frame npy (reference
    check_dataset.py:83-114): JSON parses, depth/RGB PNGs decode.
    Returns {'json': [...bad...], 'depth': [...], 'rgb': [...]} — a
    missing file counts as corrupt, like the reference's bare except."""
    bad: Dict[str, List[str]] = {"json": [], "depth": [], "rgb": []}
    tail = os.path.basename(frame_path)          # frame_XXXX.npy
    root = _metadata_root(frame_path, data_dir, metadata_dirs)
    if root is None:
        # no metadata tree at all: every requested file is missing
        root = os.path.normpath(
            os.path.join(os.path.dirname(frame_path), os.pardir))
    if check_json:
        jpath = os.path.join(root, "json", tail[:-4] + ".json")
        try:
            with open(jpath) as f:
                json.load(f)
        except Exception:
            bad["json"].append(jpath)
    suffix = tail[5:-4]                          # "frame_XXXX.npy" -> "_XXXX"
    for kind, subdir, stem, on in (
            ("depth", "fisheye_depth_image", "depth", check_depth),
            ("rgb", "fisheye_final_image", "final", check_rgb)):
        if not on:
            continue
        for side in ("camera_left", "camera_right"):
            ipath = os.path.join(root, subdir, side, stem + suffix + ".png")
            try:
                from PIL import Image
                Image.open(ipath).verify()
            except Exception:
                bad[kind].append(ipath)
    return bad


def check_split(cfg: Config, mode: str,
                check_keys: bool = True,
                write_reports: bool = True,
                check_raw=False) -> Dict:
    """``check_raw``: False = npy-only (default), True = all three raw
    branches, or an iterable subset of {'json', 'depth', 'rgb'} matching
    the reference's independent --check_* flags."""
    if check_raw is True:
        raw_kinds = ("json", "depth", "rgb")
    elif check_raw:
        raw_kinds = tuple(check_raw)
    else:
        raw_kinds = ()
    list_path = os.path.join(cfg.data_dir, cfg.data_prefix + mode + ".txt")
    with open(list_path) as f:
        seq_paths = [s.strip() for s in f.readlines() if s.strip()]

    inuse: List[str] = []
    missing: List[str] = []
    corrupt: List[str] = []
    corrupt_raw: Dict[str, List[str]] = {"json": [], "depth": [], "rgb": []}
    category_counts: Dict[str, int] = {}
    n_frames = 0

    for orig in seq_paths:
        path = orig.replace(cfg.default_data_path, cfg.data_dir, 1)
        frame_dir = os.path.join(path, cfg.data_sub_path)
        frames = natsorted(glob.glob(os.path.join(frame_dir, "*.npy")))
        if not frames:
            missing.append(frame_dir)
            continue
        inuse.append(orig)
        category = frame_dir.rstrip("/").split("/")[-3]
        for p in frames:
            try:
                item = np.load(p, allow_pickle=True).item()
                if check_keys:
                    for k in REQUIRED_KEYS:
                        if k not in item:
                            raise KeyError(k)
            except Exception:
                corrupt.append(p)
                continue  # raw files checked only for valid npys
                          # (reference check_dataset.py:74)
            n_frames += 1
            category_counts[category] = category_counts.get(category, 0) + 1
            if raw_kinds:
                bad = check_raw_frame(
                    p, cfg.data_dir, cfg.metadata_dir,
                    check_json="json" in raw_kinds,
                    check_depth="depth" in raw_kinds,
                    check_rgb="rgb" in raw_kinds)
                for kind, lst in bad.items():
                    corrupt_raw[kind].extend(lst)

    if write_reports:
        def _write(name, lines):
            with open(os.path.join(cfg.data_dir, f"{name}_{mode}.txt"), "w") as f:
                f.write("\n".join(lines) + ("\n" if lines else ""))
        _write("inuse", inuse)
        _write("corrupt", corrupt)
        _write("missing", missing)
        # reference filenames (check_dataset.py:116-137), sorted
        for kind in raw_kinds:
            with open(os.path.join(cfg.data_dir,
                                   f"corrupt_{kind}_{mode}.txt"), "w") as f:
                lines = sorted(corrupt_raw[kind])
                f.write("\n".join(lines) + ("\n" if lines else ""))

    return {
        "mode": mode,
        "sequences": len(seq_paths),
        "sequences_present": len(inuse),
        "frames": n_frames,
        "corrupt": corrupt,
        "missing": missing,
        "corrupt_raw": corrupt_raw,
        "category_counts": category_counts,
    }
