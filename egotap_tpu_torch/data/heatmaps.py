"""Heatmap targets on the host: the reference's numpy renderer.

The port's own copy of `egotap_tpu/data/heatmaps.py`, with the
reference's CPU semantics (constants, truncations, boundary modes). The
constants and the 1-D kernel are also what the device renderer
(`data/device_render.py`) reads. The renderer runs offline, in the
preprocessors (`preprocess/`):
  * `coord2d_to_heatmap`: Gaussian peaks, sigma 1, a 4 sigma margin,
    peaks normalised to 1.0 by the discrete kernel's constant (reference
    utils/projection.py:263-279);
  * `line_aa`, `line_heatmap`: Xiaolin Wu anti-aliased lines with
    integer endpoints (skimage.draw.line_aa; utils/data.py:174-185);
  * `limb_data`: per-bone line heatmaps, pixel lengths (+1.0) and
    elevation angles (utils/data.py:197-252);
  * `sin_limb_heatmaps`: the (cos, sin)-modulated limb channels
    (dataloader/data_loader.py:193-199);
  * `pts2d_to_heatmap`, `heatmap_to_camera2d`, `pseudo_limb_mask`,
    `sample_limb_heatmaps`, `pose_image`: the reference's other
    renderers (utils/data.py:76-93, utils/projection.py:165-335).
OpenCV is imported only by `pseudo_limb_mask`, so the module imports
without it.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

# Peak value of a discrete 2D Gaussian (sigma=1, radius=4) kernel; dividing
# by it normalizes rendered peaks to exactly 1.0 (reference
# utils/projection.py:235, 278). A parity quirk: kept as the reference
# states it, not recomputed from the kernel.
GAUSSIAN_PEAK = 0.15915589174187972

COORD_SPACE = 1024.0  # 2D joint coordinates live in 1024x1024 pixel space.


def gaussian_kernel1d(sigma: float = 1.0, radius: int = 4) -> np.ndarray:
    """scipy.ndimage's discrete Gaussian kernel (normalized to sum 1)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x ** 2)
    return phi / phi.sum()


def coord2d_to_heatmap(coord2d: np.ndarray, res: int = 64,
                       sigma: float = 1.0) -> np.ndarray:
    """Render per-joint Gaussian-peak heatmaps.

    coord2d: (J, 2) pixel coordinates in 1024-space. Returns (J, res, res)
    float32 with in-view peaks == 1.0. Exact reference semantics, including
    int() truncation toward zero and the asymmetric in-view test
    (-4 <= y < res+4 but -4 <= x < res).
    """
    hm = np.zeros((coord2d.shape[0], res, res), dtype=np.float32)
    margin = int(4 * sigma)
    margin_res = res + margin * 2
    for i in range(coord2d.shape[0]):
        pos = coord2d[i] / COORD_SPACE * res
        x, y = pos[0], pos[1]
        expanded = np.zeros((margin_res, margin_res), dtype=np.float32)
        if -4 <= y < res + 4 and -4 <= x < res:
            expanded[int(y) + margin, int(x) + margin] = 1.0
        expanded = gaussian_filter(expanded, sigma=sigma)
        hm[i] = expanded[margin:-margin, margin:-margin]
    hm /= GAUSSIAN_PEAK
    return hm


def line_aa(r0: int, c0: int, r1: int, c1: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Anti-aliased line (Wu's method) with integer endpoints.

    Returns (rr, cc, val) index/weight arrays, skimage.draw.line_aa-style.
    """
    r0, c0, r1, c1 = int(r0), int(c0), int(r1), int(c1)
    steep = abs(r1 - r0) > abs(c1 - c0)
    if steep:
        r0, c0, r1, c1 = c0, r0, c1, r1
    if c0 > c1:
        r0, c0, r1, c1 = r1, c1, r0, c0

    dc = c1 - c0
    grad = (r1 - r0) / dc if dc != 0 else 0.0

    cs = np.arange(c0, c1 + 1)
    ys = r0 + grad * (cs - c0)
    fl = np.floor(ys)
    frac = ys - fl
    fl = fl.astype(np.int64)

    rr = np.concatenate([fl, fl + 1])
    cc = np.concatenate([cs, cs])
    val = np.concatenate([1.0 - frac, frac])

    if steep:
        rr, cc = cc, rr
    return rr, cc, val.astype(np.float64)


def line_heatmap(p_coord: np.ndarray, coord: np.ndarray,
                 res: int = 64) -> np.ndarray:
    """Rasterize one AA line segment into a (res, res) image.

    p_coord/coord are float (x, y) pixel positions in res-space; they are
    rounded to the nearest integer first (reference utils/data.py:175-185;
    indexing is image[y, x] with out-of-range pixels dropped).
    """
    img = np.zeros((res, res), dtype=np.float64)
    p = np.rint(np.asarray(p_coord)).astype(int)
    q = np.rint(np.asarray(coord)).astype(int)
    rr, cc, val = line_aa(p[0], p[1], q[0], q[1])
    ok = (rr >= 0) & (rr <= res - 1) & (cc >= 0) & (cc <= res - 1)
    img[cc[ok], rr[ok]] = val[ok]
    return img


def limb_data(pts2d: np.ndarray, pts3d: np.ndarray, parents: np.ndarray,
              res: int = 64, sigma: float = 1.0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-bone limb heatmaps, pixel lengths and elevation angles.

    pts2d: (J, 2) in 1024-space; pts3d: (J, 3); parents: (J,) kinematic
    parents. Returns:
      heatmaps (J-1, res, res) float32 — blurred AA lines (constant-mode
        Gaussian, scaled by sigma),
      lengths (J-1,) float32 — ||p2d_parent - p2d_child||/divider + 1.0,
      theta (J-1,) float32 — arctan(dz / ||dxy||) of parent - child in 3D.

    Reference: utils/data.py:197-252 (htype='line', area == res).
    """
    num_joints = len(parents)
    heatmaps = np.zeros((num_joints - 1, res, res), dtype=np.float32)
    lengths = np.zeros(num_joints - 1, dtype=np.float32)
    theta = np.zeros(num_joints - 1, dtype=np.float32)
    divider = COORD_SPACE / res

    for joint in range(1, num_joints):
        b = joint - 1
        parent = parents[joint]
        p_coord = pts2d[parent] / divider
        coord = pts2d[joint] / divider

        limb_3d = pts3d[parent] - pts3d[joint]
        # The reference divides unguarded (utils/data.py:230): a vertical
        # limb gives arctan(+-inf) = +-pi/2 (kept), but a fully zero-length
        # limb gives 0/0 = NaN which would poison sin/cos training targets.
        # Deliberate divergence: degenerate limbs use the analytic limit
        # (sign(dz)*pi/2, i.e. 0 when dz == 0 too).
        dxy = np.linalg.norm(limb_3d[:2])
        if dxy == 0.0:
            theta[b] = math.copysign(math.pi / 2, limb_3d[2]) \
                if limb_3d[2] != 0.0 else 0.0
        else:
            theta[b] = np.arctan(limb_3d[2] / dxy)
        lengths[b] = np.linalg.norm(p_coord - coord) + 1.0

        img = line_heatmap(p_coord, coord, res)
        img = gaussian_filter(img, sigma=sigma, mode="constant")
        heatmaps[b] = img * sigma

    return heatmaps, lengths, theta


def sin_limb_heatmaps(raw_limb: np.ndarray, theta: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin)-modulated limb channel pair ("sin" heatmap type).

    raw_limb: (L, H, W) already x2-scaled limb maps; theta: (L,).
    Reference dataloader/data_loader.py:193-199.
    """
    cos_hm = raw_limb * np.cos(theta)[:, None, None]
    sin_hm = raw_limb * np.sin(theta)[:, None, None]
    return cos_hm, sin_hm


def pts2d_to_heatmap(coord: np.ndarray, res: int = 64,
                     area: int = 64) -> np.ndarray:
    """Point-peak heatmap with optional area padding (reference
    utils/data.py:76-93). Quirk preserved: the Gaussian blur + peak
    normalization run inside the per-point loop, so with multiple points
    earlier peaks get blurred repeatedly."""
    heatmap = np.zeros((area, area), dtype=np.float32)
    coord = np.asarray(coord)
    if coord.ndim == 1:
        coord = coord[None, :]
    for c in coord:
        hm_coord = np.rint(c / (COORD_SPACE / res)).astype(int)
        hm_coord = hm_coord + (area - res) // 2
        if 0 <= hm_coord[0] < area and 0 <= hm_coord[1] < area:
            heatmap[hm_coord[1], hm_coord[0]] = 1
            heatmap = gaussian_filter(heatmap, sigma=1)
            heatmap /= GAUSSIAN_PEAK
    return heatmap


def heatmap_to_camera2d(heatmap: np.ndarray) -> np.ndarray:
    """Inverse of the peak render: exact-1.0 peak location per map, -1 for
    out-of-view maps (reference utils/projection.py:240-253). Returns
    (..., 2) as (row, col) like the reference's argwhere convention."""
    coord_shape = list(heatmap.shape)
    coord_shape.pop(-1)
    coord_shape[-1] = 2
    oos = np.all(heatmap != 1.0, axis=(-1, -2))
    coords = np.zeros(coord_shape, dtype=np.float32)
    coords[oos] = -1.0
    for v in np.argwhere(heatmap == 1.0):
        coords[tuple(v[:-2])] = v[-2:]
    return coords


def pseudo_limb_mask(pts2d: np.ndarray, limb_mask_indices,
                     res: int = 256) -> np.ndarray:
    """EgoGlass-style pseudo limb segmentation masks via thick lines
    (reference utils/projection.py:165-191; thickness 10 * res/256)."""
    import cv2
    thickness = 10 * res // 256
    mask = np.zeros((len(limb_mask_indices), res, res))
    pose = pts2d * res / COORD_SPACE
    for i, limb in enumerate(limb_mask_indices):
        for parent, child in zip(limb[:-1], limb[1:]):
            cv2.line(mask[i], tuple(map(int, pose[parent])),
                     tuple(map(int, pose[child])), 255, thickness)
    return (mask > 0).astype(np.float32)


def sample_limb_heatmaps(camera_pose_2d: np.ndarray,
                         camera_pose_depth: np.ndarray,
                         parents: np.ndarray, res: int = 64,
                         weight_depth: bool = False,
                         depth_scale: float = 1.0,
                         depth_offset: float = 0.0) -> np.ndarray:
    """Per-limb AA line heatmaps with optional depth weighting
    (reference utils/projection.py:291-335).

    camera_pose_2d: (J, 2) joint pixel coordinates in 1024-space;
    camera_pose_depth: (J,) camera-frame z per joint; parents: kinematic
    parents. Returns (num_limbs, res, res) float32 where limb i connects
    joint i+2 to its parent (the reference's assign_idx = joint_idx - 2
    convention — joints 0/1 are treated as roots with no own limb map).

    Depth weighting (weight_depth=True): each line pixel's AA value is
    multiplied by the depth linearly interpolated between the two
    endpoints (clamped to >= 0), then scaled/offset. Reference quirks
    preserved:
      * a degenerate (zero-length) limb uses min(parent, child) depth and
        skips depth_scale/depth_offset (projection.py:318-325 applies
        them only in the non-degenerate branch);
      * the blur is scipy's default reflect-mode Gaussian (sigma=1), with
        no peak normalization.

    Documented divergence: the reference iterates joint_idx over
    range(2, len(parents)+2) and indexes kinematic_parents[joint_idx],
    which is out of bounds for both shipped presets (16/18-entry parent
    lists) — the function raises IndexError upstream and is unreachable
    from any shipped config. We bound the loop to the real joint count,
    implementing the evident intent.
    """
    num_joints = len(parents)
    num_limbs = num_joints - 2
    out = np.zeros((num_limbs, res, res), dtype=np.float32)
    divider = COORD_SPACE / res

    for joint_idx in range(2, num_joints):
        assign_idx = joint_idx - 2
        parent_idx = parents[joint_idx]
        p_coord = np.rint(camera_pose_2d[parent_idx] / divider).astype(int)
        coord = np.rint(camera_pose_2d[joint_idx] / divider).astype(int)

        hm = np.zeros((res, res), dtype=np.float32)
        rr, cc, val = line_aa(p_coord[0], p_coord[1], coord[0], coord[1])

        if weight_depth:
            p_depth = max(0.0, float(camera_pose_depth[parent_idx]))
            depth = max(0.0, float(camera_pose_depth[joint_idx]))
            p_dist = np.sqrt((rr - p_coord[0]) ** 2 + (cc - p_coord[1]) ** 2)
            dist = np.sqrt((rr - coord[0]) ** 2 + (cc - coord[1]) ** 2)
            if np.any(np.isclose(p_dist + dist, 0.0)):
                val = val * min(p_depth, depth)
            else:
                t = p_dist / (p_dist + dist)
                val = val * ((1 - t) * p_depth + t * depth)
                val = val * depth_scale + depth_offset

        ok = (rr >= 0) & (rr <= res - 1) & (cc >= 0) & (cc <= res - 1)
        hm[cc[ok], rr[ok]] = val[ok]
        out[assign_idx] = gaussian_filter(hm, sigma=1)
    return out


def pose_image(camera_pose_2d: np.ndarray, parents: np.ndarray,
               res: int = 64, weight_depth: bool = False,
               camera_pose_depth: np.ndarray = None) -> np.ndarray:
    """Full-skeleton line image (reference utils/projection.py:194-237):
    per-bone AA lines max-combined, blurred, peak-normalized, x0.01.

    weight_depth=True (the reference signature's default, though the
    function has zero call sites upstream): each bone's AA values are
    multiplied by the depth linearly interpolated between its endpoint
    depths (each clamped to >= 0). Reference quirks preserved:
      * a degenerate bone (any pixel with p_distance + distance == 0,
        i.e. a single-pixel line) sets t = 0 for the WHOLE bone, so the
        pixel gets the PARENT's depth (projection.py:216-221) — unlike
        sample_limb_heatmaps' min-depth rule;
      * no depth_scale/depth_offset exist here (they are
        sample_limb_heatmaps-only knobs).
    """
    if weight_depth and camera_pose_depth is None:
        raise ValueError("weight_depth=True requires camera_pose_depth")
    img = np.zeros((res, res), dtype=np.float64)
    for joint in range(1, len(parents)):
        p = np.rint(camera_pose_2d[parents[joint]] * res / COORD_SPACE
                    ).astype(int)
        q = np.rint(camera_pose_2d[joint] * res / COORD_SPACE).astype(int)
        line = np.zeros((res, res), dtype=np.float64)
        rr, cc, val = line_aa(p[0], p[1], q[0], q[1])
        if weight_depth:
            p_depth = max(0.0, float(camera_pose_depth[parents[joint]]))
            depth = max(0.0, float(camera_pose_depth[joint]))
            p_dist = np.sqrt((rr - p[0]) ** 2 + (cc - p[1]) ** 2)
            dist = np.sqrt((rr - q[0]) ** 2 + (cc - q[1]) ** 2)
            if np.any(p_dist + dist == 0):
                t = 0.0
            else:
                t = p_dist / (p_dist + dist)
            val = val * ((1 - t) * p_depth + t * depth)
        ok = (rr >= 0) & (rr < res) & (cc >= 0) & (cc < res)
        line[cc[ok], rr[ok]] = val[ok]
        img = np.maximum(img, line)
    img = gaussian_filter(img, sigma=1)
    img /= GAUSSIAN_PEAK
    return img * 0.01
