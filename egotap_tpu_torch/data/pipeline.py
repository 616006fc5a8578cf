"""The batch preprocess: a raw batch in, the model feed with its targets
out, on the batch's device.

Counterpart of `egotap_tpu/data/pipeline.py:make_device_preprocess`
(reference dataloader/data_loader.py:76-215, which renders the targets
per frame on the host):
  * joint heatmaps from the 2D joints [1:], peak-normalized   (:90-95)
  * limb line maps x2 and per-side pixel lengths              (:123-127)
  * sin-type (cos, sin) channels from the LEFT camera's theta (:193-199)
  * tail-slicing to num_heatmap / num_rot_heatmap             (:149-164)
  * the head-relative pose when the root is not estimated     (:153-157)
  * plength tiled limb_dim times                              (:210-214)

The loaders (`BatchLoader`, padding with a validity mask, prefetch)
come with the data slice.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import set_f32_numerics
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.data import device_render as dr

Batch = Dict[str, torch.Tensor]


def _resize(rgb: torch.Tensor, size: int) -> torch.Tensor:
    """(B, h, w, 3) -> (B, size, size, 3) as ``jax.image.resize(...,
    "bilinear")`` resizes: half-pixel centres, a triangle filter widened
    by the scale when it shrinks the image (antialiasing), weights that
    fall outside the image dropped and the rest renormalised."""
    out = F.interpolate(rgb.permute(0, 3, 1, 2), size=(size, size),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1).contiguous()


def make_device_preprocess(cfg: Config) -> Callable[[Batch], Batch]:
    """The raw batch -> model-feed transform of ``cfg``.

    The raw batch holds ``input_rgb_left`` / ``_right`` (B, h, w, 3),
    ``gt_camera_2d_left`` / ``_right`` (B, J, 2) in 1024-space,
    ``gt_local_pose`` (B, J, 3), ``gt_local_rot``, ``gt_pelvis_left`` /
    ``_right`` (B, 3) and ``mask`` (B,), all on one device. The feed:
    ``input_rgb`` (B, 2, S, S, 3) f32 at the config's image size S,
    ``gt_heatmap_{side}`` (B, r, r, num_heatmap), and for limb configs
    ``gt_limb_heatmap_{side}`` (B, r, r, num_rot_heatmap * limb_dim),
    ``gt_plength_{side}`` and ``gt_limb_theta``, then the pose, rotation,
    pelvis and mask rows."""
    sk = get_skeleton(cfg.joint_preset)
    parents = sk.parents
    res = cfg.heatmap_res
    nh, nr, ld = cfg.num_heatmap, cfg.num_rot_heatmap, cfg.limb_dim
    set_f32_numerics()              # the limb blur's products in full f32

    def preprocess(batch: Batch) -> Batch:
        out: Batch = {}
        rgb_l = batch["input_rgb_left"].float()   # f16-packed splits too
        rgb_r = batch["input_rgb_right"].float()
        if rgb_l.shape[1] != cfg.image_size:
            rgb_l = _resize(rgb_l, cfg.image_size)
            rgb_r = _resize(rgb_r, cfg.image_size)
        out["input_rgb"] = torch.stack([rgb_l, rgb_r], dim=1)

        pose = batch["gt_local_pose"]                    # (B, J, 3)
        pelvis_l = batch["gt_pelvis_left"]
        pelvis_r = batch["gt_pelvis_right"]

        if nh > 0:
            for side in ("left", "right"):
                hm = dr.render_joint_heatmaps(
                    batch[f"gt_camera_2d_{side}"][:, 1:], res)
                hm = hm[:, -nh:] if nh < sk.num_heatmaps else hm
                out[f"gt_heatmap_{side}"] = hm.permute(0, 2, 3, 1)

        if nr > 0 and ld > 0:
            pts3d_l = pose + pelvis_l[:, None, :]
            pts3d_r = pose + pelvis_r[:, None, :]
            theta = dr.limb_theta(pts3d_l, parents)      # (B, J-1), LEFT
            for side in ("left", "right"):
                raw, plen = dr.render_limb_heatmaps(
                    batch[f"gt_camera_2d_{side}"], parents, res)
                raw = raw * 2.0                          # (:127) x2 scale
                raw, plen, th = raw[:, -nr:], plen[:, -nr:], theta[:, -nr:]
                if cfg.heatmap_type == "sin":
                    limb = torch.cat(dr.sin_limb_heatmaps(raw, th), dim=1)
                else:                                    # "limb"
                    limb = raw
                out[f"gt_limb_heatmap_{side}"] = limb.permute(0, 2, 3, 1)
                out[f"gt_plength_{side}"] = plen.repeat(1, ld)
            out["gt_limb_theta"] = theta[:, -nr:]

        if cfg.joint_preset == "UnrealEgo" and not cfg.estimate_head:
            pose = pose + pelvis_l[:, None, :]
            pelvis_l = torch.zeros_like(pelvis_l)
            pelvis_r = torch.zeros_like(pelvis_r)

        out["gt_local_pose"] = pose if cfg.estimate_head else pose[:, 1:]
        out["gt_local_rot"] = batch["gt_local_rot"]
        out["gt_pelvis_left"] = pelvis_l
        out["gt_pelvis_right"] = pelvis_r
        out["mask"] = batch["mask"]
        return out

    return preprocess
