"""Image/visualization helpers; the port's own copy of
`egotap_tpu/utils/images.py` (reference utils/util.py:160-215, 430-459).

ImageNet normalization constants and the heatmap-sum visualization used by
``get_current_visuals`` live here; arrays are numpy, channel-last.
"""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def normalize_imagenet(x: np.ndarray) -> np.ndarray:
    """(..., 3) float [0,1] -> ImageNet-normalized."""
    return (x - IMAGENET_MEAN) / IMAGENET_STD


def denormalize_imagenet(x: np.ndarray) -> np.ndarray:
    return x * IMAGENET_STD + IMAGENET_MEAN


def tensor2im(image: np.ndarray, is_heatmap: bool = False,
              is_depth: bool = False, bytes_scale: float = 255.0
              ) -> np.ndarray:
    """(H, W, C) float -> uint8 visualization (reference tensor2im,
    utils/util.py:160-175): heatmaps are channel-summed and clamped;
    RGB is ImageNet-denormalized."""
    img = np.asarray(image, dtype=np.float32)
    if is_depth:
        img = img * bytes_scale
    elif is_heatmap:
        img = np.clip(img.sum(axis=-1, keepdims=True), 0.0, 1.0) * bytes_scale
    else:
        img = denormalize_imagenet(img) * bytes_scale
    return img.astype(np.uint8)


def convert_norm_angle_to_rgb(cos_hm: np.ndarray, sin_hm: np.ndarray
                              ) -> np.ndarray:
    """Sin/cos limb-heatmap pair -> (..., 3) norm/angle visualization
    (reference utils/data.py:265-276): channel 0 = atan2 angle / pi,
    channel 1 = magnitude rescaled to [-1, 1], channel 2 = 1.

    Documented upstream bug: the reference writes into a torch
    ``.expand()`` view, which raises RuntimeError at runtime (the
    function has zero call sites); this implements the evident intent
    with a stack."""
    cos_hm = np.asarray(cos_hm, dtype=np.float32)
    sin_hm = np.asarray(sin_hm, dtype=np.float32)
    norm = np.sqrt(cos_hm ** 2 + sin_hm ** 2)
    angle = np.arctan2(sin_hm, cos_hm)
    return np.stack(
        [angle / np.pi, norm * 2.0 - 1.0, np.ones_like(norm)], axis=-1)


def save_image(img: np.ndarray, path: str) -> None:
    from PIL import Image
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[:, :, 0]
    Image.fromarray(img).save(path)
