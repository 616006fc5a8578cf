"""The constants of the heatmap targets, numpy only.

The port's own copy of what `egotap_tpu/data/heatmaps.py:32-42` gives
the device renderer (`data/device_render.py`): the 1024-pixel
coordinate space of the 2D joints, the peak of the discrete Gaussian
and its 1-D kernel. The numpy twins of the host renderer (Gaussian
peaks, Wu lines, limb data) come with the data slice.
"""

from __future__ import annotations

import numpy as np

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
