"""Heatmap targets rendered from 2D joints on the tensors' device.

Counterpart of `egotap_tpu/data/device_render.py`: the reference renders
every training target on the host inside its DataLoader workers
(reference dataloader/data_loader.py:76-215); here the targets are made
from the (J, 2) / (J, 3) coordinates of a whole batch at once, every
joint and bone in one set of batched tensor operations (no loop over
them), on the card for a CUDA batch.

Numerics follow the JAX twin operation for operation, so the targets
agree with it to f32 rounding:
  * Gaussian peaks: the closed-form blurred delta, with scipy's
    'reflect' boundary handling of the 4-pixel margin; ``coords /
    COORD_SPACE * res`` in that order and ``trunc`` placement.
  * AA limb lines: the dense Wu formulation (per-pixel closed form) at
    ``rint`` (half to even) endpoints ``coords / (COORD_SPACE / res)``,
    then a constant-mode separable Gaussian as two banded products. On
    the card these must run in full f32 (`core.device.set_f32_numerics`):
    a TF32 product moves a target by 1e-3 of its peak.
Divisions by a constant that is not a power of two go through an f32
tensor, not a Python scalar: CUDA divides a tensor by a host scalar as
a product with its reciprocal, which may differ in the last bit.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

from egotap_tpu_torch.data.heatmaps import (COORD_SPACE, GAUSSIAN_PEAK,
                                            gaussian_kernel1d)

_RADIUS = 4  # kernel radius for sigma=1 (scipy: int(4*sigma+0.5))


@functools.lru_cache(maxsize=None)
def _kernel9() -> np.ndarray:
    return gaussian_kernel1d(1.0, _RADIUS).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _blur_matrix(res: int) -> np.ndarray:
    """(res, res) banded matrix applying a constant-mode 9-tap Gaussian."""
    k = _kernel9()
    mat = np.zeros((res, res), dtype=np.float32)
    for i in range(res):
        for t in range(-_RADIUS, _RADIUS + 1):
            if 0 <= i + t < res:
                mat[i, i + t] = k[t + _RADIUS]
    return mat


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _reflect_delta_profile(d: torch.Tensor, n: int) -> torch.Tensor:
    """1-D blurred delta at integer positions ``d`` (any shape) on a
    length-``n`` axis with scipy 'reflect' boundaries: value[..., p] =
    k(p-d) + k(p+1+d) + k(p+1+d-2n) (one reflection per edge; radius << n).
    """
    k = torch.from_numpy(_kernel9()).to(d.device)
    p = torch.arange(n, device=d.device)
    d = d[..., None]

    def tap(t):
        return torch.where(t.abs() <= _RADIUS,
                           k[(t + _RADIUS).clamp(0, 2 * _RADIUS)], 0.0)

    return tap(p - d) + tap(p + 1 + d) + tap(p + 1 + d - 2 * n)


def render_joint_heatmaps(coords2d: torch.Tensor, res: int = 64
                          ) -> torch.Tensor:
    """Gaussian-peak joint heatmaps.

    coords2d: (..., J, 2) pixel coordinates in 1024-space. Returns
    (..., J, res, res) float32; in-view peaks == 1.0. Truncation toward
    zero and the asymmetric in-view test (-4 <= y < res+4, -4 <= x < res)
    of the reference (utils/projection.py:263-279)."""
    pos = coords2d.float() / COORD_SPACE * res
    x, y = pos[..., 0], pos[..., 1]
    valid = (y >= -4) & (y < res + 4) & (x >= -4) & (x < res)
    n = res + 2 * _RADIUS
    # out-of-view (or non-finite) joints render zeros: place them at 0
    dx = torch.where(valid, x.trunc(), 0.0).to(torch.int64) + _RADIUS
    dy = torch.where(valid, y.trunc(), 0.0).to(torch.int64) + _RADIUS
    col = _reflect_delta_profile(dy, n)[..., _RADIUS:-_RADIUS]
    row = _reflect_delta_profile(dx, n)[..., _RADIUS:-_RADIUS]
    img = col[..., :, None] * row[..., None, :]
    img = torch.where(valid[..., None, None], img, 0.0)
    return img / _f32(GAUSSIAN_PEAK, img)


def _dense_wu_line(a: torch.Tensor, b: torch.Tensor, res: int
                   ) -> torch.Tensor:
    """Dense Wu anti-aliased lines: per-pixel closed form over a (res, res)
    grid indexed image[y, x], one line per leading index. a, b: (..., 2)
    endpoints (x, y), floats holding integers. Returns (..., res, res)."""
    r0, c0 = a[..., 0, None, None], a[..., 1, None, None]
    r1, c1 = b[..., 0, None, None], b[..., 1, None, None]
    steep = (r1 - r0).abs() > (c1 - c0).abs()
    # canonical space: (R, C) with C the major axis
    R0, C0 = torch.where(steep, c0, r0), torch.where(steep, r0, c0)
    R1, C1 = torch.where(steep, c1, r1), torch.where(steep, r1, c1)
    swap = C0 > C1
    R0, R1 = torch.where(swap, R1, R0), torch.where(swap, R0, R1)
    C0, C1 = torch.where(swap, C1, C0), torch.where(swap, C0, C1)
    dc = C1 - C0
    grad = torch.where(dc == 0, 0.0,
                       (R1 - R0) / torch.where(dc == 0, 1.0, dc))
    grid = torch.arange(res, dtype=torch.float32, device=a.device)
    yy, xx = grid[:, None], grid[None, :]       # image row = y, col = x
    # pixel (y=yy, x=xx) has line-space coords (r=x, c=y)
    Cp = torch.where(steep, xx, yy)
    Rp = torch.where(steep, yy, xx)
    inrange = (Cp >= C0) & (Cp <= C1)
    yline = R0 + grad * (Cp - C0)
    fl = yline.floor()
    f = yline - fl
    val = (torch.where(Rp == fl, 1.0 - f, 0.0)
           + torch.where(Rp == fl + 1, f, 0.0))
    return torch.where(inrange, val, 0.0)


def render_limb_heatmaps(pts2d: torch.Tensor, parents: Sequence[int],
                         res: int = 64, sigma: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-bone AA limb heatmaps and pixel lengths.

    pts2d: (..., J, 2) in 1024-space; parents: the kinematic parents.
    Returns (heatmaps (..., J-1, res, res), lengths (..., J-1)): rint'ed
    integer endpoints, out-of-range pixels dropped, constant-mode
    Gaussian blur scaled by sigma, length = float-space norm + 1.0
    (reference utils/data.py:197-252)."""
    parents = list(parents)
    p2 = pts2d.float() / _f32(COORD_SPACE / res, pts2d)
    parent_xy = p2[..., parents[1:], :]
    child_xy = p2[..., 1:, :]
    lengths = torch.linalg.vector_norm(parent_xy - child_xy, dim=-1) + 1.0
    lines = _dense_wu_line(parent_xy.round(), child_xy.round(), res)
    blur = torch.from_numpy(_blur_matrix(res)).to(lines.device)
    # constant-mode separable blur: rows, then columns, as banded products
    blurred = blur @ lines @ blur.t()
    return blurred * sigma, lengths


def limb_theta(pts3d: torch.Tensor, parents: Sequence[int]) -> torch.Tensor:
    """Elevation angle per bone: arctan(dz / ||dxy||) of parent - child
    (reference utils/data.py:227-230). pts3d: (..., J, 3) -> (..., J-1).
    A zero-length bone in xy takes the limit sign(dz) * pi / 2 (0 when
    dz == 0) instead of the reference's unguarded NaN, as the JAX twin
    does."""
    parents = list(parents)
    limb = pts3d[..., parents[1:], :] - pts3d[..., 1:, :]
    dz = limb[..., 2]
    dxy = torch.linalg.vector_norm(limb[..., :2], dim=-1)
    degenerate = dxy == 0
    theta = torch.atan(dz / torch.where(degenerate, 1.0, dxy))
    return torch.where(degenerate, torch.sign(dz) * (math.pi / 2), theta)


def sin_limb_heatmaps(raw_limb: torch.Tensor, theta: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin)-modulated limb channels (reference
    dataloader/data_loader.py:193-199). raw_limb (..., L, H, W), theta
    (..., L)."""
    cos_hm = raw_limb * torch.cos(theta)[..., None, None]
    sin_hm = raw_limb * torch.sin(theta)[..., None, None]
    return cos_hm, sin_hm
