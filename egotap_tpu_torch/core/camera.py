"""Scaramuzza OCam fisheye camera model, numpy only.

The port's own copy of the numpy branch of `egotap_tpu/core/camera.py`
(reference utils/projection.py:13-144), which the synthetic dataset
(`data/synthetic.py`) projects its joints with. The calibration JSON
(``fisheye.calibration_{left,right}.json``) carries ``polynomialC2W``
(pixel radius -> z), ``polynomialW2C`` (theta -> pixel radius),
``image_center`` [row, col] (so xc = center[1], yc = center[0]),
``affine`` [c, d, e], ``size`` [height, width], ``imageCircleRadius`` and
``name``. Coordinates are 1024 x 1024 pixels. The polynomials accumulate
as the reference does (a running power, not Horner), so results are
bit-comparable with the JAX package's numpy twins.

UnrealEgo quirk (utils/projection.py:96-97, 141-142, 256-261): for a
calibration named ``unreal_ego_pose`` 3D points go UE -> CV by negating
y and z before projection, and the projected y is mirrored about the
image center afterwards.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np


@dataclasses.dataclass(frozen=True)
class OcamModel:
    """Calibration parameters: polynomial vectors and scalars."""

    pol: np.ndarray       # (P,) cam2world polynomial (z from pixel radius)
    invpol: np.ndarray    # (Q,) world2cam polynomial (radius from theta)
    xc: float
    yc: float
    c: float
    d: float
    e: float
    width: int = 1024
    height: int = 1024
    radius: float = 512.0
    name: str = "fisheye"

    @property
    def is_unrealego(self) -> bool:
        return self.name == "unreal_ego_pose"


def load_calibration(path: str) -> OcamModel:
    """Load an OCam calibration JSON (reference utils/projection.py:13-50)."""
    with open(path, "r") as f:
        return calibration_from_dict(json.load(f))


def calibration_from_dict(data: Dict[str, Any]) -> OcamModel:
    return OcamModel(
        pol=np.asarray(data["polynomialC2W"], dtype=np.float64),
        invpol=np.asarray(data["polynomialW2C"], dtype=np.float64),
        xc=float(data["image_center"][1]),
        yc=float(data["image_center"][0]),
        c=float(data["affine"][0]),
        d=float(data["affine"][1]),
        e=float(data["affine"][2]),
        height=int(data["size"][0]),
        width=int(data["size"][1]),
        radius=float(data["imageCircleRadius"]),
        name=str(data["name"]),
    )


def calibration_to_dict(o: OcamModel) -> Dict[str, Any]:
    return {
        "name": o.name,
        "polynomialC2W": np.asarray(o.pol).tolist(),
        "polynomialW2C": np.asarray(o.invpol).tolist(),
        "image_center": [o.yc, o.xc],
        "affine": [o.c, o.d, o.e],
        "size": [o.height, o.width],
        "imageCircleRadius": o.radius,
    }


def _poly_running(coeffs, x: np.ndarray) -> np.ndarray:
    """sum_i coeffs[i] * x**i in the reference's order (a running power;
    utils/projection.py:73-79, 115-121)."""
    acc = np.full(x.shape, coeffs[0], dtype=x.dtype)
    x_i = np.ones_like(x)
    for i in range(1, len(coeffs)):
        x_i = x_i * x
        acc = acc + x_i * coeffs[i]
    return acc


def cam2world_np(point2d: np.ndarray, o: OcamModel) -> np.ndarray:
    """Pixel (..., 2) -> unit ray (..., 3)."""
    point2d = np.asarray(point2d)
    invdet = 1.0 / (o.c - o.d * o.e)
    u = point2d[..., 0] - o.xc
    v = point2d[..., 1] - o.yc
    xp_ = invdet * (u - o.d * v)
    yp_ = invdet * (-o.e * u + o.c * v)
    r = np.sqrt(xp_ * xp_ + yp_ * yp_)
    zp_ = _poly_running(np.asarray(o.pol, dtype=np.float64), r)
    invnorm = 1.0 / np.sqrt(xp_ * xp_ + yp_ * yp_ + zp_ * zp_)
    return np.stack([invnorm * xp_, invnorm * yp_, invnorm * zp_], axis=-1)


def world2cam_np(point3d: np.ndarray, o: OcamModel) -> np.ndarray:
    """3D point (..., 3) -> pixel (..., 2)."""
    point3d = np.asarray(point3d)
    if o.is_unrealego:
        # UE -> CV coordinate preconditioning (utils/projection.py:256-261)
        point3d = np.concatenate([point3d[..., :1], -point3d[..., 1:]],
                                 axis=-1)
    x3, y3, z3 = point3d[..., 0], point3d[..., 1], point3d[..., 2]
    norm = np.sqrt(x3 * x3 + y3 * y3)
    near_zero = np.isclose(norm, np.zeros_like(norm))

    safe_norm = np.where(near_zero, np.ones_like(norm), norm)
    theta = np.arctan(z3 / safe_norm)
    rho = _poly_running(np.asarray(o.invpol, dtype=np.float64), theta)
    invnorm = 1.0 / safe_norm
    xr = x3 * invnorm * rho
    yr = y3 * invnorm * rho

    px = xr * o.c + yr * o.d + o.xc
    py = xr * o.e + yr + o.yc
    px = np.where(near_zero, np.full_like(px, o.xc), px)
    py = np.where(near_zero, np.full_like(py, o.yc), py)
    if o.is_unrealego:
        py = o.yc * 2 - py          # mirror y (utils/projection.py:141-142)
    return np.stack([px, py], axis=-1)


def synthetic_calibration(name: str = "unreal_ego_pose", f: float = 220.0,
                          size: int = 1024) -> OcamModel:
    """A self-consistent synthetic fisheye calibration (no real UnrealEgo or
    EgoCap calibration files are shipped): pixel radius rho(theta) is an
    exact cubic in theta (``polynomialW2C``), and ``polynomialC2W`` a
    least-squares degree-9 fit of its inverse (a cam2world(world2cam(.))
    ray round trip within about 1e-3)."""
    b = np.array([f * np.pi / 2.0, -f, -8.0, 2.0], dtype=np.float64)

    def rho_of_theta(t):
        return b[0] + b[1] * t + b[2] * t ** 2 + b[3] * t ** 3

    # fit z(r) so that arctan(z(r) / r) inverts rho_of_theta, on the
    # normalised radius (a well-conditioned Vandermonde), then rescale
    thetas = np.linspace(-1.25, 1.25, 8001)
    rhos = rho_of_theta(thetas)
    zs = rhos * np.tan(thetas)
    deg = 9
    scale = np.max(np.abs(rhos))
    V = np.vander(rhos / scale, deg + 1, increasing=True)
    pol_scaled = np.linalg.lstsq(V, zs, rcond=None)[0]
    pol = pol_scaled / scale ** np.arange(deg + 1)

    center = size / 2.0
    return OcamModel(pol=pol, invpol=b, xc=center, yc=center,
                     c=1.0, d=0.0, e=0.0, width=size, height=size,
                     radius=center, name=name)
