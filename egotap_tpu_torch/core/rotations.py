"""Rotation and pose utilities, numpy (reference utils/data.py:27-74).

The port's own copy of `egotap_tpu/core/rotations.py`, used offline by
the preprocessors (`preprocess/`):
  * `ur2r`: Unreal Engine rotator (pitch, yaw, roll degrees) -> rotation
    matrix, the reference's convention (utils/data.py:49-74);
  * `local_rot`: unit bone-direction vectors per joint (utils/data.py:
    27-33);
  * `vec2vec_rotation`: the rotation taking v1 to v2 (utils/data.py:
    35-47);
  * `is_rotation`: det == 1.
"""

from __future__ import annotations

import numpy as np


def ur2r(theta: np.ndarray) -> np.ndarray:
    """(..., 3) UE rotator degrees (pitch, yaw, roll) -> (..., 3, 3) f32."""
    rad = np.deg2rad(np.asarray(theta))
    sp, cp = np.sin(rad[..., 0]), np.cos(rad[..., 0])
    sy, cy = np.sin(rad[..., 1]), np.cos(rad[..., 1])
    sr, cr = np.sin(rad[..., 2]), np.cos(rad[..., 2])

    R = np.zeros(rad.shape[:-1] + (3, 3), dtype=np.float32)
    R[..., 0, 0] = cp * cy
    R[..., 0, 1] = cp * sy
    R[..., 0, 2] = sp
    R[..., 1, 0] = sr * sp * cy - cr * sy
    R[..., 1, 1] = sr * sp * sy + cr * cy
    R[..., 1, 2] = -sr * cp
    R[..., 2, 0] = -(cr * sp * cy + sr * sy)
    R[..., 2, 1] = cy * sr - cr * sp * sy
    R[..., 2, 2] = cr * cp
    return R


def local_rot(pose3d: np.ndarray, parents: np.ndarray) -> np.ndarray:
    """(J, 3) pose -> (J, 3) f32 unit bone directions (row 0 zero)."""
    pose3d = np.asarray(pose3d)
    out = np.zeros((len(parents), 3), dtype=np.float32)
    for i in range(1, len(parents)):
        d = pose3d[i] - pose3d[parents[i]]
        out[i] = d / np.linalg.norm(d)
    return out


def vec2vec_rotation(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Rotation matrix taking unit(v1) to unit(v2)."""
    u1 = v1 / np.linalg.norm(v1)
    u2 = v2 / np.linalg.norm(v2)
    v = np.cross(u1, u2)
    s = np.linalg.norm(v)
    c = np.dot(u1, u2)
    vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + vx + vx @ vx * (1 - c) / (s ** 2)


def is_rotation(mat: np.ndarray) -> bool:
    return bool(np.isclose(np.linalg.det(mat), 1.0))
