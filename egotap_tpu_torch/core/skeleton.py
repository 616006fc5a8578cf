"""Skeleton presets: joint names and kinematic parents.

The port's own copy of `egotap_tpu/core/skeleton.py` (the parts the
serving forward uses); reference utils/util.py:10-66.
  * UnrealEgo: 16 joints, root = head (index 0).
  * EgoCap: 18 joints, root = cam (index 0).
  * Heatmaps cover joints 1..J-1; the root is excluded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

UNREALEGO_JOINT_NAMES: Tuple[str, ...] = (
    "head", "neck_01", "upperarm_l", "upperarm_r", "lowerarm_l", "lowerarm_r",
    "hand_l", "hand_r", "thigh_l", "thigh_r", "calf_l", "calf_r",
    "foot_l", "foot_r", "ball_l", "ball_r",
)

EGOCAP_JOINT_NAMES: Tuple[str, ...] = (
    "cam", "neck", "left_shoulder", "left_elbow", "left_wrist", "left_finger",
    "right_shoulder", "right_elbow", "right_wrist", "right_finger",
    "left_hip", "left_knee", "left_ankle", "left_toe",
    "right_hip", "right_knee", "right_ankle", "right_toe",
)

UNREALEGO_PARENTS: Tuple[int, ...] = (0, 0, 1, 1, 2, 3, 4, 5, 2, 3, 8, 9, 10, 11, 12, 13)
EGOCAP_PARENTS: Tuple[int, ...] = (0, 0, 1, 2, 3, 4, 1, 6, 7, 8, 2, 10, 11, 12, 6, 14, 15, 16)


@dataclasses.dataclass(frozen=True)
class Skeleton:
    name: str
    joint_names: Tuple[str, ...]
    parents: Tuple[int, ...]
    estimate_head: bool
    stereo: bool

    @property
    def num_joints(self) -> int:
        return len(self.joint_names)

    @property
    def num_heatmaps(self) -> int:
        """Per-joint heatmaps cover joints 1..J-1 (root excluded)."""
        return self.num_joints - 1


_PRESETS: Dict[str, Skeleton] = {
    "UnrealEgo": Skeleton("UnrealEgo", UNREALEGO_JOINT_NAMES,
                          UNREALEGO_PARENTS, estimate_head=True, stereo=True),
    "EgoCap": Skeleton("EgoCap", EGOCAP_JOINT_NAMES, EGOCAP_PARENTS,
                       estimate_head=False, stereo=True),
}


def get_skeleton(preset: str) -> Skeleton:
    try:
        return _PRESETS[preset]
    except KeyError:
        raise ValueError(f"joint_preset {preset!r} is undefined; "
                         f"available: {sorted(_PRESETS)}") from None
