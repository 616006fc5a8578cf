"""Skeleton presets: joint names, kinematic parents, bone utilities.

The port's own copy of `egotap_tpu/core/skeleton.py`; reference
utils/util.py:10-66.
  * UnrealEgo: 16 joints, root = head (index 0).
  * EgoCap: 18 joints, root = cam (index 0).
  * Heatmaps cover joints 1..J-1; the root is excluded.
Parents precede children in index order in both presets, so a walk in
index order is a topological order of the tree (`Skeleton.validate`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

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

# Limb groupings for EgoGlass-style pseudo limb masks
# (reference utils/projection.py:147-162, `data.heatmaps.pseudo_limb_mask`)
UNREALEGO_LIMB_MASK_INDICES: Tuple[Tuple[int, ...], ...] = (
    (2, 4, 6), (3, 5, 7), (8, 10, 12), (9, 11, 13),
)
EGOCAP_LIMB_MASK_INDICES: Tuple[Tuple[int, ...], ...] = (
    (2, 3, 4), (6, 7, 8), (10, 11, 12), (14, 15, 16),
)


@dataclasses.dataclass(frozen=True)
class Skeleton:
    name: str
    joint_names: Tuple[str, ...]
    parents: Tuple[int, ...]
    estimate_head: bool
    stereo: bool
    limb_mask_indices: Tuple[Tuple[int, ...], ...] = ()

    @property
    def num_joints(self) -> int:
        return len(self.joint_names)

    @property
    def num_bones(self) -> int:
        """Bones = joints excluding the root (joint i's bone is i ->
        parents[i])."""
        return self.num_joints - 1

    @property
    def num_heatmaps(self) -> int:
        """Per-joint heatmaps cover joints 1..J-1 (root excluded)."""
        return self.num_joints - 1

    def parents_array(self) -> np.ndarray:
        return np.asarray(self.parents, dtype=np.int32)

    def bone_pairs(self) -> np.ndarray:
        """(num_bones, 2) int32 (parent, child) pairs for bones 1..J-1."""
        p = self.parents_array()
        children = np.arange(1, self.num_joints, dtype=np.int32)
        return np.stack([p[1:], children], axis=1)

    def validate(self) -> None:
        """Raises unless there is a parent per joint and each parent
        precedes its child (topological order)."""
        if len(self.parents) != len(self.joint_names):
            raise ValueError(f"{self.name}: {len(self.parents)} parents for "
                             f"{len(self.joint_names)} joints")
        for i, p in enumerate(self.parents):
            if not 0 <= p <= i:
                raise ValueError(f"{self.name}: joint {i}'s parent {p} does "
                                 "not precede it")


_PRESETS: Dict[str, Skeleton] = {
    "UnrealEgo": Skeleton("UnrealEgo", UNREALEGO_JOINT_NAMES,
                          UNREALEGO_PARENTS, estimate_head=True, stereo=True,
                          limb_mask_indices=UNREALEGO_LIMB_MASK_INDICES),
    "EgoCap": Skeleton("EgoCap", EGOCAP_JOINT_NAMES, EGOCAP_PARENTS,
                       estimate_head=False, stereo=True,
                       limb_mask_indices=EGOCAP_LIMB_MASK_INDICES),
}


def get_skeleton(preset: str) -> Skeleton:
    try:
        return _PRESETS[preset]
    except KeyError:
        raise ValueError(f"joint_preset {preset!r} is undefined; "
                         f"available: {sorted(_PRESETS)}") from None


def bone_vectors(pose, parents):
    """Bone vectors child - parent for joints 1..J-1 of a (..., J, 3)
    pose, numpy or torch (reference utils/loss.py:60-70)."""
    return (pose - pose[..., parents, :])[..., 1:, :]
