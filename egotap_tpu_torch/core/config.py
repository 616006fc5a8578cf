"""Configuration for the serving forward.

The port's own copy of the `egotap_tpu/core/config.py` fields that
`Predictor` reads, with the same names, defaults and `derive()` logic
(reference options/dataset_options.py:29-42). The port's `Predictor`
always builds the released pose estimator (``--model
egotap_autoencoder --patched_heatmap_ae``), so those two flags have no
copy here. Training, data and logging flags belong to later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class Config:
    model_name: str = "resnet18"           # backbone
    joint_preset: str = "UnrealEgo"        # UnrealEgo | EgoCap
    num_heatmap: int = 15
    num_rot_heatmap: int = 0
    heatmap_type: str = "none"             # none | limb | sin
    load_size_heatmap: Tuple[int, int] = (64, 64)
    ae_hidden_size: int = 20
    skel_layer: str = "LSTM"               # only PU is ported
    n_skel_layers: int = 2
    pu_semantics: str = "chain"            # chain (reference parity) | tree

    # --- derived (set by derive()) --------------------------------------
    estimate_head: bool = True
    stereo: bool = True

    def derive(self) -> "Config":
        if self.joint_preset == "UnrealEgo":
            self.estimate_head, self.stereo = True, True
        elif self.joint_preset == "EgoCap":
            self.estimate_head, self.stereo = False, True
        elif self.joint_preset == "xR-Egopose":
            self.estimate_head, self.stereo = True, False
        else:
            raise ValueError(f"unknown joint_preset {self.joint_preset}")
        return self

    @property
    def limb_dim(self) -> int:
        return {"none": 0, "limb": 1, "sin": 2}[self.heatmap_type]

    @property
    def views(self) -> int:
        return 2 if self.stereo else 1

    @property
    def num_joints_out(self) -> int:
        """Output pose rows (reference EgoTAPAutoEncoder num_joints)."""
        return self.num_heatmap + (1 if self.estimate_head else 0)

    @property
    def heatmap_res(self) -> int:
        return self.load_size_heatmap[0]

    @property
    def image_size(self) -> int:
        return self.heatmap_res * 4
