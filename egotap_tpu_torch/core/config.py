"""Configuration for the serving forward and the stage-2 training step.

The port's own copy of the `egotap_tpu/core/config.py` fields that
`Predictor`, `train.tasks.LifterTask` and `train.optim.make_optimizer`
read, with the same names, defaults and `derive()` logic (reference
options/dataset_options.py:29-42). The port always builds the released
pose estimator's lifter (``--patched_heatmap_ae``), so that flag has no
copy here. Stage-1, data, checkpoint and logging flags belong to later
slices.
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
    # int8 inference of the heatmap nets' convs and of the lifter's ViT
    # and FC matmuls (ops/quant.py); `Predictor(int8=None)` follows these
    int8_heatmap_inference: bool = False
    int8_lifter_inference: bool = False
    model: str = "egotap_autoencoder"      # heatmap_shared | egotap_autoencoder
    use_gt_heatmap: bool = False
    batch_size: int = 16

    # --- training (egotap_tpu/core/config.py:70-115) ---------------------
    epoch_count: int = 1
    niter: int = 0
    niter_decay: int = 0
    optimizer_type: str = "Adam"           # Adam | AdamW | SGD
    # lambda | step | exponent | cos_anneal | cos_anneal_warmup
    lr_policy: str = "lambda"
    lr_decay_iters_step: int = 4
    lr: float = 1e-3
    weight_decay: float = 0.0
    opt_eps: float = 1e-4
    lambda_mpjpe: float = 1.0
    lambda_cos_sim: float = -1e-2
    use_amp: bool = False                  # bf16 compute
    compute_dtype: str = "float32"         # float32 | bfloat16

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

    @classmethod
    def from_preset(cls, name: str, **overrides) -> "Config":
        """`PRESETS[name]` over the defaults, ``overrides`` over both."""
        if name not in PRESETS:
            raise ValueError(f"unknown preset {name!r}; available: "
                             f"{sorted(PRESETS)}")
        return cls(**{**PRESETS[name], **overrides}).derive()


# The stage-2 pose estimator (egotap_tpu/core/config.py:238-245, reference
# scripts/train/PoseEstimator/unrealego.sh), less the keys the port has no
# field for yet: experiment_name (logging), patched_heatmap_ae (always on),
# init_ImageNet (stage 1) and path_to_trained_heatmap (checkpoint I/O).
PRESETS = {
    "egotap_unrealego": dict(
        model="egotap_autoencoder", optimizer_type="AdamW",
        lr_policy="cos_anneal_warmup", lr=1e-3,
        lambda_mpjpe=0.1, lambda_cos_sim=-0.01,
        skel_layer="PU", ae_hidden_size=128,
        niter=1, niter_decay=15, batch_size=32,
        num_heatmap=15, num_rot_heatmap=15, heatmap_type="sin",
        use_amp=True,
    ),
}
