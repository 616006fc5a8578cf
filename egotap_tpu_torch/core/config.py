"""Configuration: one dataclass covering the reference's full flag surface.

The port's own copy of `egotap_tpu/core/config.py`: the same fields, in
the same order, with the same defaults, the same `derive()` logic
(reference options/dataset_options.py:29-42), the same `from_args`
semantics and the same six `PRESETS`, key for key, so the port's CLIs
take the JAX package's flags and presets and `save` writes the same
option files. A few fields are kept for the flag surface only and read
by nothing in the port: ``patched_heatmap_ae`` (the released lifter is
always built, as in the JAX package), ``init_type``, ``use_slurm``,
``metadata_dir``, ``project_name``.
The port trains on one card: ``data_parallel`` above 1 raises in the
training loop. The device is not a field: the entry points take it as a
keyword argument (``device="cuda"`` unless the caller asks for the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import typing
from typing import List, Optional, Tuple


@dataclasses.dataclass
class Config:
    # --- identity -------------------------------------------------------
    project_name: str = "egotap_tpu"
    experiment_name: str = "experiment"
    model: str = "egotap_autoencoder"      # heatmap_shared | egotap_autoencoder
    model_name: str = "resnet18"           # backbone
    joint_preset: str = "UnrealEgo"        # UnrealEgo | EgoCap

    # --- data -----------------------------------------------------------
    data_dir: str = "./data/UnrealEgoData"
    default_data_path: str = "./UnrealEgoData"
    data_sub_path: str = "all_data_with_img-256_hm-64_pose-16_npy"
    metadata_dir: Tuple[str, ...] = ()
    data_prefix: str = ""
    num_heatmap: int = 15
    num_rot_heatmap: int = 0
    heatmap_type: str = "none"             # none | limb | sin
    load_size_heatmap: Tuple[int, int] = (64, 64)
    batch_size: int = 16
    num_threads: int = 2                   # host loader threads
    prefetch_batches: int = 2              # packed-loader background depth
    experiment: bool = False               # 100-sample cap fixture
    use_gt_heatmap: bool = False

    # --- network --------------------------------------------------------
    # int8 inference of the heatmap nets' convs and of the lifter's ViT
    # and FC matmuls (ops/quant.py); `Predictor(int8=None)` follows these
    int8_heatmap_inference: bool = False
    int8_lifter_inference: bool = False
    # calibrate static int8 activation scales on the first N eval batches
    # (eval/evaluate.py); 0 = dynamic per-call scales
    calib_batches: int = 0
    ae_hidden_size: int = 20
    # PU | LSTM | LSTMSplit | LSTMNoRel | None | NoneNoRel
    skel_layer: str = "LSTM"
    patched_heatmap_ae: bool = False
    # stage 1: keep the ResNet trunk's own init (reference --init_ImageNet),
    # with its weights from a torchvision resnet .pth when one is named
    init_ImageNet: bool = False
    imagenet_backbone: Optional[str] = None
    init_type: str = "kaiming"
    # stage-1 warm start (a HeatmapUNet .pth or checkpoint directory); for
    # stage 2 the base of the `{base}_pos` / `{base}_{heatmap_type}`
    # sibling directories of the frozen nets (train/loop.py)
    path_to_trained_heatmap: Optional[str] = None
    n_skel_layers: int = 2
    pu_semantics: str = "chain"            # chain (reference parity) | tree

    # --- training -------------------------------------------------------
    epoch_count: int = 1
    niter: int = 0
    niter_decay: int = 0
    # Adam | AdamW | SGD | DAdam | DSGD | DAdaGrad | Prodigy
    optimizer_type: str = "Adam"
    # lambda | step | exponent | cos_anneal | cos_anneal_warmup
    lr_policy: str = "lambda"
    lr_decay_iters_step: int = 4
    lr: float = 1e-3
    weight_decay: float = 0.0
    opt_eps: float = 1e-4
    d_coef: float = 1.0                    # Prodigy d estimate coefficient
    # growth_rate caps d's growth a step for DSGD / DAdaGrad (inf =
    # uncapped); decouple asks for decoupled decay in DAdam, which is
    # decoupled either way (make_optimizer warns when it is not set)
    growth_rate: float = float("inf")
    decouple: bool = False
    lambda_mpjpe: float = 1.0
    lambda_heatmap: float = 1.0
    lambda_rot_heatmap: float = 1.0
    lambda_cos_sim: float = -1e-2
    val_epoch_freq: int = 1
    print_epoch_freq: int = 1
    save_epoch_freq: int = 1
    auto_restart: bool = False
    auto_terminate: bool = False
    # early-convergence watchdog window (None = the reference's 3000/8000
    # iterations checked, stall after 200/400; train.py:165-174)
    watchdog_check_iters: Optional[int] = None
    watchdog_stall_iters: Optional[int] = None
    # read the losses back every N steps (1 = every step)
    loss_sync_every: int = 1
    use_amp: bool = False                  # bf16 compute
    seed: int = 0

    # --- dirs / logging -------------------------------------------------
    log_dir: str = "./log"
    result_dir: str = "./results"
    use_slurm: bool = False

    # --- devices and tracing --------------------------------------------
    data_parallel: int = 0                 # one card: 0 or 1
    compute_dtype: str = "float32"         # float32 | bfloat16
    profile_dir: Optional[str] = None      # torch.profiler Chrome trace
    profile_steps: int = 5                 # steps traced early in epoch 1

    # --- derived (set by derive()) --------------------------------------
    estimate_head: bool = True
    stereo: bool = True
    is_train: bool = True

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

    @property
    def experiment_dir(self) -> str:
        return os.path.join(self.log_dir, self.experiment_name)

    @property
    def results_dir(self) -> str:
        return os.path.join(self.result_dir, self.experiment_name)

    def save(self, path: str) -> None:
        """The options as text (``path``) and as JSON (``.txt`` -> ``.json``)."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        d = dataclasses.asdict(self)
        with open(path, "w") as f:
            f.write("--------------Options--------------\n")
            for k in sorted(d):
                f.write(f"{k}: {d[k]}\n")
            f.write("----------------End----------------\n")
        with open(path.replace(".txt", ".json"), "w") as f:
            json.dump(d, f, indent=2, default=str)

    @classmethod
    def from_preset(cls, name: str, **overrides) -> "Config":
        """`PRESETS[name]` over the defaults, ``overrides`` over both."""
        if name not in PRESETS:
            raise ValueError(f"unknown preset {name!r}; available: "
                             f"{sorted(PRESETS)}")
        return cls(**{**PRESETS[name], **overrides}).derive()

    @classmethod
    def from_args(cls, argv: Optional[List[str]] = None,
                  preset: Optional[str] = None) -> "Config":
        """defaults < preset (``--preset`` flag or the `preset` argument)
        < the flags passed. Flags not passed default to argparse.SUPPRESS,
        so a flag passed with its dataclass default still overrides the
        preset's value."""
        defaults = dataclasses.asdict(cls())
        hints = typing.get_type_hints(cls)
        parser = argparse.ArgumentParser()
        parser.add_argument("--preset", type=str, default=None)
        for k, v in defaults.items():
            if isinstance(v, bool):
                parser.add_argument(f"--{k}", type=lambda s: s.lower() in
                                    ("1", "true", "yes"),
                                    default=argparse.SUPPRESS)
            elif isinstance(v, (tuple, list)):
                parser.add_argument(f"--{k}", nargs="+",
                                    type=type(v[0]) if v else str,
                                    default=argparse.SUPPRESS)
            elif v is None:
                # Optional[T] fields parse as T (the watchdog's are ints)
                t = next((a for a in typing.get_args(hints.get(k))
                          if a in (int, float)), str)
                parser.add_argument(f"--{k}", type=t,
                                    default=argparse.SUPPRESS)
            else:
                parser.add_argument(f"--{k}", type=type(v),
                                    default=argparse.SUPPRESS)
        args = vars(parser.parse_args(argv))
        chosen = args.pop("preset", None) or preset
        merged = dict(defaults)
        if chosen:
            if chosen not in PRESETS:
                parser.error(f"unknown preset {chosen!r}; available: "
                             + ", ".join(sorted(PRESETS)))
            merged.update(PRESETS[chosen])
        merged.update(args)
        for k in ("load_size_heatmap", "metadata_dir"):
            if isinstance(merged.get(k), list):
                merged[k] = tuple(merged[k])
        return cls(**merged).derive()


# The shipped presets (egotap_tpu/core/config.py:222-273, reference
# scripts/train/Heatmap/{Joint,Limb}/*.sh and PoseEstimator/*.sh).
PRESETS = {
    "unrealego_heatmap_joint": dict(
        experiment_name="unrealego_heatmap_shared_pos", model="heatmap_shared",
        optimizer_type="Adam", lr=1e-3, niter=5, niter_decay=5, batch_size=16,
        num_heatmap=15, num_rot_heatmap=0, heatmap_type="none",
        init_ImageNet=True, auto_restart=True, use_amp=True,
    ),
    "unrealego_heatmap_limb": dict(
        experiment_name="unrealego_heatmap_shared_sin", model="heatmap_shared",
        optimizer_type="Adam", lr=1e-3, niter=5, niter_decay=5, batch_size=16,
        num_heatmap=0, num_rot_heatmap=15, heatmap_type="sin",
        init_ImageNet=True, auto_restart=True, use_amp=True,
    ),
    "egotap_unrealego": dict(
        experiment_name="egotap_unrealego", model="egotap_autoencoder",
        optimizer_type="AdamW", lr_policy="cos_anneal_warmup", lr=1e-3,
        lambda_mpjpe=0.1, lambda_cos_sim=-0.01,
        skel_layer="PU", ae_hidden_size=128, patched_heatmap_ae=True,
        niter=1, niter_decay=15, batch_size=32,
        num_heatmap=15, num_rot_heatmap=15, heatmap_type="sin",
        init_ImageNet=True, use_amp=True,
        path_to_trained_heatmap="./log/unrealego_heatmap_shared/best_net_HeatMap.pth",
    ),
    "egotap_egocap": dict(
        experiment_name="egotap_egocap", model="egotap_autoencoder",
        joint_preset="EgoCap", optimizer_type="AdamW",
        lr_policy="cos_anneal_warmup", lr=1e-3,
        lambda_mpjpe=0.1, lambda_cos_sim=-0.01,
        skel_layer="PU", ae_hidden_size=128, patched_heatmap_ae=True,
        niter=2, niter_decay=15, batch_size=32,
        num_heatmap=17, num_rot_heatmap=17, heatmap_type="sin",
        init_ImageNet=True, use_amp=True,
        path_to_trained_heatmap="./log/egocap_heatmap_shared/best_net_HeatMap.pth",
    ),
    "egocap_heatmap_joint": dict(
        experiment_name="egocap_heatmap_shared_pos", model="heatmap_shared",
        joint_preset="EgoCap", optimizer_type="Adam", lr=1e-3,
        niter=5, niter_decay=5, batch_size=16,
        num_heatmap=17, num_rot_heatmap=0, heatmap_type="none",
        init_ImageNet=True, auto_restart=True, use_amp=True,
    ),
    "egocap_heatmap_limb": dict(
        experiment_name="egocap_heatmap_shared_sin", model="heatmap_shared",
        joint_preset="EgoCap", optimizer_type="Adam", lr=1e-3,
        niter=5, niter_decay=5, batch_size=16,
        num_heatmap=0, num_rot_heatmap=17, heatmap_type="sin",
        init_ImageNet=True, auto_restart=True, use_amp=True,
    ),
}
