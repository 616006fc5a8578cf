"""The port's own copies of the configuration and skeleton presets
(egotap_tpu_torch.core) against the JAX package's."""

import pytest

from egotap_tpu.core.config import Config as JaxConfig
from egotap_tpu.core.skeleton import get_skeleton as jax_skeleton
from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.serving import serving_config

DERIVED = ("estimate_head", "stereo", "limb_dim", "views", "num_joints_out",
           "heatmap_res", "image_size")


@pytest.mark.parametrize("fields", [
    dict(joint_preset="UnrealEgo", num_heatmap=15, num_rot_heatmap=15,
         heatmap_type="sin"),
    dict(joint_preset="EgoCap", num_heatmap=17, heatmap_type="limb",
         load_size_heatmap=(32, 32)),
    dict(joint_preset="xR-Egopose", heatmap_type="none"),
])
def test_derive_matches_jax(fields):
    ours, ref = Config(**fields).derive(), JaxConfig(**fields).derive()
    for name in DERIVED:
        assert getattr(ours, name) == getattr(ref, name), name


@pytest.mark.parametrize("preset", ["UnrealEgo", "EgoCap"])
def test_serving_config_is_the_released_estimator(preset):
    cfg = serving_config(preset)
    ref = JaxConfig(joint_preset=preset, model="egotap_autoencoder",
                    num_heatmap=cfg.num_heatmap,
                    num_rot_heatmap=cfg.num_rot_heatmap, heatmap_type="sin",
                    skel_layer="PU", ae_hidden_size=128,
                    patched_heatmap_ae=True).derive()
    for name in DERIVED + ("num_heatmap", "num_rot_heatmap", "model_name",
                           "ae_hidden_size", "skel_layer", "n_skel_layers",
                           "pu_semantics"):
        assert getattr(cfg, name) == getattr(ref, name), name


@pytest.mark.parametrize("preset", ["UnrealEgo", "EgoCap"])
def test_skeleton_matches_jax(preset):
    ours, ref = get_skeleton(preset), jax_skeleton(preset)
    assert ours.joint_names == tuple(ref.joint_names)
    assert ours.parents == tuple(ref.parents)
    assert (ours.num_joints, ours.num_heatmaps) == (ref.num_joints,
                                                    ref.num_heatmaps)


def test_unknown_presets_raise():
    with pytest.raises(ValueError):
        Config(joint_preset="Nope").derive()
    with pytest.raises(ValueError):
        get_skeleton("xR-Egopose")


TRAINING = ("model", "use_gt_heatmap", "batch_size", "epoch_count", "niter",
            "niter_decay", "optimizer_type", "lr_policy",
            "lr_decay_iters_step", "lr", "weight_decay", "opt_eps",
            "lambda_mpjpe", "lambda_cos_sim", "use_amp", "compute_dtype",
            "lambda_heatmap", "lambda_rot_heatmap", "init_ImageNet",
            "imagenet_backbone", "path_to_trained_heatmap", "log_dir")


def test_training_defaults_match_jax():
    ours, ref = Config(), JaxConfig()
    for name in TRAINING:
        assert getattr(ours, name) == getattr(ref, name), name


def test_stage2_preset_matches_jax():
    """The port's egotap_unrealego preset is the JAX one, key for key, and
    an unknown preset name raises."""
    from egotap_tpu.core.config import PRESETS as JAX_PRESETS
    from egotap_tpu_torch.core.config import PRESETS
    assert PRESETS["egotap_unrealego"] == JAX_PRESETS["egotap_unrealego"]
    cfg = Config.from_preset("egotap_unrealego", batch_size=4)
    assert cfg.batch_size == 4 and cfg.optimizer_type == "AdamW"
    assert cfg.num_joints_out == 16 and cfg.estimate_head
    with pytest.raises(ValueError):
        Config.from_preset("no_such_preset")


STAGE1 = ["unrealego_heatmap_joint", "unrealego_heatmap_limb",
          "egocap_heatmap_joint", "egocap_heatmap_limb"]


@pytest.mark.parametrize("preset", STAGE1)
def test_stage1_presets_match_jax(preset):
    """The four stage-1 presets are the JAX ones, key for key, and derive
    the same configuration."""
    from egotap_tpu.core.config import PRESETS as JAX_PRESETS
    from egotap_tpu_torch.core.config import PRESETS
    ref, ours = JAX_PRESETS[preset], PRESETS[preset]
    assert ours == ref
    cfg = Config.from_preset(preset)
    want = JaxConfig(**ref).derive()
    for name in DERIVED + TRAINING + ("joint_preset", "num_heatmap",
                                      "num_rot_heatmap", "heatmap_type"):
        assert getattr(cfg, name) == getattr(want, name), name
    assert cfg.model == "heatmap_shared" and cfg.init_ImageNet


def test_fields_match_jax():
    """The same fields, in the same order, with the same defaults, and the
    same six presets."""
    import dataclasses

    from egotap_tpu.core.config import PRESETS as JAX_PRESETS
    from egotap_tpu_torch.core.config import PRESETS
    assert dataclasses.asdict(Config()) == dataclasses.asdict(JaxConfig())
    assert [f.name for f in dataclasses.fields(Config)] == \
        [f.name for f in dataclasses.fields(JaxConfig)]
    assert PRESETS == JAX_PRESETS and len(PRESETS) == 6


ARGVS = [[]] + [["--preset", p] for p in
                ("unrealego_heatmap_joint", "unrealego_heatmap_limb",
                 "egotap_unrealego", "egotap_egocap",
                 "egocap_heatmap_joint", "egocap_heatmap_limb")] + [
    # a bool, a tuple, an Optional[int], an Optional[str], a float
    ["--use_amp", "true", "--load_size_heatmap", "32", "32",
     "--watchdog_check_iters", "100", "--profile_dir", "/tmp/p",
     "--lr", "3e-4", "--metadata_dir", "a", "b"],
    # flags equal to their dataclass defaults override the preset's values
    ["--preset", "egotap_unrealego", "--use_amp", "false",
     "--batch_size", "16", "--lr_policy", "lambda"],
    ["--preset", "unrealego_heatmap_limb", "--auto_restart", "no",
     "--experiment_name", "experiment", "--joint_preset", "EgoCap"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=lambda a: " ".join(a) or "none")
def test_from_args_matches_jax(argv):
    """`Config.from_args`: defaults < preset < the flags passed, with the
    JAX package's parsing of bools, tuples and Optional fields."""
    import dataclasses
    ours, ref = Config.from_args(argv), JaxConfig.from_args(argv)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.experiment_dir, ours.results_dir) == \
        (ref.experiment_dir, ref.results_dir)


def test_from_args_argument_preset_and_errors():
    ours = Config.from_args(["--batch_size", "8"], preset="egotap_egocap")
    assert ours.batch_size == 8 and ours.joint_preset == "EgoCap"
    assert not ours.estimate_head
    with pytest.raises(SystemExit):
        Config.from_args(["--preset", "no_such_preset"])


@pytest.mark.parametrize("argv", [ARGVS[3], ARGVS[7]],
                         ids=["egotap_unrealego", "flags"])
def test_save_matches_jax(argv, tmp_path):
    """`save` writes the same option text and JSON as the JAX package."""
    Config.from_args(argv).save(str(tmp_path / "ours" / "train_opt.txt"))
    JaxConfig.from_args(argv).save(str(tmp_path / "ref" / "train_opt.txt"))
    for name in ("train_opt.txt", "train_opt.json"):
        assert (tmp_path / "ours" / name).read_text() == \
            (tmp_path / "ref" / name).read_text(), name
