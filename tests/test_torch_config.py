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
    """The port's egotap_unrealego preset is the JAX one less the keys the
    port has no field for (logging, the always-on patched ViT lifter) or
    does not read in stage 2 (init_ImageNet, path_to_trained_heatmap:
    `LifterTask.init_state` takes the frozen nets from its caller)."""
    from egotap_tpu.core.config import PRESETS as JAX_PRESETS
    from egotap_tpu_torch.core.config import PRESETS
    ref = JAX_PRESETS["egotap_unrealego"]
    ours = PRESETS["egotap_unrealego"]
    assert set(ref) - set(ours) == {"experiment_name", "patched_heatmap_ae",
                                    "init_ImageNet",
                                    "path_to_trained_heatmap"}
    assert ours == {k: ref[k] for k in ours}
    cfg = Config.from_preset("egotap_unrealego", batch_size=4)
    assert cfg.batch_size == 4 and cfg.optimizer_type == "AdamW"
    assert cfg.num_joints_out == 16 and cfg.estimate_head
    with pytest.raises(ValueError):
        Config.from_preset("no_such_preset")


STAGE1 = ["unrealego_heatmap_joint", "unrealego_heatmap_limb",
          "egocap_heatmap_joint", "egocap_heatmap_limb"]


@pytest.mark.parametrize("preset", STAGE1)
def test_stage1_presets_match_jax(preset):
    """The four stage-1 presets are the JAX ones less the keys the port
    has no field for yet (logging, the training loop's auto-restart), and
    derive the same configuration."""
    from egotap_tpu.core.config import PRESETS as JAX_PRESETS
    from egotap_tpu_torch.core.config import PRESETS
    ref, ours = JAX_PRESETS[preset], PRESETS[preset]
    assert set(ref) - set(ours) == {"experiment_name", "auto_restart"}
    assert ours == {k: ref[k] for k in ours}
    cfg = Config.from_preset(preset)
    want = JaxConfig(**ref).derive()
    for name in DERIVED + TRAINING + ("joint_preset", "num_heatmap",
                                      "num_rot_heatmap", "heatmap_type"):
        assert getattr(cfg, name) == getattr(want, name), name
    assert cfg.model == "heatmap_shared" and cfg.init_ImageNet
