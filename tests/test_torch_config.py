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
