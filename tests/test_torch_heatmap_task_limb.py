"""The port's stage-1 task on the limb preset (`unrealego_heatmap_limb`:
15 bones as cos/sin maps, the √length-normalised limb loss) against the
JAX package's `HeatmapTask`, and the stage-1 initialisation: the
reference init with the trunk skipped, the torchvision trunk and the
warm start from ``.pth`` files the tests write. Sizes, state and
tolerances: `tests/test_torch_heatmap_task.py`."""

import jax
import pytest
import torch

from egotap_tpu.models.initializers import \
    apply_reference_init as jax_reference_init
from egotap_tpu.models.initializers import \
    load_imagenet_backbone as jax_load_backbone
from egotap_tpu.train.tasks import _load_heatmap_variables
from egotap_tpu_torch.compat.from_jax import heatmap_net_state_dict
from egotap_tpu_torch.models.heatmap_net import HeatmapUNet
from egotap_tpu_torch.models.initializers import (apply_reference_init,
                                                  load_imagenet_backbone)
from egotap_tpu_torch.models.resnet import ResNetEncoder
from egotap_tpu_torch.serving import init_weights
from egotap_tpu_torch.train.state import save_checkpoint
from egotap_tpu_torch.train.tasks import HeatmapTask
from tests.test_torch_compat import heatmap_vars
from tests.test_torch_heatmap_task import (check_eval_step,
                                           check_first_step_gradients,
                                           check_trajectory, configs)

PRESET = "unrealego_heatmap_limb"


def test_first_step_gradients_match_jax():
    loss = check_first_step_gradients(PRESET)
    assert sorted(loss) == ["limb_heatmap_left", "limb_heatmap_right"]


def test_trajectory_matches_jax():
    check_trajectory(PRESET)


def test_eval_step_matches_jax():
    check_eval_step(PRESET)


def _changed(before, after):
    return sorted(k for k in before if not torch.equal(before[k], after[k]))


@pytest.mark.parametrize("skip", [(), ("backbone",)], ids=["all", "trunk"])
def test_reference_init_matches_jax(skip):
    """The same tensors are redrawn as by the JAX package's init (skipping
    the trunk with init_ImageNet): conv weights kaiming (fan_in), biases
    zero, BatchNorm2d weights in [0.02, 1] and biases zero."""
    variables = heatmap_vars(30, 64)
    start = heatmap_net_state_dict(variables)
    jax_params = jax_reference_init(
        variables["params"], jax.random.PRNGKey(0),
        skip_prefixes=tuple((p,) for p in skip))
    want = heatmap_net_state_dict({"params": jax_params,
                                   "batch_stats": variables["batch_stats"]})
    net = HeatmapUNet(30)
    net.load_state_dict(start)
    apply_reference_init(net, torch.Generator().manual_seed(0), skip)
    got = net.state_dict()
    real = [k for k in start if ".fc." not in k]     # fc: zeros both sides
    assert _changed({k: start[k] for k in real}, got) == \
        _changed({k: start[k] for k in real}, want)
    for k in real:
        if _changed({k: start[k]}, want):
            if k.endswith("bias"):
                assert not got[k].any(), k
            elif got[k].dim() == 1:                   # BatchNorm2d
                assert 0.02 <= float(got[k].min()) <= float(got[k].max()) \
                    <= 1.0, k
            else:
                fan_in = got[k][0].numel()
                std = float(got[k].std()) * (fan_in / 2) ** 0.5
                assert 0.8 < std < 1.2, (k, std)


def test_init_state_is_seeded_and_keeps_the_trunk():
    """init_ImageNet (the preset's) keeps the trunk's own init, drawn
    under the seed: torch's defaults, BatchNorm weights 1."""
    cfg, _ = configs(PRESET)
    task = HeatmapTask(cfg, device="cpu")
    a, b, c = (task.init_state(seed, 1).net.state_dict() for seed in (0, 0, 1))
    assert not _changed(a, b)
    assert _changed(a, c)
    assert torch.equal(a["backbone.backbone.backbone.bn1.weight"],
                       torch.ones(64))
    assert not a["after_backbone.conv_up1.0.bias"].any()


def _random_trunk_state(seed):
    trunk = ResNetEncoder("resnet18")
    init_weights(trunk, torch.Generator().manual_seed(seed))
    return trunk.state_dict()


def test_imagenet_backbone_matches_jax(tmp_path):
    """A torchvision resnet18 ``.pth`` (torchvision's keys, running
    statistics included) loads into the trunk as JAX's loader reads it."""
    path = str(tmp_path / "resnet18.pth")
    torch.save(_random_trunk_state(3), path)
    net = load_imagenet_backbone(HeatmapUNet(30), path)
    want = heatmap_net_state_dict(jax_load_backbone(heatmap_vars(30, 64),
                                                    path, "resnet18"))
    got = net.state_dict()
    trunk = [k for k in want if k.startswith("backbone.")
             and ".fc." not in k and not k.endswith("num_batches_tracked")]
    assert len(trunk) > 100
    for k in trunk:
        assert torch.equal(got[k], want[k]), k
    cfg, _ = configs(PRESET, imagenet_backbone=path)
    state = HeatmapTask(cfg, device="cpu").init_state(0, 1)
    for k in trunk:
        assert torch.equal(state.net.state_dict()[k], got[k]), k


def test_warm_start_from_pth(tmp_path):
    """path_to_trained_heatmap: a HeatmapUNet ``.pth`` under ``./log/``
    (rewritten into log_dir) replaces the init, as JAX reads it; so does
    an experiment directory's port checkpoint ``ckpt_best``."""
    src = HeatmapUNet(30)
    init_weights(src, torch.Generator().manual_seed(4))
    (tmp_path / "log" / "exp").mkdir(parents=True)
    torch.save(src.state_dict(), str(tmp_path / "log" / "exp" / "best.pth"))
    fields = dict(log_dir=str(tmp_path / "log"),
                  path_to_trained_heatmap="./log/exp/best.pth")
    cfg, jcfg = configs(PRESET, **fields)
    got = HeatmapTask(cfg, device="cpu").init_state(0, 1).net.state_dict()
    want = heatmap_net_state_dict(_load_heatmap_variables(
        jcfg, jcfg.path_to_trained_heatmap))
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k
        if ".fc." not in k and not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], want[k]), k
    trained = HeatmapTask(cfg, device="cpu").init_state(3, 1)
    save_checkpoint(str(tmp_path / "log" / "exp"), "best", trained)
    cfg, _ = configs(PRESET, log_dir=str(tmp_path / "log"),
                     path_to_trained_heatmap="./log/exp")
    got = HeatmapTask(cfg, device="cpu").init_state(0, 1).net.state_dict()
    for k, v in trained.net.state_dict().items():
        assert torch.equal(got[k], v), k
    cfg, _ = configs(PRESET, path_to_trained_heatmap=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError):
        HeatmapTask(cfg, device="cpu").init_state(0, 1)
