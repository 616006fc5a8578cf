"""The port stands alone: egotap_tpu_torch and chip_smoke.py import no
jax, no flax and nothing of egotap_tpu, every module imports without
OpenCV, PIL and h5py (the H100 machine has none of them; the offline
code imports them where it uses them), and the port's entry points run
on the card unless the caller asks for the CPU."""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    for blocked in ("jax", "flax", "cv2", "PIL", "h5py"):
        sys.modules[blocked] = None     # any import of these now fails
    import egotap_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(
        egotap_tpu_torch.__path__, "egotap_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    bad = sorted(m for m in sys.modules
                 if m == "egotap_tpu" or m.startswith("egotap_tpu.")
                 or (m.split(".")[0] in ("jax", "flax", "jaxlib")
                     and sys.modules[m] is not None))
    print(len(names), bad, sorted(n for n in names if n in NEW))
""")

# the modules of the last slice, each of which must be among those imported
NEW = ("egotap_tpu_torch.core.rotations", "egotap_tpu_torch.data.heatmaps",
       "egotap_tpu_torch.data.integrity", "egotap_tpu_torch.preprocess.egocap",
       "egotap_tpu_torch.preprocess.unrealego",
       "egotap_tpu_torch.train.search", "egotap_tpu_torch.utils.images",
       "egotap_tpu_torch.models.encoders", "egotap_tpu_torch.models.resnet")


def test_port_imports_no_jax_and_nothing_of_egotap_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    probe = f"NEW = {NEW!r}\n" + _PROBE
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad, new = out.stdout.strip().split(" ", 2)
    assert int(count) >= 58            # every module of the port imported
    assert bad == "[]"
    assert new == repr(sorted(NEW))


@pytest.mark.parametrize("int8", [False, True])
def test_entry_points_default_to_cuda(int8):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from egotap_tpu_torch.serving import Predictor
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(int8=int8)


@pytest.mark.parametrize("entry", ["LifterTask", "create_task"])
def test_lifter_task_defaults_to_cuda(entry):
    """The training task runs on the card unless the caller asks for the
    CPU: with no card it raises, with device='cpu' it builds."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.train import tasks
    cfg = Config.from_preset("egotap_unrealego")
    make = getattr(tasks, entry)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(cfg)
    assert make(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("fields", [
    dict(),                                    # the Config default: LSTM
    dict(skel_layer="LSTMSplit", optimizer_type="Prodigy"),
    dict(skel_layer="PU", pu_semantics="tree", n_skel_layers=3,
         optimizer_type="DAdam")])
def test_lifter_variants_default_to_cuda(fields):
    """The skeleton layers and learned-LR optimizers ported last: the
    stage-2 task of each raises with no card and builds on the CPU when
    asked, with the module the configuration names (no PU kernel path
    for the tree) and the optimizer it names."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.models.skel_variants import LSTMTreeWalk
    from egotap_tpu_torch.train.tasks import create_task
    cfg = Config(model="egotap_autoencoder", num_heatmap=15,
                 num_rot_heatmap=15, heatmap_type="sin", ae_hidden_size=8,
                 **fields).derive()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_task(cfg)
    state = create_task(cfg, device="cpu").init_state(0, 2)
    layer = next(iter(state.net.skel_sequential_layer.values()))
    if cfg.skel_layer == "PU":
        assert not layer.uses_kernel and len(layer.layers) == 3
    else:
        assert isinstance(layer, LSTMTreeWalk)
    assert state.opt.kind == {"Adam": "adam", "Prodigy": "prodigy",
                              "DAdam": "dadam"}[cfg.optimizer_type]
    assert all(p.device.type == "cpu" for p in state.net.parameters())


@pytest.mark.parametrize("entry,preset", [
    ("HeatmapTask", "unrealego_heatmap_joint"),
    ("create_task", "unrealego_heatmap_joint"),
    ("create_task", "unrealego_heatmap_limb")])
def test_heatmap_task_defaults_to_cuda(entry, preset):
    """The stage-1 task, built directly or by `create_task` from a
    stage-1 preset: with no card it raises, with device='cpu' it builds a
    `HeatmapTask`."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.train import tasks
    cfg = Config.from_preset(preset)
    make = getattr(tasks, entry)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make(cfg)
    task = make(cfg, device="cpu")
    assert isinstance(task, tasks.HeatmapTask) and task.device.type == "cpu"


@pytest.mark.parametrize("entry", ["cli.train", "cli.test", "evaluate"])
def test_cli_and_evaluate_default_to_cuda(entry, tmp_path):
    """The CLIs' `main` and `evaluate` run on the card unless the caller
    asks for the CPU: with no card they raise before touching the
    dataset or the log directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv = ["--preset", "unrealego_heatmap_joint", "--data_dir",
            str(tmp_path / "missing"), "--log_dir", str(tmp_path / "log"),
            "--result_dir", str(tmp_path / "results")]
    if entry == "evaluate":
        from egotap_tpu_torch.core.config import Config
        from egotap_tpu_torch.eval.evaluate import evaluate
        from egotap_tpu_torch.train.tasks import create_task
        cfg = Config.from_args(argv)
        call = lambda: evaluate(cfg, create_task(cfg, device="cpu"), None)
    else:
        import importlib
        main = importlib.import_module(f"egotap_tpu_torch.{entry}").main
        call = lambda: main(argv)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert not os.path.exists(tmp_path / "log")


@pytest.mark.parametrize("model_name", ["resnet50", "resnet101"])
def test_bottleneck_entry_points_default_to_cuda(model_name):
    """The Bottleneck nets' entry points: `Predictor(model_name=...)` and
    the stage-1 task raise with no card; the task builds on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.serving import Predictor
    from egotap_tpu_torch.train.tasks import HeatmapTask
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model_name=model_name)
    cfg = Config.from_args(["--preset", "unrealego_heatmap_joint",
                            "--model_name", model_name])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeatmapTask(cfg)
    assert HeatmapTask(cfg, device="cpu").cfg.model_name == model_name
