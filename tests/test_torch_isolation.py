"""The port stands alone: egotap_tpu_torch and chip_smoke.py import no
jax, no flax and nothing of egotap_tpu, and the port's entry points run
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
    sys.modules["jax"] = None          # any import of these now fails
    sys.modules["flax"] = None
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
    print(len(names), bad)
""")


def test_port_imports_no_jax_and_nothing_of_egotap_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15            # every module of the slice imported
    assert bad == "[]"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from egotap_tpu_torch.serving import Predictor
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor()
