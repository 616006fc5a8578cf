"""What every driver shares: the seed's purposes, the drawn states, the
kernels' build, and the program's `Config` from a configuration file."""

from __future__ import annotations

import time
from typing import Dict

import torch

from benchmark import reference as R
from benchmark import weights as W

# the purposes a run's seed is split into (`weights.sub_seed`); a training
# cell draws its poses where a serving cell draws its sample
KEYS = {"pos_net": 1, "rot_net": 2, "lifter": 3, "frames": 4, "sample": 5,
        "poses": 5, "init": 6, "calibration": 7}


def draw_states(cfg: Dict, seed: int, device, lifter_style: str = "serve"):
    """The reference-layout state of each net, drawn from ``seed``."""
    with torch.device("meta"):
        model = R.EgoTAP(cfg)
    states = {}
    for name in ("pos_net", "rot_net", "lifter"):
        style = lifter_style if name == "lifter" else "serve"
        states[name] = W.draw_state(getattr(model, name), seed, KEYS[name],
                                    device, style)
    return model, states


def build_kernels(device: str, phases: Dict[str, float]) -> None:
    """Set-up's first phase on the card: the program's kernel libraries
    built, or found built (`egotap_tpu_torch/build/`), and TF32 off for
    the reference's float32 products."""
    t = time.perf_counter()
    if device == "cuda":
        from egotap_tpu_torch.ops import _build
        _build.build_all()
        R.f32_numerics()
    phases["kernels"] = time.perf_counter() - t


def port_config(cfg: Dict):
    """The program's `Config`: the configuration's keys that its
    ``program`` list names, as they stand in the file."""
    from egotap_tpu_torch.core.config import Config
    fields = {k: cfg[k] for k in cfg["program"]}
    fields["load_size_heatmap"] = tuple(fields["load_size_heatmap"])
    return Config(**fields).derive()
