"""Model FLOPs of a cell, counted on the plain reference.

`torch.utils.flop_counter.FlopCounterMode` runs the reference on the meta
device at the cell's shapes and counts its matrix products and
convolutions: what the work needs, whatever kernels the program runs it
with. Serving counts one forward of both stages; training counts the
frozen heatmap nets' forward and the lifter's forward and backward (not
a backward's recompute).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import reference as R


def count(cfg: Dict, batch: int, train: bool) -> int:
    size = cfg["image_size"]
    with torch.device("meta"):
        model = R.EgoTAP(cfg)
        rgb = torch.empty(batch, cfg["views"], size, size, 3)
        gt = torch.empty(batch, cfg["joints_out"], 3)
    counter = FlopCounterMode(display=False)
    with counter:
        if not train:
            with torch.no_grad():
                model(rgb)
        else:
            with torch.no_grad():
                hm = torch.cat(model.heatmaps(rgb, train=True), -1)
            params = [p for p in model.lifter.parameters()]
            loss = sum(R.pose_losses(model.lifter(hm, train=True), gt, cfg,
                                     cfg["parents"]).values())
            torch.autograd.grad(loss, params, allow_unused=True)
    return int(counter.get_total_flops())
