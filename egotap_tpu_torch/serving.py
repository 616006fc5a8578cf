"""Inference/serving API: stereo RGB -> 3D pose on one card.

Counterpart of `egotap_tpu/serving.py:Predictor` (bf16 and f32 paths;
int8, ``shard()``, ``calibrate()`` and ``from_orbax()`` are not ported
yet). The forward is the JAX `_forward`: two `HeatmapUNet`s (pos, rot)
on the same stereo input, their outputs concatenated into the heatmap
stack, then `EgoTAPLifter`.

    pred = Predictor.from_reference_checkpoints(
        heatmap_pth, rot_heatmap_pth, lifter_pth, preset="UnrealEgo")
    poses = pred(rgb)          # (B, 2, 256, 256, 3) -> (B, J, 3)

Runs on the card unless ``device="cpu"`` is passed; with no card and no
``device="cpu"`` construction raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import resolve_device, set_f32_numerics
from egotap_tpu_torch.models.cells import PUChain
from egotap_tpu_torch.models.heatmap_net import HeatmapUNet
from egotap_tpu_torch.models.lifter import EgoTAPLifter

StateDict = Dict[str, torch.Tensor]


def serving_config(preset: str = "UnrealEgo", **overrides) -> Config:
    """The released EgoTAP pose-estimator configuration (reference
    scripts/test/*.sh): sin limb heatmaps, Grid-ViT + PU lifter,
    ae_hidden_size 128."""
    nh = 15 if preset == "UnrealEgo" else 17
    fields = dict(joint_preset=preset, num_heatmap=nh, num_rot_heatmap=nh,
                  heatmap_type="sin", skel_layer="PU", ae_hidden_size=128)
    fields.update(overrides)
    return Config(**fields).derive()


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: uniform(+-1/sqrt(fan_in)) for convs and
    linears, near-identity BatchNorm with non-trivial running statistics,
    N(0, 0.02) for the ViT's embeddings."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.dim() >= 2 and leaf == "weight":
                bound = 1.0 / np.sqrt(p[0].numel())
                p.uniform_(-bound, bound, generator=generator)
            elif leaf in ("mask_token", "cls_token", "position_embeddings"):
                p.normal_(0.0, 0.02, generator=generator)
            else:
                p.uniform_(-0.05, 0.05, generator=generator)
        for m in module.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.uniform_(0.9, 1.1, generator=generator)
                m.running_mean.normal_(0.0, 0.05, generator=generator)
                m.running_var.uniform_(0.8, 1.2, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)


def cast_matmul_weights(module: nn.Module, dtype: torch.dtype) -> None:
    """Store conv and linear weights in the compute dtype once, so the
    per-op casts of the forward are no-ops. The PU chain keeps f32
    parameters: its kernel takes f32 biases and casts its matrices
    itself. BatchNorm, LayerNorm and embeddings stay f32 (they compute
    in f32)."""
    skip = {id(m) for c in module.modules() if isinstance(c, PUChain)
            for m in c.modules()}
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)) and id(m) not in skip:
            m.to(dtype)


class Predictor:
    def __init__(self, cfg: Optional[Config] = None,
                 heatmap_state: Optional[StateDict] = None,
                 rot_heatmap_state: Optional[StateDict] = None,
                 lifter_state: Optional[StateDict] = None,
                 bf16: bool = True, device="cuda", seed: int = 0):
        """cfg defaults to `serving_config()`. Each ``*_state`` is a
        reference-layout state_dict (strict-loaded); one left None gets
        seeded random weights (`init_weights` with ``seed``)."""
        self.device = resolve_device(device)
        cfg = cfg or serving_config()
        self.cfg = cfg
        self.bf16 = bf16
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        if self.device.type == "cuda":
            set_f32_numerics()
        self.pos_net = HeatmapUNet(cfg.num_heatmap, cfg.model_name, cfg.views)
        self.rot_net = HeatmapUNet(cfg.num_rot_heatmap * cfg.limb_dim,
                                   cfg.model_name, cfg.views)
        self.lifter = EgoTAPLifter(
            num_heatmap=cfg.num_heatmap, num_joints=cfg.num_joints_out,
            num_rot_heatmap=cfg.num_rot_heatmap, views=cfg.views,
            limb_dim=cfg.limb_dim, hidden_size=cfg.ae_hidden_size,
            skel_layer=cfg.skel_layer, num_pu_layers=cfg.n_skel_layers,
            use_global_offset=(cfg.joint_preset == "UnrealEgo"
                               and cfg.estimate_head),
            pu_semantics=cfg.pu_semantics, heatmap_size=cfg.heatmap_res)
        gen = torch.Generator().manual_seed(seed)
        for net, state in ((self.pos_net, heatmap_state),
                           (self.rot_net, rot_heatmap_state),
                           (self.lifter, lifter_state)):
            if state is None:
                init_weights(net, gen)
            else:
                net.load_state_dict(state, strict=True)
            net.eval().to(self.device)
            cast_matmul_weights(net, self.dtype)

    def _heatmap_stack(self, rgb: torch.Tensor) -> torch.Tensor:
        x = rgb.to(self.dtype)
        return torch.cat([self.pos_net(x), self.rot_net(x)], dim=-1)

    @torch.no_grad()
    def _forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return self.lifter(self._heatmap_stack(rgb)).float()

    def __call__(self, rgb) -> np.ndarray:
        """rgb: (B, views, H, W, 3) ImageNet-normalized float32 (numpy or
        tensor) -> (B, num_joints, 3) float32 numpy."""
        x = torch.as_tensor(rgb).to(self.device)
        return self._forward(x).cpu().numpy()

    @torch.no_grad()
    def heatmaps(self, rgb) -> np.ndarray:
        """Debug path: the concatenated stage-1 heatmap stack, in the
        predictor's compute dtype, returned as f32."""
        hm = self._heatmap_stack(torch.as_tensor(rgb).to(self.device))
        return hm.float().cpu().numpy()

    @classmethod
    def from_reference_checkpoints(cls, heatmap_pth: str,
                                   rot_heatmap_pth: str, lifter_pth: str,
                                   preset: str = "UnrealEgo",
                                   bf16: bool = True, device="cuda",
                                   **cfg_overrides) -> "Predictor":
        """Build from released EgoTAP ``.pth`` files
        (best_net_HeatMap / best_net_RotHeatMap / best_net_AutoEncoder)."""
        cfg = serving_config(preset, **cfg_overrides)
        resolve_device(device)

        def load(path):
            return torch.load(path, map_location="cpu", weights_only=True)

        return cls(cfg, load(heatmap_pth), load(rot_heatmap_pth),
                   load(lifter_pth), bf16=bf16, device=device)
