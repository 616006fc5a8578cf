"""Inference/serving API: stereo RGB -> 3D pose on one card or several.

Counterpart of `egotap_tpu/serving.py:Predictor` (bf16, f32 and int8
paths, `shard`, and `from_checkpoint` for `from_orbax`). The forward is
the JAX `_forward`: two `HeatmapUNet`s (pos, rot) on the same stereo
input, their outputs concatenated into the heatmap stack, then
`EgoTAPLifter`.

    pred = Predictor.from_reference_checkpoints(
        heatmap_pth, rot_heatmap_pth, lifter_pth, preset="UnrealEgo")
    pred = Predictor.from_checkpoint(cfg, experiment_dir)   # ckpt_best
    poses = pred(rgb)          # (B, 2, 256, 256, 3) -> (B, J, 3)

Several cards in one process (`shard`): the batch splits over
``num_devices`` data shards, each a replica of the nets, and with
``num_model > 1`` each replica's Grid-ViT is tensor-parallel over
``num_model`` devices (`parallel/tp.py`):

    pred = Predictor(cfg).shard(num_devices=2, num_model=2)   # 4 cards

int8 serving (the deployment configuration of `bench.py`): int8 weights
are quantized at construction, then `calibrate` installs static
activation scales from representative inputs:

    pred = Predictor(bf16=True, int8=True).calibrate(calib_batches)

Runs on the card unless ``device="cpu"`` is passed; with no card and no
``device="cpu"`` construction raises.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import resolve_device, set_f32_numerics
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.models.cells import PUChain
from egotap_tpu_torch.models.heatmap_net import HeatmapUNet
from egotap_tpu_torch.models.lifter import EgoTAPLifter
from egotap_tpu_torch.models.skel_variants import LSTMTreeWalk
from egotap_tpu_torch.ops.quant import (Calibrated, install_scales,
                                        prequantize, set_calibrating)
from egotap_tpu_torch.parallel.tp import shard_lifter
from egotap_tpu_torch.train.state import read_checkpoint
from egotap_tpu_torch.utils import profiling

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
    linears, uniform(+-1/sqrt(H)) for an LSTM walk (as nn.LSTM draws
    them), near-identity BatchNorm with non-trivial running statistics,
    N(0, 0.02) for the ViT's embeddings."""
    lstms = [m for m in module.modules() if isinstance(m, LSTMTreeWalk)]
    drawn = {id(p) for m in lstms for p in m.parameters()}
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if id(p) in drawn:
                continue
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
    for m in lstms:
        m.reset_parameters(generator)


def cast_matmul_weights(module: nn.Module, dtype: torch.dtype) -> None:
    """Store conv and linear weights in the compute dtype once, so the
    per-op casts of the forward are no-ops. The PU chain keeps f32
    parameters: its kernel takes f32 biases and casts its matrices
    itself. An LSTM walk's parameters are not Linear modules: they stay
    f32 and are cast once a forward. int8 modules keep f32 weights, which they quantize (and fold
    BatchNorm into) as the JAX package does. BatchNorm, LayerNorm and
    embeddings stay f32 (they compute in f32)."""
    skip = {id(m) for c in module.modules() if isinstance(c, PUChain)
            for m in c.modules()}
    for m in module.modules():
        if (isinstance(m, (nn.Linear, nn.Conv2d)) and id(m) not in skip
                and not isinstance(m, Calibrated)):
            m.to(dtype)


def build_nets(cfg: Config, int8_heatmap: bool = False,
               int8_lifter: bool = False):
    """(pos_net, rot_net, lifter) of ``cfg``, in their constructors'
    (training) mode with torch's default parameters."""
    pos_net = HeatmapUNet(cfg.num_heatmap, cfg.model_name, cfg.views,
                          quant=int8_heatmap)
    rot_net = HeatmapUNet(cfg.num_rot_heatmap * cfg.limb_dim, cfg.model_name,
                          cfg.views, quant=int8_heatmap)
    lifter = EgoTAPLifter(
        num_heatmap=cfg.num_heatmap, num_joints=cfg.num_joints_out,
        num_rot_heatmap=cfg.num_rot_heatmap, views=cfg.views,
        limb_dim=cfg.limb_dim, hidden_size=cfg.ae_hidden_size,
        skel_layer=cfg.skel_layer, num_pu_layers=cfg.n_skel_layers,
        use_global_offset=(cfg.joint_preset == "UnrealEgo"
                           and cfg.estimate_head),
        pu_semantics=cfg.pu_semantics, heatmap_size=cfg.heatmap_res,
        quant=int8_lifter, parents=get_skeleton(cfg.joint_preset).parents)
    return pos_net, rot_net, lifter


def heatmap_stack(pos_net: nn.Module, rot_net: nn.Module, rgb: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Both stage-1 nets on rgb cast to ``dtype``, concatenated (the
    stack the lifter reads, in ``dtype``)."""
    with profiling.span("stage1"):
        x = rgb.to(dtype)
        return torch.cat([pos_net(x), rot_net(x)], dim=-1)


def pose_forward(nets, rgb: torch.Tensor, dtype: torch.dtype
                 ) -> torch.Tensor:
    """The serving forward of ``nets`` = (pos_net, rot_net, lifter) in
    ``dtype``: (B, V, H, W, 3) rgb -> (B, J, 3) f32 pose. Shared by
    `Predictor` and `train.tasks.LifterTask.eval_step`."""
    pos_net, rot_net, lifter = nets
    hm = heatmap_stack(pos_net, rot_net, rgb, dtype)
    with profiling.span("stage2"):
        return lifter(hm).float()


class Predictor:
    def __init__(self, cfg: Optional[Config] = None,
                 heatmap_state: Optional[StateDict] = None,
                 rot_heatmap_state: Optional[StateDict] = None,
                 lifter_state: Optional[StateDict] = None,
                 bf16: bool = True, int8: Optional[bool] = None,
                 device="cuda", seed: int = 0,
                 model_name: Optional[str] = None):
        """cfg defaults to `serving_config()`; ``model_name`` (resnet18,
        resnet34, resnet50, resnet101) replaces its backbone. Each
        ``*_state`` is a reference-layout state_dict (strict-loaded); one
        left None gets seeded random weights (`init_weights` with
        ``seed``). int8: int8 inference convs and matmuls
        (`ops/quant.py`); None follows ``cfg.int8_heatmap_inference`` /
        ``cfg.int8_lifter_inference``."""
        self.device = resolve_device(device)
        cfg = cfg or serving_config()
        if model_name is not None:
            cfg = dataclasses.replace(cfg, model_name=model_name)
        self.cfg = cfg
        self.bf16 = bf16
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        int8_hm = cfg.int8_heatmap_inference if int8 is None else int8
        int8_lift = cfg.int8_lifter_inference if int8 is None else int8
        if self.device.type == "cuda":
            set_f32_numerics()
        with profiling.span("setup.model", always=True):
            self.pos_net, self.rot_net, self.lifter = build_nets(
                cfg, int8_hm, int8_lift)
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
            self.int8 = (int8_hm, int8_lift)
            self.nets = (self.pos_net, self.rot_net, self.lifter)
            # pre-quantized int8 weights, off the hot path
            prequantize(self.nets)
        self._layout = None         # `shard`'s (num_model, devices)
        self._replicas = None       # (device, nets) of each data shard
        self._warned_dynamic_pad = False
        self._requests = 0          # `__call__`'s count, a request's number

    @torch.no_grad()
    def calibrate(self, rgb_batches) -> "Predictor":
        """Install static activation scales calibrated on representative
        inputs (an iterable of (B, views, H, W, 3) float32 arrays), as
        `egotap_tpu/serving.py:Predictor.calibrate`: each int8 module
        records max|x| in the forward as it stands (dynamic scales for
        >= 128 input channels, float for 64-127, and the lifter on that
        forward's heatmap stack), then gets ``a_scale = max(amax, 1e-12)
        / 127``; all inside the set-up span ``setup.calibrate``. With
        static scales the outputs of a sample no longer depend on the rest
        of its batch, and the 64-channel convs quantize too. A no-op
        unless an int8 mode is on. Returns self."""
        if not any(self.int8):
            return self
        with profiling.span("setup.calibrate", always=True):
            set_calibrating(self.nets, True)
            try:
                for rgb in rgb_batches:
                    hm = self._heatmap_stack(
                        torch.as_tensor(rgb).to(self.device))
                    if self.int8[1]:
                        self.lifter(hm)
            finally:
                set_calibrating(self.nets, False)
            install_scales(self.nets)
        if self._layout is not None:      # re-place the new scales
            self._place(*self._layout)
        return self

    def _has_static_scales(self) -> bool:
        """True once `calibrate` installed static scales."""
        return any(isinstance(m, Calibrated) and m.a_scale is not None
                   for net in self.nets for m in net.modules())

    def _heatmap_stack(self, rgb: torch.Tensor, dtype=None) -> torch.Tensor:
        return heatmap_stack(self.pos_net, self.rot_net, rgb,
                             dtype or self.dtype)

    @torch.no_grad()
    def _forward(self, rgb: torch.Tensor) -> torch.Tensor:
        return pose_forward(self.nets, rgb, self.dtype)

    def __call__(self, rgb, pad_ragged: bool = True) -> np.ndarray:
        """rgb: (B, views, H, W, 3) ImageNet-normalized float32 (numpy or
        tensor) -> (B, num_joints, 3) float32 numpy.

        A sharded predictor splits the batch over its data shards; a
        batch they do not divide is zero-padded to the next multiple and
        the pad rows are dropped (``pad_ragged=False`` raises instead).
        Pad rows cannot reach real rows (eval-mode BatchNorm, static
        int8 scales after `calibrate`); under dynamic int8 scales they
        shift the per-call scales, and a warning says so once."""
        x = torch.as_tensor(rgb)
        self._requests += 1
        with profiling.span("serve.request", root=self._requests):
            if self._replicas is None:
                with profiling.span("serve.h2d"):
                    x = x.to(self.device)
                out = self._forward(x)
                with profiling.span("serve.d2h"):
                    return out.cpu().numpy()
            return self._sharded(x, pad_ragged)

    def _sharded(self, x: torch.Tensor, pad_ragged: bool) -> np.ndarray:
        """`__call__` over the data shards of `shard`."""
        n_valid, n = x.shape[0], len(self._replicas)
        rem = n_valid % n
        if rem and not pad_ragged:
            raise ValueError(f"batch size {n_valid} not divisible by the "
                             f"{n}-way data split; pad the batch or "
                             "re-shard")
        if rem:
            if any(self.int8) and not self._has_static_scales() \
                    and not self._warned_dynamic_pad:
                warnings.warn(
                    "padding a ragged batch with dynamic int8 activation "
                    "scales perturbs real-row outputs; call calibrate() "
                    "for padding-invariant numerics or pass "
                    "pad_ragged=False", stacklevel=3)
                self._warned_dynamic_pad = True
            x = torch.cat([x, x.new_zeros((n - rem,) + x.shape[1:])])
        outs = []
        with torch.no_grad():
            for (dev, nets), chunk in zip(self._replicas, x.chunk(n)):
                with profiling.span("serve.h2d"):
                    chunk = chunk.to(dev)
                outs.append(pose_forward(nets, chunk, self.dtype))
        with profiling.span("serve.d2h"):
            return torch.cat([o.cpu() for o in outs])[:n_valid].numpy()

    def shard(self, num_devices: int = 0, num_model: int = 1,
              devices: Optional[Sequence] = None) -> "Predictor":
        """Serve over ``num_devices`` x ``num_model`` devices
        (`egotap_tpu/serving.py:Predictor.shard`): data shard d holds a
        replica of the nets on ``devices[d * num_model]``, its Grid-ViT
        tensor-parallel over ``devices[d * num_model:(d + 1) *
        num_model]`` (`parallel/tp.py`). ``devices`` defaults to every
        visible card; ``num_devices`` 0 takes as many shards as they
        hold. Fewer devices than asked for raise; a list with repeats is
        the one way to put shards on the same card. Per-sample outputs
        are the unsharded predictor's up to summation order. Returns
        self."""
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = [resolve_device(d) for d in devices]
        if num_devices == 0:
            num_devices = len(devices) // num_model
        need = num_devices * num_model
        if num_devices < 1 or len(devices) < need:
            raise RuntimeError(f"{num_devices} data x {num_model} model "
                               f"shards need {need} devices, "
                               f"{len(devices)} given")
        self._place(num_model, devices[:need])
        return self

    def _place(self, num_model: int, devices) -> None:
        """Build the replicas of `shard` from the predictor's nets."""
        self._layout = (num_model, devices)
        self._replicas = []
        for d in range(len(devices) // num_model):
            group = devices[d * num_model:(d + 1) * num_model]
            pos, rot = (copy.deepcopy(net).to(group[0])
                        for net in (self.pos_net, self.rot_net))
            self._replicas.append(
                (group[0], (pos, rot, shard_lifter(self.lifter, group))))

    @torch.no_grad()
    def heatmaps(self, rgb) -> np.ndarray:
        """Debug path: the concatenated stage-1 heatmap stack, f32.

        As `egotap_tpu/serving.py:Predictor.heatmaps`, the nets run on the
        f32 input uncast, so every op computes in f32 also when ``bf16``
        is set. One difference stays: a bf16 predictor stores its conv
        weights rounded to bf16 (`cast_matmul_weights`), where JAX keeps
        f32 parameters, so its f32 stack is computed with bf16-rounded
        weights (tests/test_torch_predictor.py states the budget)."""
        hm = self._heatmap_stack(torch.as_tensor(rgb).to(self.device),
                                 torch.float32)
        return hm.float().cpu().numpy()

    @classmethod
    def from_reference_checkpoints(cls, heatmap_pth: str,
                                   rot_heatmap_pth: str, lifter_pth: str,
                                   preset: str = "UnrealEgo",
                                   bf16: bool = True,
                                   int8: Optional[bool] = None,
                                   device="cuda",
                                   **cfg_overrides) -> "Predictor":
        """Build from released EgoTAP ``.pth`` files
        (best_net_HeatMap / best_net_RotHeatMap / best_net_AutoEncoder)."""
        cfg = serving_config(preset, **cfg_overrides)
        resolve_device(device)

        def load(path):
            return torch.load(path, map_location="cpu", weights_only=True)

        return cls(cfg, load(heatmap_pth), load(rot_heatmap_pth),
                   load(lifter_pth), bf16=bf16, int8=int8, device=device)

    @classmethod
    def from_checkpoint(cls, cfg: Config, experiment_dir: str,
                        tag: str = "best", bf16: bool = True,
                        int8: Optional[bool] = None,
                        device="cuda") -> "Predictor":
        """Build from a port stage-2 checkpoint ``{experiment_dir}/
        ckpt_{tag}`` (`train/state.py`; the counterpart of
        `egotap_tpu/serving.py:Predictor.from_orbax`): the lifter from its
        ``net``, the pos and rot nets from ``frozen["heatmap"]`` /
        ``frozen["rot_heatmap"]`` with the running statistics stage-2
        training evolved."""
        resolve_device(device)
        saved = read_checkpoint(os.path.join(experiment_dir, f"ckpt_{tag}"))
        frozen = saved["frozen"]
        return cls(cfg, frozen["heatmap"], frozen["rot_heatmap"],
                   saved["net"], bf16=bf16, int8=int8, device=device)
