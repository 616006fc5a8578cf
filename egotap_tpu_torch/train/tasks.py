"""The two tasks, trained and evaluated one step at a time.

Counterparts of `egotap_tpu/train/tasks.py` and `create_task`:
  * `HeatmapTask`, stage 1 (reference model/heatmap_shared_model.py):
    one `HeatmapUNet` on the stereo RGB, trained in train-mode BatchNorm
    (per-view statistics) against the rendered joint or limb targets
    (`data.pipeline.make_device_preprocess`) with stage-1 Adam (eps
    1e-8); evaluation gives the per-sample ``mse_heatmap``.
  * `LifterTask`, stage 2 (reference model/egotap_autoencoder_model.py):
    frozen heatmap nets + the EgoTAP lifter; only the lifter is
    optimized. Parity quirks kept: during training the frozen stage-1
    nets run with train-mode BatchNorm (per-view statistics) and their
    running statistics evolve, while their parameters never change and
    no gradient reaches them (the reference calls model.train() on
    everything, train.py:91); evaluation uses the running statistics.

Compute dtype: bf16 under ``use_amp`` or ``compute_dtype="bfloat16"``
in the training step. Parameters stay f32 and every op casts them to
its input's dtype, so the gradients and the optimizer are f32. The
stage-1 eval step runs on the f32 input uncast, as JAX's does.

    task = create_task(cfg)                   # device="cuda" by default
    state = task.init_state(seed=0, iters_per_epoch=1000)
    state, losses = task.train_step(state, batch)
    out = task.eval_step(state, batch)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import resolve_device, set_f32_numerics
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.eval.metrics import pose_metrics
from egotap_tpu_torch.models.heatmap_net import HeatmapUNet
from egotap_tpu_torch.models.initializers import (apply_reference_init,
                                                  load_imagenet_backbone)
from egotap_tpu_torch.models.layers import global_batch_statistics
from egotap_tpu_torch.serving import (Predictor, build_nets, init_weights,
                                      pose_forward)
from egotap_tpu_torch.train import losses as L
from egotap_tpu_torch.train.optim import make_optimizer
from egotap_tpu_torch.train.state import TrainState, read_checkpoint
from egotap_tpu_torch.utils import profiling

Batch = Dict[str, torch.Tensor]
StateDict = Dict[str, torch.Tensor]


def compute_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.use_amp or cfg.compute_dtype == "bfloat16"
            else torch.float32)


Grads = Dict[str, Optional[torch.Tensor]]


def net_gradients(net: nn.Module,
                  losses: Callable[[], Dict[str, torch.Tensor]]
                  ) -> Tuple[Dict[str, torch.Tensor], Grads]:
    """Run ``losses`` (a forward of ``net`` and its loss terms) with
    ``net`` in training mode and grad mode on; returns the detached terms
    and the gradients of their sum by parameter name (None for a
    parameter the forward does not use). ``net`` is left in eval mode."""
    net.train()
    try:
        with torch.enable_grad():
            with profiling.span("train.net_forward"):
                loss_d = losses()
            params = dict(net.named_parameters())
            with profiling.span("train.backward"):
                grads = torch.autograd.grad(sum(loss_d.values()),
                                            list(params.values()),
                                            allow_unused=True)
    finally:
        net.eval()
    return ({k: v.detach() for k, v in loss_d.items()},
            dict(zip(params, grads)))


class _Task:
    """What the two tasks share: the device, the compute dtype, the batch
    moved to the device, and the optimizer step. ``dp``: the
    data-parallel process group (`parallel.mesh.DataParallel`) the step
    runs over, or None for one process."""

    def __init__(self, cfg: Config, device="cuda", dp=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_numerics()
        self.cfg = cfg
        self.dtype = compute_dtype(cfg)
        self.dp = dp

    def _batch(self, batch) -> Batch:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def step_gradients(self, state: TrainState, batch
                       ) -> Tuple[Dict[str, torch.Tensor], Grads]:
        """The losses and gradients `train_step` applies: the task's
        `gradients`, over a process group with BatchNorm statistics of
        the global batch, then averaged over the ranks."""
        with global_batch_statistics(self.dp):
            loss_d, grads = self.gradients(state, batch)
        if self.dp is not None:
            grads = self.dp.average_gradients(grads)
            loss_d = self.dp.average(loss_d)
        return loss_d, grads

    def train_step(self, state: TrainState, batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step of the trained net on ``batch`` (see the
        task's `gradients`); updates ``state`` in place and returns it
        with the losses.

        Over a process group (``dp``) ``batch`` holds this rank's rows:
        train-mode BatchNorm takes its statistics over the global batch,
        and the gradients and losses are averaged over the ranks before
        the optimizer, so that the step is the single-process step at
        the global batch and every rank holds the same losses."""
        with profiling.span("train.step", root=state.step):
            loss_d, grads = self.step_gradients(state, batch)
            with profiling.span("train.optimizer"):
                state.opt.step(dict(state.net.named_parameters()), grads)
            state.step += 1
        return state, loss_d


def load_heatmap_state(cfg: Config, path: str) -> StateDict:
    """A trained HeatmapUNet's reference-layout state_dict
    (`egotap_tpu/train/tasks.py:_load_heatmap_variables`): from a ``.pth``
    file, or the ``net`` of a port checkpoint directory (``.../ckpt_{tag}``
    or an experiment directory holding ``ckpt_best``), with the
    reference's rewrite of a ``./log/`` path into ``cfg.log_dir``
    (base_model.py:140-142)."""
    if path.startswith("./log/"):
        path = os.path.join(cfg.log_dir, path[len("./log/"):])
    if os.path.isfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    ckpt = path if os.path.basename(path).startswith("ckpt_") \
        else os.path.join(path, "ckpt_best")
    if os.path.isdir(ckpt):
        return read_checkpoint(ckpt)["net"]
    raise FileNotFoundError(f"no heatmap checkpoint at {path}")


class HeatmapTask(_Task):
    """Stage-1 heatmap estimator: one HeatmapUNet, trained and evaluated."""

    name = "Heatmap Shared model"    # the training loop's watchdog reads it
    eval_key = "mse_heatmap"         # the metric that picks `best`

    def __init__(self, cfg: Config, device="cuda", dp=None):
        super().__init__(cfg, device, dp)
        self.nh, self.nr, self.ld = (cfg.num_heatmap, cfg.num_rot_heatmap,
                                     cfg.limb_dim)
        self.views = cfg.views
        self.sides = ("left", "right")[: self.views]
        self.loss_names: List[str] = []
        if self.nh > 0:
            self.loss_names += [f"heatmap_{s}" for s in self.sides]
        if self.nr > 0:
            self.loss_names += [f"limb_heatmap_{s}" for s in self.sides]

    def init_state(self, seed: int, iters_per_epoch: int) -> TrainState:
        """Seeded initial state (`egotap_tpu/train/tasks.py:
        HeatmapTask.init_state`): the reference's init (kaiming convs,
        zero biases, U[0.02, 1] BatchNorm2d weights, `apply_reference_init`)
        everywhere, except that with ``init_ImageNet`` the ResNet trunk
        keeps its own: torch's constructor defaults drawn under ``seed``,
        or a torchvision resnet ``.pth`` named by ``imagenet_backbone``.
        ``path_to_trained_heatmap`` then replaces everything (warm start).
        The optimizer is stage-1 Adam (eps 1e-8) whatever
        ``optimizer_type`` says, as the reference builds it
        (heatmap_shared_model.py:70-74)."""
        with profiling.span("setup.model", always=True):
            cfg = self.cfg
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                net = HeatmapUNet(self.nh + self.nr * self.ld, cfg.model_name,
                                  self.views)
            skip = ("backbone",) if cfg.init_ImageNet else ()
            apply_reference_init(net, torch.Generator().manual_seed(seed),
                                 skip)
            if cfg.init_ImageNet and cfg.imagenet_backbone:
                load_imagenet_backbone(net, cfg.imagenet_backbone)
            if cfg.path_to_trained_heatmap:
                net.load_state_dict(load_heatmap_state(
                    cfg, cfg.path_to_trained_heatmap), strict=True)
            return TrainState.create(
                net, {}, make_optimizer(cfg, iters_per_epoch, stage1=True),
                self.device)

    def _split(self, out: torch.Tensor
               ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """[posL, posR], [limbL, limbR] channel groups
        (reference model/heatmap_shared_model.py:101-108)."""
        v, nh, nld = self.views, self.nh, self.nr * self.ld
        pos = [out[..., i * nh:(i + 1) * nh] for i in range(v)] if nh else []
        base = nh * v
        limb = [out[..., base + i * nld: base + (i + 1) * nld]
                for i in range(v)] if nld else []
        return pos, limb

    def _losses(self, out: torch.Tensor, batch: Batch
                ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        pos, limb = self._split(out)
        out_d: Dict[str, torch.Tensor] = {}
        for i, side in enumerate(self.sides):
            if self.nh > 0:
                out_d[f"heatmap_{side}"] = cfg.lambda_heatmap * L.heatmap_mse(
                    pos[i], batch[f"gt_heatmap_{side}"])
            if self.nr > 0:
                out_d[f"limb_heatmap_{side}"] = (
                    cfg.lambda_rot_heatmap * L.limb_heatmap_mse(
                        limb[i], batch[f"gt_limb_heatmap_{side}"],
                        batch[f"gt_plength_{side}"]))
        return out_d

    def gradients(self, state: TrainState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Grads]:
        """The forward (train-mode BatchNorm, running statistics updated)
        and backward of one training step on a preprocessed ``batch``
        (``input_rgb`` (B, V, H, W, 3), cast to the compute dtype, and the
        targets of `make_device_preprocess`): the losses and the net's
        gradients by parameter name."""
        batch = self._batch(batch)
        rgb = batch["input_rgb"].to(self.dtype)
        return net_gradients(state.net, lambda: self._losses(
            state.net(rgb).float(), batch))

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, object]:
        """Eval-mode forward on the input as given (f32: JAX's eval step
        does not cast it) and the per-sample ``mse_heatmap``: the mean
        squared error of each side's joint maps plus that of its
        √length-normalised limb maps."""
        batch = self._batch(batch)
        out = state.net(batch["input_rgb"]).float()
        pos, limb = self._split(out)
        mse = out.new_zeros(out.shape[0])
        for i, side in enumerate(self.sides):
            if self.nh > 0:
                d = (pos[i] - batch[f"gt_heatmap_{side}"]) ** 2
                mse = mse + d.mean(dim=(1, 2, 3))
            if self.nr > 0:
                norm = batch[f"gt_plength_{side}"].sqrt()[:, None, None, :]
                d = ((limb[i] - batch[f"gt_limb_heatmap_{side}"]) / norm) ** 2
                mse = mse + d.mean(dim=(1, 2, 3))
        return {"metrics": {"mse_heatmap": mse}, "pred_heatmap": out}


class LifterTask(_Task):
    """Stage-2 pose estimator: frozen heatmap nets + EgoTAP lifter."""

    name = "EgoTAP AutoEncoder model"
    eval_key = "mpjpe"

    def __init__(self, cfg: Config, device="cuda", dp=None):
        super().__init__(cfg, device, dp)
        self.sk = get_skeleton(cfg.joint_preset)

    def init_state(self, seed: int, iters_per_epoch: int,
                   heatmap_state: Optional[StateDict] = None,
                   rot_heatmap_state: Optional[StateDict] = None
                   ) -> TrainState:
        """Seeded initial state. The frozen nets load the given
        reference-layout state_dicts, or get seeded random weights
        (`serving.init_weights`); the lifter is drawn as the reference
        draws it: HF randn position embeddings, then kaiming everywhere
        (`apply_reference_init`)."""
        with profiling.span("setup.model", always=True):
            gen = torch.Generator().manual_seed(seed)
            pos_net, rot_net, lifter = build_nets(self.cfg)
            for net, state in ((pos_net, heatmap_state),
                               (rot_net, rot_heatmap_state)):
                if state is None:
                    init_weights(net, gen)
                else:
                    net.load_state_dict(state, strict=True)
            with torch.no_grad():
                lifter.pos_heatmap_encoder.vit.embeddings.position_embeddings \
                    .normal_(generator=gen)
            apply_reference_init(lifter, gen)
            return TrainState.create(
                lifter, {"heatmap": pos_net, "rot_heatmap": rot_net},
                make_optimizer(self.cfg, iters_per_epoch), self.device)

    def _gt_heatmaps(self, batch: Batch) -> torch.Tensor:
        views = ("left", "right")[: self.cfg.views]
        return torch.cat([batch[f"gt_heatmap_{s}"] for s in views]
                         + [batch[f"gt_limb_heatmap_{s}"] for s in views],
                         dim=-1)

    @torch.no_grad()
    def _forward_heatmaps(self, frozen, batch: Batch) -> torch.Tensor:
        """The frozen stage-1 nets in training mode: batch statistics,
        running statistics updated, no gradient (reference forward_heatmap,
        egotap_autoencoder_model.py:177-216)."""
        if self.cfg.use_gt_heatmap:
            return self._gt_heatmaps(batch)
        rgb = batch["input_rgb"].to(self.dtype)
        outs = []
        for key in ("heatmap", "rot_heatmap"):
            net = frozen[key].train()
            try:
                outs.append(net(rgb))
            finally:
                net.eval()
        return torch.cat(outs, dim=-1)

    def _pose_losses(self, pose: torch.Tensor, batch: Batch
                     ) -> Dict[str, torch.Tensor]:
        cfg, gt = self.cfg, batch["gt_local_pose"]
        return {
            "pose": cfg.lambda_mpjpe * L.mpjpe(pose, gt),
            "cos_sim": cfg.lambda_cos_sim * cfg.lambda_mpjpe * L.cos_sim(
                pose, gt, self.sk.parents, estimate_head=cfg.estimate_head),
        }

    def gradients(self, state: TrainState, batch
                  ) -> Tuple[Dict[str, torch.Tensor], Grads]:
        """The forward and backward of one training step on ``batch``
        (``input_rgb`` (B, V, H, W, 3) or the gt heatmaps, and
        ``gt_local_pose`` (B, J, 3)): the losses and the lifter's
        gradients by parameter name (None for a parameter the forward
        does not use). BatchNorm running statistics (the lifter's and the
        frozen nets') update as in training; parameters do not."""
        batch = self._batch(batch)
        with profiling.span("train.frozen_forward"):
            hm_cat = self._forward_heatmaps(state.frozen, batch)
        return net_gradients(state.net, lambda: self._pose_losses(
            state.net(hm_cat.to(self.dtype)).float(), batch))

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, object]:
        """Eval-mode forward (the int8 twins of `prepare_inference` when
        the state carries them) and per-sample metrics in mm."""
        batch = self._batch(batch)
        nets = (state.inference.nets if state.inference is not None else
                (state.frozen["heatmap"], state.frozen["rot_heatmap"],
                 state.net))
        if self.cfg.use_gt_heatmap:
            pose = nets[2](self._gt_heatmaps(batch).to(self.dtype)).float()
        else:
            pose = pose_forward(nets, batch["input_rgb"], self.dtype)
        gt = batch["gt_local_pose"]
        return {"metrics": pose_metrics(pose, gt), "pred_pose": pose,
                "gt_pose": gt}

    def prepare_inference(self, state: TrainState,
                          calib_batches: Optional[Iterable[Batch]] = None
                          ) -> TrainState:
        """A state whose `eval_step` runs the int8 inference twins of its
        nets (``int8_heatmap_inference`` / ``int8_lifter_inference``):
        a `serving.Predictor` holding the state's weights, pre-quantized,
        with static activation scales calibrated on ``calib_batches``
        (dicts with ``input_rgb``) by `Predictor.calibrate` when given.
        The state itself is not changed; without an int8 flag it is
        returned as it is."""
        cfg = self.cfg
        if not (cfg.int8_heatmap_inference or cfg.int8_lifter_inference):
            return state
        pred = Predictor(cfg, state.frozen["heatmap"].state_dict(),
                         state.frozen["rot_heatmap"].state_dict(),
                         state.net.state_dict(),
                         bf16=self.dtype == torch.bfloat16, int8=None,
                         device=self.device)
        if calib_batches is not None:
            pred.calibrate(b["input_rgb"] for b in calib_batches)
        return dataclasses.replace(state, inference=pred)


def create_task(cfg: Config, device="cuda", dp=None):
    """Model factory (reference model/models.py:2-18)."""
    if cfg.model == "heatmap_shared":
        return HeatmapTask(cfg, device, dp)
    if cfg.model == "egotap_autoencoder":
        return LifterTask(cfg, device, dp)
    raise ValueError(f"Model [{cfg.model}] not recognized.")
