"""The stage-2 task: frozen heatmap nets + EgoTAP lifter, trained and
evaluated one step at a time.

Counterpart of `egotap_tpu/train/tasks.py:LifterTask` (reference
model/egotap_autoencoder_model.py) and `create_task`. Only the lifter is
optimized. Parity quirks kept: during training the frozen stage-1 nets
run with train-mode BatchNorm (per-view statistics) and their running
statistics evolve, while their parameters never change and no gradient
reaches them (the reference calls model.train() on everything,
train.py:91); evaluation uses the running statistics.

Compute dtype: bf16 under ``use_amp`` or ``compute_dtype="bfloat16"``.
Parameters stay f32 and every op casts them to its input's dtype, so
the gradients and the optimizer are f32. The stage-1 heatmap
(``HeatmapTask``) is not ported yet.

    task = LifterTask(cfg)                    # device="cuda" by default
    state = task.init_state(seed=0, iters_per_epoch=1000)
    state, losses = task.train_step(state, batch)
    out = task.eval_step(task.prepare_inference(state, calib), batch)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import torch

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import resolve_device, set_f32_numerics
from egotap_tpu_torch.core.skeleton import get_skeleton
from egotap_tpu_torch.eval.metrics import pose_metrics
from egotap_tpu_torch.models.initializers import apply_reference_init
from egotap_tpu_torch.serving import (Predictor, build_nets, init_weights,
                                      pose_forward)
from egotap_tpu_torch.train import losses as L
from egotap_tpu_torch.train.optim import make_optimizer
from egotap_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]
StateDict = Dict[str, torch.Tensor]


def compute_dtype(cfg: Config) -> torch.dtype:
    return (torch.bfloat16 if cfg.use_amp or cfg.compute_dtype == "bfloat16"
            else torch.float32)


class LifterTask:
    """Stage-2 pose estimator: frozen heatmap nets + EgoTAP lifter."""

    def __init__(self, cfg: Config, device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            set_f32_numerics()
        self.cfg = cfg
        self.sk = get_skeleton(cfg.joint_preset)
        self.dtype = compute_dtype(cfg)

    def init_state(self, seed: int, iters_per_epoch: int,
                   heatmap_state: Optional[StateDict] = None,
                   rot_heatmap_state: Optional[StateDict] = None
                   ) -> TrainState:
        """Seeded initial state. The frozen nets load the given
        reference-layout state_dicts, or get seeded random weights
        (`serving.init_weights`); the lifter is drawn as the reference
        draws it: HF randn position embeddings, then kaiming everywhere
        (`apply_reference_init`)."""
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

    def _batch(self, batch) -> Batch:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

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
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Dict[str, Optional[torch.Tensor]]]:
        """The forward and backward of one training step on ``batch``
        (``input_rgb`` (B, V, H, W, 3) or the gt heatmaps, and
        ``gt_local_pose`` (B, J, 3)): the losses and the lifter's
        gradients by parameter name (None for a parameter the forward
        does not use). BatchNorm running statistics (the lifter's and the
        frozen nets') update as in training; parameters do not."""
        batch = self._batch(batch)
        hm_cat = self._forward_heatmaps(state.frozen, batch)
        lifter = state.lifter.train()
        try:
            with torch.enable_grad():
                pose = lifter(hm_cat.to(self.dtype)).float()
                loss_d = self._pose_losses(pose, batch)
                params = dict(lifter.named_parameters())
                grads = torch.autograd.grad(sum(loss_d.values()),
                                            list(params.values()),
                                            allow_unused=True)
        finally:
            lifter.eval()
        return ({k: v.detach() for k, v in loss_d.items()},
                dict(zip(params, grads)))

    def train_step(self, state: TrainState, batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step of the lifter on ``batch`` (see
        `gradients`); updates ``state`` in place and returns it with the
        losses."""
        loss_d, grads = self.gradients(state, batch)
        state.opt.step(dict(state.lifter.named_parameters()), grads)
        state.step += 1
        return state, loss_d

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch) -> Dict[str, object]:
        """Eval-mode forward (the int8 twins of `prepare_inference` when
        the state carries them) and per-sample metrics in mm."""
        batch = self._batch(batch)
        nets = (state.inference.nets if state.inference is not None else
                (state.frozen["heatmap"], state.frozen["rot_heatmap"],
                 state.lifter))
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
                         state.lifter.state_dict(),
                         bf16=self.dtype == torch.bfloat16, int8=None,
                         device=self.device)
        if calib_batches is not None:
            pred.calibrate(b["input_rgb"] for b in calib_batches)
        return dataclasses.replace(state, inference=pred)


def create_task(cfg: Config, device="cuda") -> LifterTask:
    """Model factory (reference model/models.py:2-18)."""
    if cfg.model == "heatmap_shared":
        raise NotImplementedError(
            "the stage-1 HeatmapTask is not ported yet (ROADMAP.md section "
            "1, item 3)")
    if cfg.model == "egotap_autoencoder":
        return LifterTask(cfg, device)
    raise ValueError(f"Model [{cfg.model}] not recognized.")
