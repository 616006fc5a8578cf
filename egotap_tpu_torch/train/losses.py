"""Stage-2 pose losses, reference-parity semantics.

Counterpart of `egotap_tpu/train/losses.py` (the pose losses; the
stage-1 heatmap losses belong to the stage-1 slice):
  * `mpjpe`: mean per-joint L2 (reference utils/loss.py:79-85);
  * `per_sample_mpjpe`: the same per sample;
  * `cos_sim`: summed bone-direction cosine similarity, trained with a
    negative lambda (reference utils/loss.py:44-77).
"""

from __future__ import annotations

from typing import Sequence

import torch

COS_EPS = 1e-8  # torch.nn.CosineSimilarity default


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Mean L2 over joints and batch. pred/gt (..., J, 3) in cm."""
    return torch.linalg.vector_norm(gt - pred, dim=-1).mean()


def per_sample_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, J, 3) -> (B,) per-sample mean joint error."""
    return torch.linalg.vector_norm(gt - pred, dim=-1).mean(dim=-1)


def _bone_vectors(pose: torch.Tensor, parents: Sequence[int]) -> torch.Tensor:
    idx = torch.as_tensor(parents, device=pose.device)
    return (pose - pose[..., idx, :])[..., 1:, :]


def cos_sim(pred: torch.Tensor, gt: torch.Tensor, parents: Sequence[int],
            estimate_head: bool = True) -> torch.Tensor:
    """Summed cosine similarity of bone vectors (mean over batch).

    When the root is not estimated (EgoCap), a zero root row is prepended
    to both poses and the first bone is dropped from the sum."""
    if not estimate_head:
        zeros = pred.new_zeros(pred.shape[:-2] + (1, 3))
        pred = torch.cat([zeros, pred], dim=-2)
        gt = torch.cat([torch.zeros_like(zeros, dtype=gt.dtype), gt], dim=-2)
    bp = _bone_vectors(pred, parents)
    bg = _bone_vectors(gt, parents)
    # torch.nn.CosineSimilarity: x.y / (max(|x|,eps) * max(|y|,eps))
    np_ = torch.linalg.vector_norm(bp, dim=-1).clamp_min(COS_EPS)
    ng_ = torch.linalg.vector_norm(bg, dim=-1).clamp_min(COS_EPS)
    cos = (bp * bg).sum(dim=-1) / (np_ * ng_)
    if not estimate_head:
        cos = cos[..., 1:]
    return cos.sum(dim=-1).mean()
