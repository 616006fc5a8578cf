"""Batched Procrustes (similarity-transform) alignment for PA-MPJPE.

Counterpart of `egotap_tpu/ops/procrustes.py:similarity_align`
(reference ``batch_compute_similarity_transform_torch``, utils/util.py:
328-379). The 3x3 SVD runs per sample; R = V Z U^T does not depend on
the paired column signs the SVD may pick, and the last diagonal entry of
Z, sign(det(U V^T)), turns a reflection into the nearest rotation. The
covariance K is computed in f32 at full precision (no TF32 on the card).
"""

from __future__ import annotations

import torch


def similarity_align(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Align S1 to S2 with a per-sample scaled rotation + translation.

    S1, S2: (B, J, 3) point sets. Returns S1_hat (B, J, 3)."""
    X1, X2 = S1.transpose(-1, -2), S2.transpose(-1, -2)      # (B, 3, J)
    mu1 = X1.mean(dim=-1, keepdim=True)
    mu2 = X2.mean(dim=-1, keepdim=True)
    X1c, X2c = X1 - mu1, X2 - mu2
    var1 = X1c.square().sum(dim=(-1, -2))
    # elementwise products and sums, never a TF32 matrix product
    K = (X1c[:, :, None, :] * X2c[:, None, :, :]).sum(dim=-1)  # (B, 3, 3)
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).repeat(K.shape[0], 1, 1)
    Z[:, -1, -1] = torch.sign(torch.linalg.det(U @ V.transpose(-1, -2)))
    R = V @ Z @ U.transpose(-1, -2)
    scale = (R * K.transpose(-1, -2)).sum(dim=(-1, -2)) / var1  # tr(R K)
    t = mu2 - scale[:, None, None] * (R @ mu1)
    return (scale[:, None, None] * (R @ X1) + t).transpose(-1, -2)
