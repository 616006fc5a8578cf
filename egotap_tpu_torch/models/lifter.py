"""EgoTAP lifter: heatmaps -> 3D pose (Grid-ViT + PU chain + MLP heads).

Counterpart of `egotap_tpu/models/lifter.py:EgoTAPLifter`, PU path
(reference ``EgoTAPAutoEncoder``, model/net_architecture.py:579-758,
shipped configuration ``--patched_heatmap_ae --skel_layer PU``).

Dataflow for the stereo UnrealEgo config (V = 2 views, J = 15 joints,
Ld = 2 sin-limb channels):
  input  (B, 64, 64, V*J + V*J*Ld) heatmap stack
  pos    -> GridViTEncoder over V*J tiles     -> (B, V*J*hid)
  rot    -> LimbFCEncoder over V*J limb rows  -> (B, V*J*hid)
  regroup to per-joint (view-concat) embeddings (B, J, V*hid)
  PU chain over joints                         -> (B, J, 2*V*hid)
  per-joint head Linear(concat(pos_j, skel_j)) -> 3
  global head Linear(flat skel) -> 3*(num_joints - J) (+3 offset added to
  every per-joint output for UnrealEgo)

Predicted row i is trained against preset-order ground-truth row i (off by
one joint); the network learns the permutation — kept as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from egotap_tpu_torch.models.cells import PUChain
from egotap_tpu_torch.models.encoders import GridViTEncoder, LimbFCEncoder
from egotap_tpu_torch.models.layers import MLPDecoder
from egotap_tpu_torch.models.vit import PATCH


class EgoTAPLifter(nn.Module):
    """Heatmap stack (B, H, W, C) NHWC -> (B, num_joints, 3) pose."""

    def __init__(self, num_heatmap: int, num_joints: int,
                 num_rot_heatmap: Optional[int] = None, views: int = 2,
                 limb_dim: int = 2, hidden_size: int = 128,
                 skel_layer: str = "PU", num_pu_layers: int = 2,
                 vit_layers: int = 3, use_global_offset: bool = True,
                 pu_semantics: str = "chain", heatmap_size: int = 64):
        super().__init__()
        if skel_layer != "PU":
            raise NotImplementedError(
                f"skel_layer {skel_layer!r} is not ported (PU only)")
        J, V, Ld = num_heatmap, views, limb_dim
        Jr = num_rot_heatmap if num_rot_heatmap is not None else J
        self.J, self.Jr, self.V, self.Ld = J, Jr, V, Ld
        self.hid = hidden_size
        self.num_joints = num_joints
        self.use_global_offset = use_global_offset
        bh = hidden_size * V
        self.pos_heatmap_encoder = GridViTEncoder(
            num_tiles=J * V, hidden_size=hidden_size, vit_layers=vit_layers,
            heatmap_size=heatmap_size)
        self.rot_heatmap_encoder = LimbFCEncoder(
            Ld * heatmap_size * heatmap_size, hidden_size)
        self.skel_sequential_layer = nn.ModuleDict({"lstm_custom": PUChain(
            bh, bh, 2 * bh, num_pu_layers, pu_semantics)})
        feature_size = 2 * bh
        self.pose_mlp = MLPDecoder(bh + feature_size, 3)
        global_dim = 3 * (num_joints - J) + (3 if use_global_offset else 0)
        self.global_mlp = (MLPDecoder(J * feature_size, global_dim)
                           if global_dim > 0 else None)

    def forward(self, heatmaps: torch.Tensor) -> torch.Tensor:
        B, res = heatmaps.shape[0], heatmaps.shape[1]
        J, Jr, V, Ld, hid = self.J, self.Jr, self.V, self.Ld, self.hid
        bh = hid * V

        # --- pos / rot split straight from NHWC, one transpose each
        P = res // PATCH
        pos = heatmaps[..., : J * V].reshape(B, P, PATCH, P, PATCH, J * V)
        pos = pos.permute(0, 5, 1, 3, 2, 4).reshape(B, J * V, P * P,
                                                    PATCH * PATCH)
        rot = heatmaps[..., J * V:].reshape(B, res * res, V, Ld, Jr)
        rot = rot.permute(0, 2, 4, 3, 1).reshape(B, V * Jr, Ld * res * res)

        pos_embed = self.pos_heatmap_encoder(pos)          # (B, V*J*hid)
        rot_embed = self.rot_heatmap_encoder(rot)          # (B, V*Jr*hid)

        # --- regroup view-major -> per-joint [view0, view1] blocks
        pos_pj = pos_embed.reshape(B, V, J, hid).transpose(1, 2)
        pos_pj = pos_pj.reshape(B, J, bh)
        rot_pj = rot_embed.reshape(B, V, Jr, hid).transpose(1, 2)
        rot_pj = rot_pj.reshape(B, Jr, bh)
        if Jr < J:      # tail-align limb bridges to the walked joints
            rot_pj = torch.cat([rot_pj.new_zeros(B, J - Jr, bh), rot_pj], 1)
        elif Jr > J:
            rot_pj = rot_pj[:, Jr - J:]

        skel = self.skel_sequential_layer["lstm_custom"](pos_pj, rot_pj)

        # --- per-joint head
        per_joint = torch.cat([pos_pj, skel], dim=-1).reshape(B * J, -1)
        pose = self.pose_mlp(per_joint).reshape(B, J * 3)

        # --- global head (remaining joints + optional offset)
        if self.global_mlp is not None:
            others = self.global_mlp(skel.reshape(B, -1))
            if self.use_global_offset:
                pose = (pose.reshape(B, J, 3) + others[:, None, :3]
                        ).reshape(B, J * 3)
                others = others[:, 3:]
            pose = torch.cat([pose, others], dim=1)
        return pose.reshape(B, self.num_joints, 3)
