"""Propagation Unit chain — the lifter's recurrent core.

Counterpart of `egotap_tpu/models/cells.py:PUChain` (reference
``PropagationUnitCell`` / ``PropagationUnit``, model/custom_cells.py:
72-197), chain semantics and 2 layers: each joint receives the state of
the previously processed joint, as the reference's in-place state
aliasing does and released checkpoints encode.

Cell math, gate order [forget, in, cell, out]:
    bh   = x @ Wx2f + b_x2f
    h'   = sigmoid(bh[:, :H]) * h        # input-conditioned forget of h
    b'   = sigmoid(bh[:, H:]) * bridge   # ... and of the bridge feature
    gate = x @ Wx2h + h' @ Wh2h (+ b' @ Wb2h)
    c'   = c * sig(f) + sig(i) * tanh(g)
    h''  = sig(o) * tanh(c')

Everything that depends only on (x, bridge) is computed up front as
batched matmuls over all joints (cells.py:106-113); the recurrence is
`ops.pu_kernel.pu_chain_fused` (kernel C on the card, its plain loop on
the CPU). Keys: ``layers.{i}.{x2f,x2h,b2h,h2h}`` like the reference's
``PropagationUnit``.
"""

from __future__ import annotations

import torch
from torch import nn

from egotap_tpu_torch.models.layers import linear
from egotap_tpu_torch.ops.pu_kernel import pu_chain_fused


class PUCell(nn.Module):
    def __init__(self, input_size: int, bridge_size: int, hidden_size: int):
        super().__init__()
        H = hidden_size
        self.x2f = nn.Linear(input_size, H + bridge_size)
        self.x2h = nn.Linear(input_size, 4 * H)
        if bridge_size:
            self.b2h = nn.Linear(bridge_size, 4 * H)
        self.h2h = nn.Linear(H, 4 * H)


class PUChain(nn.Module):
    """inputs (B, J, input_size), bridges (B, J, bridge_size) ->
    (B, J, hidden_size), the top layer's h at each joint."""

    def __init__(self, input_size: int, bridge_size: int, hidden_size: int,
                 num_layers: int = 2, semantics: str = "chain"):
        super().__init__()
        if semantics != "chain" or num_layers != 2:
            raise NotImplementedError(
                f"PU chain: semantics={semantics!r}, num_layers={num_layers} "
                "are not ported (the kernel covers chain semantics, 2 layers)")
        self.hidden_size = hidden_size
        self.layers = nn.ModuleList([
            PUCell(input_size, bridge_size, hidden_size),
            PUCell(hidden_size, 0, hidden_size)])

    def forward(self, inputs: torch.Tensor, bridges: torch.Tensor
                ) -> torch.Tensor:
        H = self.hidden_size
        dt = inputs.dtype
        c0, c1 = self.layers
        bh = linear(inputs, c0.x2f)                       # (B, J, H + Hb)
        fh = torch.sigmoid(bh[..., :H])
        gates_pre = linear(inputs, c0.x2h)
        if hasattr(c0, "b2h"):
            bridged = torch.sigmoid(bh[..., H:]) * bridges
            gates_pre = gates_pre + linear(bridged, c0.b2h)
        # the layer-0 h2h bias joins in f32, as in cells.py:150
        gp = gates_pre.float() + c0.h2h.bias.float()

        def kernel(lin):          # (in, out) view in the compute dtype
            return lin.weight.to(dt).t()

        cell1 = {n: {"kernel": kernel(getattr(c1, n)),
                     "bias": getattr(c1, n).bias}
                 for n in ("x2f", "x2h", "h2h")}
        return pu_chain_fused(fh, gp, kernel(c0.h2h), cell1).to(dt)
