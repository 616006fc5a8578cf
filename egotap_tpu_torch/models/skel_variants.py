"""The lifter's non-PU skeleton layers.

Counterpart of `egotap_tpu/models/skel_variants.py` (reference SkelNet,
model/net_architecture.py:466-576). Modes:
  * "LSTM"      - a stacked LSTM over concat(input, bridge), walked over
    the kinematic tree: each joint starts from its parent's (h, c). The
    reference's nn.LSTM returns fresh state tensors, so unlike the PU
    chain this mode really is a tree walk.
  * "LSTMSplit" - two passes of the stack per joint (bridge, then input).
  * "LSTMNoRel" - the stack over the input embedding only.
  * "None"      - concat(input, bridge) passed through.
  * "NoneNoRel" - the input embedding passed through.

The LSTM follows torch's gate order (i, f, g, o) and its parameter
layout and names (``weight_ih_l{i}`` / ``weight_hh_l{i}`` (4H, in),
``bias_ih_l{i}`` / ``bias_hh_l{i}``), so an ``nn.LSTM`` state_dict (the
reference SkelNet's ``lstm``) loads into `LSTMTreeWalk` as it is. The
parameters are raw ``nn.Parameter``s, not ``nn.Linear``s: the reference's
re-initialization (`initializers.apply_reference_init`) re-draws every
Linear and leaves an LSTM with its U(+-1/sqrt(H)) draw
(`reset_parameters`).

No TPU kernel covers these layers (JAX runs a `lax.scan`): the walk is a
loop over the joints in plain PyTorch, with autograd for the backward.
The state and every product run in the input's dtype, as JAX's do.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

State = List[Tuple[torch.Tensor, torch.Tensor]]     # (h, c) per layer


def skel_output_size(skel_layer: str, body_hidden: int) -> int:
    """Width of the skeleton layer's output per joint
    (net_architecture.py:476-483)."""
    if skel_layer in ("PU", "LSTM", "None"):
        return 2 * body_hidden
    if skel_layer in ("LSTMSplit", "LSTMNoRel", "NoneNoRel"):
        return body_hidden
    raise ValueError(f"unknown skel_layer {skel_layer!r}")


class LSTMTreeWalk(nn.Module):
    """inputs (B, J, input_size) -> (B, J, hidden_size), the top layer's
    h at each joint. Input row j is skeleton joint j + 1 (the root,
    joint 0, has no heatmap); it starts from the per-layer (h, c) that
    its parent joint ``parents[j + 1]`` left, and the root's is zero."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 2,
                 parents: Optional[Sequence[int]] = None):
        super().__init__()
        if parents is None:
            raise ValueError("LSTMTreeWalk needs the skeleton's parents")
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.parents = tuple(int(p) for p in parents)[1:]
        H = hidden_size
        for i in range(num_layers):
            in_sz = input_size if i == 0 else H
            for name, shape in ((f"weight_ih_l{i}", (4 * H, in_sz)),
                                (f"weight_hh_l{i}", (4 * H, H)),
                                (f"bias_ih_l{i}", (4 * H,)),
                                (f"bias_hh_l{i}", (4 * H,))):
                setattr(self, name, nn.Parameter(torch.empty(shape)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Every weight and bias from U(-1/sqrt(H), 1/sqrt(H)), as torch's
        nn.LSTM draws them, from ``generator`` (torch's default one when
        None), drawn on the CPU and copied to the parameters' device."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                  generator=generator))

    def _layers(self, dtype: torch.dtype):
        """Per layer (w_ih, b_ih, w_hh, b_hh) in ``dtype``,
        cast once for the whole walk."""
        return [tuple(getattr(self, f"{n}_l{i}").to(dtype) for n in
                      ("weight_ih", "bias_ih", "weight_hh", "bias_hh"))
                for i in range(self.num_layers)]

    def _stack(self, layers, states: State, gx0: torch.Tensor) -> State:
        """One joint through the stack from ``states``; ``gx0`` is layer
        0's input product x @ w_ih^T + b_ih, computed for all joints at
        once. Returns the new (h, c) per layer."""
        new, x = [], None
        for li, (w_ih, b_ih, w_hh, b_hh) in enumerate(layers):
            h, c = states[li]
            gx = gx0 if li == 0 else torch.addmm(b_ih, x, w_ih.t())
            gates = gx + torch.addmm(b_hh, h, w_hh.t())
            i, f, g, o = gates.chunk(4, dim=-1)         # torch order
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            new.append((h, c))
            x = h
        return new

    def forward(self, inputs: torch.Tensor,
                extra_inputs: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``extra_inputs`` (B, J, input_size), LSTMSplit's bridge: at
        each joint it runs through the stack first, and the main input
        runs from the state it leaves."""
        b, J, _ = inputs.shape
        if len(self.parents) != J:
            raise ValueError(f"{J} joints, {len(self.parents)} parents")
        layers = self._layers(inputs.dtype)
        w_ih, b_ih = layers[0][:2]
        gx = F.linear(inputs, w_ih, b_ih)
        gx_pre = (None if extra_inputs is None else
                  F.linear(extra_inputs, w_ih, b_ih))
        zero = inputs.new_zeros(b, self.hidden_size)
        slots: List[State] = [[(zero, zero)] * self.num_layers]
        outs = []
        for j, parent in enumerate(self.parents):
            states = slots[parent]
            if gx_pre is not None:
                states = self._stack(layers, states, gx_pre[:, j])
            states = self._stack(layers, states, gx[:, j])
            slots.append(states)
            outs.append(states[-1][0])
        return torch.stack(outs, dim=1)
