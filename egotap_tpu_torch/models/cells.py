"""Propagation Unit chain - the lifter's recurrent core.

Counterpart of `egotap_tpu/models/cells.py:PUChain` (reference
``PropagationUnitCell`` / ``PropagationUnit``, model/custom_cells.py:
72-197), any number of layers, in two walks:
  * ``semantics="chain"`` (the default, reference parity): each joint
    receives the state of the previously processed joint, as the
    reference's in-place state aliasing does and released checkpoints
    encode;
  * ``semantics="tree"``: each joint receives its kinematic parent's
    state (``parents``; the root's is zero), the documented intent.

Cell math, gate order [forget, in, cell, out]:
    bh   = x @ Wx2f + b_x2f
    h'   = sigmoid(bh[:, :H]) * h        # input-conditioned forget of h
    b'   = sigmoid(bh[:, H:]) * bridge   # ... and of the bridge feature
    gate = x @ Wx2h + h' @ Wh2h (+ b' @ Wb2h)
    c'   = c * sig(f) + sig(i) * tanh(g)
    h''  = sig(o) * tanh(c')
Layers above 0 have no bridge: their forget gate is computed from the
layer below's h.

Everything that depends only on (x, bridge) is computed up front as
batched matmuls over all joints (cells.py:106-113). The chain with 2
layers, the shipped configuration, runs its recurrence as
`ops.pu_kernel.pu_chain_fused` (kernel C on the card, its plain loop on
the CPU), differentiable on both: gradients reach the Linear parameters
through the transposed views passed to it. Every other configuration
walks the joints in plain PyTorch in the input's dtype, as JAX's
`lax.scan` does (JAX, too, runs its kernel only for the 2-layer chain,
cells.py:145-146). Keys: ``layers.{i}.{x2f,x2h,b2h,h2h}`` like the
reference's ``PropagationUnit``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from egotap_tpu_torch.models.layers import linear
from egotap_tpu_torch.ops.pu_kernel import _cell_update, pu_chain_fused


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
    (B, J, hidden_size), the top layer's h at each joint. ``parents``
    (the skeleton's, root first) is needed for ``semantics="tree"``:
    input row j is joint j + 1 and starts from the state its parent
    joint ``parents[j + 1]`` left (the root's is zero)."""

    def __init__(self, input_size: int, bridge_size: int, hidden_size: int,
                 num_layers: int = 2, semantics: str = "chain",
                 parents: Optional[Sequence[int]] = None):
        super().__init__()
        if semantics not in ("chain", "tree"):
            raise ValueError(f"unknown semantics {semantics!r}")
        if semantics == "tree" and parents is None:
            raise ValueError("tree semantics needs parents")
        if num_layers < 1:
            raise ValueError(f"num_layers={num_layers}")
        self.hidden_size, self.semantics = hidden_size, semantics
        self.parents = (None if parents is None
                        else tuple(int(p) for p in parents)[1:])
        self.layers = nn.ModuleList(
            [PUCell(input_size, bridge_size, hidden_size)]
            + [PUCell(hidden_size, 0, hidden_size)
               for _ in range(num_layers - 1)])

    @property
    def uses_kernel(self) -> bool:
        """True for the configuration kernel C covers: the 2-layer chain."""
        return self.semantics == "chain" and len(self.layers) == 2

    def forward(self, inputs: torch.Tensor, bridges: torch.Tensor
                ) -> torch.Tensor:
        H = self.hidden_size
        c0 = self.layers[0]
        bh = linear(inputs, c0.x2f)                       # (B, J, H + Hb)
        fh = torch.sigmoid(bh[..., :H])
        gates_pre = linear(inputs, c0.x2h)
        if hasattr(c0, "b2h"):
            bridged = torch.sigmoid(bh[..., H:]) * bridges
            gates_pre = gates_pre + linear(bridged, c0.b2h)
        if self.uses_kernel:
            return self._kernel(fh, gates_pre)
        return self._walk(fh, gates_pre)

    def _kernel(self, fh: torch.Tensor, gates_pre: torch.Tensor
                ) -> torch.Tensor:
        dt = fh.dtype
        c0, c1 = self.layers
        # the layer-0 h2h bias joins in f32, as in cells.py:150
        gp = gates_pre.float() + c0.h2h.bias.float()

        def kernel(lin):          # (in, out) view in the compute dtype
            return lin.weight.to(dt).t()

        cell1 = {n: {"kernel": kernel(getattr(c1, n)),
                     "bias": getattr(c1, n).bias}
                 for n in ("x2f", "x2h", "h2h")}
        return pu_chain_fused(fh, gp, kernel(c0.h2h), cell1).to(dt)

    def _walk(self, fh: torch.Tensor, gates_pre: torch.Tensor
              ) -> torch.Tensor:
        """The layer stack joint by joint (cells.py:122-143), from the
        previous joint's state (chain) or the parent's (tree)."""
        b, J, H = fh.shape
        dt = fh.dtype
        parents = range(J) if self.semantics == "chain" else self.parents
        if len(parents) != J:
            raise ValueError(f"{J} joints, {len(parents)} parents")
        # weights cast once for the walk: (h2h of layer 0, then x2f, x2h,
        # h2h of each layer above), each a (weight, bias) pair
        def cast(lin):
            return lin.weight.to(dt), lin.bias.to(dt)
        h2h0 = cast(self.layers[0].h2h)
        upper = [[cast(getattr(cell, n)) for n in ("x2f", "x2h", "h2h")]
                 for cell in self.layers[1:]]
        zero = fh.new_zeros(b, H)
        slots = [[(zero, zero)] * len(self.layers)]   # slot 0: the root
        outs = []
        for j, parent in enumerate(parents):
            (h, c), *above = slots[parent]
            h, c = _cell_update(gates_pre[:, j] + F.linear(fh[:, j] * h,
                                                           *h2h0), c)
            new = [(h, c)]
            for (x2f, x2h, h2h), (hl, cl) in zip(upper, above):
                fhl = torch.sigmoid(F.linear(h, *x2f))
                h, c = _cell_update(F.linear(h, *x2h)
                                    + F.linear(fhl * hl, *h2h), cl)
                new.append((h, c))
            slots.append(new)
            outs.append(h)
        return torch.stack(outs, dim=1)
