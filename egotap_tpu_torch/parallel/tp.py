"""Tensor parallelism for the lifter's Grid-ViT (Megatron-style), for
serving over a group of devices in one process.

Counterpart of `egotap_tpu/parallel/tp.py`. JAX only places the
parameters (`lifter_tp_shardings`) and GSPMD partitions the program;
here each `ViTBlock` of a lifter copy becomes a `TensorParallelBlock`
that runs its shards on their devices itself. The rules, by the JAX
module names:
  * query, key, value, mlp_in: column-parallel, the (out, in) weight
    split on the output dim, with its bias and per-output-channel int8
    weight scale;
  * attn_out, mlp_out: row-parallel, the weight split on the input dim;
    each device's partial product is summed onto the group's first
    device and the bias added once after the sum;
  * everything else is replicated on the group's first device (patch
    projection, LayerNorms, the PU chain, the FC stacks, BatchNorm and
    activation scales).
A dim that ``num_model`` does not divide stays replicated, module by
module (`split_dim`); a pair that cannot split with its partner (the
attention when ``num_model`` does not divide the heads, the MLP when it
does not divide its width) runs replicated.

Each shard's attention is kernel B over ``heads / num_model`` heads: the
column-split q/k/v are whole heads, because the packed layout
``(B, S, H*Dh)`` puts head h in columns ``[h*Dh, (h+1)*Dh)``.

int8: the weights are quantized before they are split (as JAX shards
the quantized ``kernel_q``), so a row-parallel module's per-output
scale spans the whole contraction; its int32 partial products are
summed exactly and dequantized once, which is the unsplit product. A
dynamic per-tensor activation scale is the max over the model group (as
GSPMD reduces JAX's global max); a static one is used as it is. On the
card the split products run on kernel F as the unsplit ones do
(`ops/int8_pack.py`): an input quantized once is one pack, a column part
one product and one epilogue on its device, a row-parallel module one
pack and one product on each device and one epilogue on the first.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from egotap_tpu_torch.models.layers import layer_norm
from egotap_tpu_torch.models.vit import GridViT, ViTBlock, gelu
from egotap_tpu_torch.ops.attention import multihead_attention_packed
from egotap_tpu_torch.ops import int8_pack
from egotap_tpu_torch.ops.quant import (QDense, f32_scalar, quantize_input,
                                        quantized_dense, QMAX)

# a ViTBlock's module names (the JAX names beside them)
COLUMN = {"attention.attention.query": "query",
          "attention.attention.key": "key",
          "attention.attention.value": "value",
          "intermediate.dense": "mlp_in"}
ROW = {"attention.output.dense": "attn_out", "output.dense": "mlp_out"}
# the modules that split together: the attention (whole heads) and the MLP
PAIRS = {"attention": ("attention.attention.query", "attention.attention.key",
                       "attention.attention.value",
                       "attention.output.dense"),
         "mlp": ("intermediate.dense", "output.dense")}


def split_dim(module: str, leaf: str, shape, num_model: int
              ) -> Optional[int]:
    """The dim of the tensor ``leaf`` ("weight" or "bias") of a ViTBlock
    module (its name inside the block) that is split over ``num_model``
    devices, or None for replicated (JAX `_spec` in the torch layout: a
    JAX kernel is (in, out), a torch weight (out, in))."""
    if module in COLUMN and leaf in ("weight", "bias") \
            and shape[0] % num_model == 0:
        return 0
    if module in ROW and leaf == "weight" and len(shape) == 2 \
            and shape[1] % num_model == 0:
        return 1
    return None


class _Part:
    """One device's shard of a linear module: its float weight and bias,
    or its int8 weight and per-output scale (and, off the CPU, kernel F's
    rows of the int8 weight)."""

    def __init__(self, mod: nn.Linear, dim: int, index: int, count: int,
                 device: torch.device):
        def cut(t):
            if t is None:
                return None
            # a copy on every device, the home one too: a view would keep
            # the full weight alive there
            return t.chunk(count, dim)[index].to(
                device, copy=True, memory_format=torch.contiguous_format)

        self.device = device
        self.w_q = self.w_scale = self.w_rows = None
        if isinstance(mod, QDense):
            if mod.w_q is None:
                mod.prequantize()
            self.w_q = cut(mod.w_q)
            if device.type != "cpu":
                self.w_rows = int8_pack.weight_rows(self.w_q)
            if dim == 0:
                self.w_scale = cut(mod.w_scale)
            self.weight = None
        else:
            self.weight = cut(mod.weight)
        self.bias = cut(mod.bias) if dim == 0 else None


class TensorParallelBlock(nn.Module):
    """A `ViTBlock` whose projections are split over ``devices`` (the
    block itself, its input and its output on ``devices[0]``)."""

    def __init__(self, block: ViTBlock, devices: Sequence[torch.device]):
        super().__init__()
        self.block = block
        self.devices = list(devices)
        n = len(self.devices)
        mods = dict(block.named_modules())
        dims = {name: split_dim(name, "weight", tuple(mods[name].weight.shape),
                                n) for names in PAIRS.values()
                for name in names}
        split = {pair: all(dims[name] is not None for name in names)
                 for pair, names in PAIRS.items()}
        self.split_attention = split["attention"] and block.num_heads % n == 0
        self.split_mlp = split["mlp"]
        self.parts = {}
        for pair, on in (("attention", self.split_attention),
                         ("mlp", self.split_mlp)):
            for name in PAIRS[pair] if on else ():
                self.parts[name] = [_Part(mods[name], dims[name], i, n, dev)
                                    for i, dev in enumerate(self.devices)]
        # the row-parallel modules' full scale and bias stay on devices[0]
        self.row = {name: mods[name] for name in ROW if name in self.parts}
        with torch.no_grad():       # the split weights live in the parts
            for name in self.parts:
                mod = mods[name]
                mod.weight = nn.Parameter(mod.weight.new_empty(0),
                                          requires_grad=False)
                if isinstance(mod, QDense):
                    mod.w_q = mod.w_rows = mod.w_q.new_empty(0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.block
        y = layer_norm(x, b.layernorm_before)
        x = x + (self._attend(y) if self.split_attention else b.attend(y))
        y = layer_norm(x, b.layernorm_after)
        return x + (self._mlp(y) if self.split_mlp else b.mlp(y))

    def _inputs(self, y: torch.Tensor, quantizer) -> list:
        """``y`` (or its int8 codes and scale, quantized once) on every
        device of the group."""
        if quantizer is None:
            return [y.to(d) for d in self.devices]
        xq, a = quantizer(y)
        return [(xq.to(d), a.to(d)) for d in self.devices]

    def _column(self, name: str, m: int, inp, y: torch.Tensor
                ) -> torch.Tensor:
        part = self.parts[name][m]
        if part.w_q is None:
            bias = None if part.bias is None else part.bias.to(inp.dtype)
            return F.linear(inp, part.weight.to(inp.dtype), bias)
        return quantized_dense(y, part.w_q, part.w_scale, part.bias,
                               pre_q=inp, w_rows=part.w_rows)

    def _row(self, name: str, xs: List[torch.Tensor]) -> torch.Tensor:
        """The row-parallel module ``name`` on the column shards ``xs``,
        summed onto devices[0]."""
        mod, parts, home = self.row[name], self.parts[name], self.devices[0]
        dtype = xs[0].dtype
        if parts[0].w_q is None:
            total = sum(F.linear(x, p.weight.to(dtype)).to(home).float()
                        for x, p in zip(xs, parts))
            if mod.bias is not None:
                total = total + mod.bias.float()
            return total.to(dtype)
        a = mod.a_scale
        if a is None:                     # dynamic: the group's max
            amax = torch.stack([x.float().abs().amax().to(home)
                                for x in xs]).amax()
            a = torch.clamp_min(amax, 1e-12) / f32_scalar(amax, QMAX)
        return int8_pack.dense_sum(xs, a, [p.w_q for p in parts],
                                   [p.w_rows for p in parts], mod.w_scale,
                                   mod.bias)

    def _attend(self, y: torch.Tensor) -> torch.Tensor:
        b = self.block
        heads = b.num_heads // len(self.devices)
        inputs = self._inputs(y, b.qkv_in)
        ctx = []
        for m, inp in enumerate(inputs):
            q, k, v = (self._column(f"attention.attention.{n}", m, inp, y)
                       for n in ("query", "key", "value"))
            ctx.append(multihead_attention_packed(q, k, v, heads))
        return self._row("attention.output.dense", ctx)

    def _mlp(self, y: torch.Tensor) -> torch.Tensor:
        mlp_in = self.block.intermediate.dense
        quantizer = None
        if isinstance(mlp_in, QDense):
            def quantizer(t):
                return quantize_input(t, mlp_in.a_scale)
        inputs = self._inputs(y, quantizer)
        hs = [gelu(self._column("intermediate.dense", m, inp, y))
              for m, inp in enumerate(inputs)]
        return self._row("output.dense", hs)


def shard_lifter(lifter: nn.Module, devices: Sequence[torch.device]
                 ) -> nn.Module:
    """A copy of ``lifter`` on ``devices[0]`` whose Grid-ViT blocks are
    `TensorParallelBlock` over ``devices`` (the lifter itself unchanged;
    one device: a plain copy)."""
    out = copy.deepcopy(lifter).to(devices[0])
    if len(devices) > 1:
        for vit in [m for m in out.modules() if isinstance(m, GridViT)]:
            layers = vit.encoder.layer
            for i in range(len(layers)):
                layers[i] = TensorParallelBlock(layers[i], devices)
    return out
