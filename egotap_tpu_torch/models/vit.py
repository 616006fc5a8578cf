"""Grid-ViT heatmap patch encoder.

Counterpart of `egotap_tpu/models/vit.py` (reference
``PatchedHeatmapFeatureExtractorViT``, model/net_architecture.py:320-415,
over the vendored HF ViT with mask tokens and no CLS token).

The reference tiles N heatmaps into one (T*64)^2 image with zero dummy
tiles whose patches are replaced by the mask token. As in the JAX
package the image is never built: attention is permutation-equivariant,
so each heatmap is patchified directly, dummy tiles contribute pure
mask-token embeddings, and the learned position embeddings (stored in
image row-major order) are gathered through `tile_permutation`.

Submodules follow the HF key layout (``embeddings.*``,
``encoder.layer.{i}.attention.attention.query`` ...). LayerNorm eps is
1e-12; GELU is the exact erf form at f32 and the tanh form under bf16
(`egotap_tpu/models/vit.py:98-102`). Attention runs kernel B on the card.
With ``quant`` the block's projections are `QDense` (int8 inference,
`egotap_tpu/models/vit.py:55-103`): one `QuantStub` ``qkv_in`` quantizes
the LayerNorm output once for q, k and v; ``patch_proj`` stays float.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from egotap_tpu_torch.models.layers import layer_norm, linear
from egotap_tpu_torch.ops.attention import multihead_attention_packed
from egotap_tpu_torch.ops.quant import QDense, QuantStub

LN_EPS = 1e-12  # HF ViT layer_norm_eps
PATCH = 16


@functools.lru_cache(maxsize=None)
def tile_permutation(num_tiles_side: int, patches_per_side: int) -> np.ndarray:
    """perm[tile-major token index] = image-row-major position index."""
    T, P = num_tiles_side, patches_per_side
    t, j = np.divmod(np.arange(T * T * P * P), P * P)
    row, col = np.divmod(t, T)
    pr, pc = np.divmod(j, P)
    return ((row * P + pr) * (T * P) + (col * P + pc)).astype(np.int64)


class _Linear(nn.Linear):
    """nn.Linear applied in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self)


class _SelfAttention(nn.Module):
    def __init__(self, d: int, lin):
        super().__init__()
        self.query, self.key, self.value = lin(d, d), lin(d, d), lin(d, d)


class _AttentionOutput(nn.Module):
    def __init__(self, d: int, lin):
        super().__init__()
        self.dense = lin(d, d)


class _Attention(nn.Module):
    def __init__(self, d: int, lin):
        super().__init__()
        self.attention = _SelfAttention(d, lin)
        self.output = _AttentionOutput(d, lin)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, lin):
        super().__init__()
        self.dense = lin(d_in, d_out)


class ViTBlock(nn.Module):
    """Pre-LN transformer block (HF ViTLayer, modeling_vit.py:347-386)."""

    def __init__(self, hidden_size: int, num_heads: int, mlp_dim: int,
                 quant: bool = False):
        super().__init__()
        lin = QDense if quant else _Linear
        self.num_heads = num_heads
        self.attention = _Attention(hidden_size, lin)
        self.intermediate = _Dense(hidden_size, mlp_dim, lin)
        self.output = _Dense(mlp_dim, hidden_size, lin)
        self.layernorm_before = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.layernorm_after = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.qkv_in = QuantStub() if quant else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attend(layer_norm(x, self.layernorm_before))
        return x + self.mlp(layer_norm(x, self.layernorm_after))

    def attend(self, y: torch.Tensor) -> torch.Tensor:
        """The attention half on the normalised input ``y``."""
        sa = self.attention.attention
        if self.qkv_in is not None:     # y quantized once for q, k and v
            pre_q = self.qkv_in(y)
            q, k, v = (lin(y, pre_q=pre_q)
                       for lin in (sa.query, sa.key, sa.value))
        else:
            q, k, v = sa.query(y), sa.key(y), sa.value(y)
        # q/k/v stay in projection layout (B, S, H*Dh): the kernel slices
        # heads itself, so no (B, H, S, Dh) transposes on either side
        ctx = multihead_attention_packed(q, k, v, self.num_heads)
        return self.attention.output.dense(ctx)

    def mlp(self, y: torch.Tensor) -> torch.Tensor:
        """The MLP half on the normalised input ``y``."""
        return self.output.dense(gelu(self.intermediate.dense(y)))


def gelu(y: torch.Tensor) -> torch.Tensor:
    """The exact erf GELU at f32, the tanh form under bf16."""
    return F.gelu(y, approximate="none" if y.dtype == torch.float32
                  else "tanh")


class _PatchEmbeddings(nn.Module):
    def __init__(self, channels: int, hidden: int):
        super().__init__()
        # the reference's stride-16 patch conv; applied as a dense over the
        # flattened (c, ph, pw) patch pixels
        self.projection = nn.Conv2d(channels, hidden, PATCH, PATCH)


class _Embeddings(nn.Module):
    def __init__(self, channels: int, hidden: int, total_tokens: int):
        super().__init__()
        self.mask_token = nn.Parameter(torch.zeros(1, 1, hidden))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden))  # unused
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, total_tokens, hidden))
        self.patch_embeddings = _PatchEmbeddings(channels, hidden)


class _Encoder(nn.Module):
    def __init__(self, hidden: int, num_layers: int, num_heads: int,
                 quant: bool):
        super().__init__()
        self.layer = nn.ModuleList(
            ViTBlock(hidden, num_heads, 4 * hidden, quant)
            for _ in range(num_layers))


class _Pooler(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.dense = nn.Linear(hidden, hidden)   # in the checkpoints, unused


class GridViT(nn.Module):
    """Pre-patchified heatmaps (B, N, P*P, C*16*16) -> (B, N, P*P*D)
    per-tile embeddings (the reference's regrouped
    ``per_heatmap_embeddings``)."""

    def __init__(self, num_tiles: int, channels: int = 1,
                 hidden_size: int = 1024, num_layers: int = 3,
                 num_heads: int = 8, heatmap_size: int = 64,
                 quant: bool = False):
        super().__init__()
        self.num_tiles = num_tiles
        self.patches_per_side = heatmap_size // PATCH
        self.tiles_per_side = int(np.sqrt(num_tiles - 1)) + 1
        total = self.tiles_per_side ** 2 * self.patches_per_side ** 2
        self.embeddings = _Embeddings(channels, hidden_size, total)
        self.encoder = _Encoder(hidden_size, num_layers, num_heads, quant)
        self.layernorm = nn.LayerNorm(hidden_size, eps=LN_EPS)
        self.pooler = _Pooler(hidden_size)
        self.register_buffer("perm", torch.from_numpy(tile_permutation(
            self.tiles_per_side, self.patches_per_side)), persistent=False)

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        b, n, tpt, _ = patches.shape
        if n != self.num_tiles or tpt != self.patches_per_side ** 2:
            raise ValueError(f"patches {tuple(patches.shape)} do not match "
                             f"{self.num_tiles} tiles of {tpt} patches")
        emb = self.embeddings
        dt = patches.dtype
        proj = emb.patch_embeddings.projection
        w = proj.weight.reshape(proj.weight.shape[0], -1).to(dt)
        real = F.linear(patches, w, proj.bias.to(dt))
        d = real.shape[-1]
        real = real.reshape(b, n * tpt, d)
        n_dummy = self.tiles_per_side ** 2 * tpt - n * tpt
        dummy = emb.mask_token.to(dt).expand(b, n_dummy, d)
        tokens = torch.cat([real, dummy], dim=1)
        tokens = tokens + emb.position_embeddings[0, self.perm].to(dt)
        for block in self.encoder.layer:
            tokens = block(tokens)
        tokens = layer_norm(tokens, self.layernorm)
        # regroup: the first N tiles' tokens, flattened per tile
        return tokens[:, : n * tpt].reshape(b, n, tpt * d)
