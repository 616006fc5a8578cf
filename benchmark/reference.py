"""The benchmark's plain reference: EgoTAP in float32 PyTorch.

The forward of both stages and the stage-2 training step (losses and
AdamW), written from the published model (EgoTAP, github.com/tho-kn/EgoTAP,
``model/net_architecture.py``) with plain ``torch`` operations: no kernel,
no cache, no batching tricks, and nothing of the program under test. The
modules carry the reference checkpoints' ``state_dict`` layout (the
ResNet trunk under ``backbone.backbone.backbone.*`` with its stage aliases
``backbone.backbone.layer{0..4}.*``, the decoder under
``after_backbone.*``, the lifter's HF-ViT keys), so one drawn state_dict
loads into both sides.

It keeps the released model's quirks, which the program keeps too: the
Propagation-Unit chain is a flat chain (each joint takes the previous
joint's state), its gates are ordered f, i, g, o, the pose rows are off by
one joint, and train-mode BatchNorm of the stereo encoder takes per-view
statistics (row ``b * V + v`` of the folded batch belongs to view ``v``).

Precision: float32 throughout, TF32 off (`f32_numerics`). ``Arith(fp8=
True)`` rounds every operand of a matrix product or convolution to
float8 e4m3 with a per-tensor scale (straight-through in the backward):
the lower-precision control of the training cell.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
LN_EPS = 1e-12            # HF ViT layer_norm_eps
PATCH = 16
LEAKY = 0.2
COS_EPS = 1e-8            # torch.nn.CosineSimilarity
B1, B2 = 0.9, 0.999
FP8_MAX = 448.0           # largest float8 e4m3 value
RESNETS = {"resnet18": ("basic", (2, 2, 2, 2)),
           "resnet34": ("basic", (3, 4, 6, 3)),
           "resnet50": ("bottleneck", (3, 4, 6, 3)),
           "resnet101": ("bottleneck", (3, 4, 23, 3))}


def f32_numerics() -> None:
    """Full float32 products on the card (TF32 off for cuBLAS and cuDNN)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Arith:
    """The products of the reference: float32, or with ``fp8`` every
    operand rounded to float8 e4m3 at a per-tensor scale first."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        rounded = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (rounded - x).detach()

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self.q(x), self.q(w), b, stride, padding)

    def matmul(self, a, b):
        return self.q(a) @ self.q(b)


F32 = Arith()


# ---------------------------------------------------------------- layers
def batch_norm(x: torch.Tensor, bn: nn.Module, train: bool,
               views: int = 1) -> torch.Tensor:
    """BatchNorm over dim 1 of (N, C, ...). Train mode: the batch's
    statistics (biased variance), per view when ``views`` > 1 (row i is
    view i % views); eval mode: the running statistics."""
    c = x.shape[1]
    shape = (1, c) + (1,) * (x.dim() - 2)
    if not train:
        inv = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        return (x - bn.running_mean.view(shape)) * inv.view(shape) \
            + bn.bias.view(shape)
    xg = x.reshape((-1, views) + tuple(x.shape[1:]))
    axes = (0,) + tuple(range(3, xg.dim()))
    mean = xg.mean(dim=axes, keepdim=True)
    var = (xg - mean).square().mean(dim=axes, keepdim=True)
    y = (xg - mean) * torch.rsqrt(var + BN_EPS)
    return y.reshape(x.shape) * bn.weight.view(shape) + bn.bias.view(shape)


def leaky(x):
    return torch.where(x >= 0, x, LEAKY * x)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, width, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv2 = nn.Conv2d(width, width, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, width, 1, stride, bias=False),
                nn.BatchNorm2d(width, eps=BN_EPS))

    def run(self, x, ar, train, views):
        out = torch.relu(batch_norm(ar.conv(x, self.conv1.weight, None,
                                            self.conv1.stride, 1),
                                    self.bn1, train, views))
        out = batch_norm(ar.conv(out, self.conv2.weight, None, 1, 1),
                         self.bn2, train, views)
        return torch.relu(out + _identity(self, x, ar, train, views))


class Bottleneck(nn.Module):
    """torchvision's v1.5 Bottleneck (stride on the 3x3 conv)."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        out = 4 * width
        self.conv1 = nn.Conv2d(cin, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(width, eps=BN_EPS)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out, eps=BN_EPS)
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, out, 1, stride, bias=False),
                nn.BatchNorm2d(out, eps=BN_EPS))

    def run(self, x, ar, train, views):
        out = torch.relu(batch_norm(ar.conv(x, self.conv1.weight), self.bn1,
                                    train, views))
        out = torch.relu(batch_norm(ar.conv(out, self.conv2.weight, None,
                                            self.conv2.stride, 1),
                                    self.bn2, train, views))
        out = batch_norm(ar.conv(out, self.conv3.weight), self.bn3, train,
                         views)
        return torch.relu(out + _identity(self, x, ar, train, views))


def _identity(block, x, ar, train, views):
    if block.downsample is None:
        return x
    conv, bn = block.downsample
    return batch_norm(ar.conv(x, conv.weight, None, conv.stride, 0), bn,
                      train, views)


class Trunk(nn.Module):
    """A torchvision ResNet without its pooling (its ``fc`` is in the
    checkpoints and never runs)."""

    def __init__(self, model_name: str):
        super().__init__()
        kind, depths = RESNETS[model_name]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64, eps=BN_EPS)
        cin = 64
        for li, (width, depth) in enumerate(zip((64, 128, 256, 512), depths),
                                            start=1):
            blocks = []
            for bi in range(depth):
                blocks.append(block(cin, width, 2 if li > 1 and bi == 0
                                    else 1))
                cin = width * block.expansion
            setattr(self, f"layer{li}", nn.Sequential(*blocks))
        self.fc = nn.Linear(512 * block.expansion, 1000)


class EncoderBlock(nn.Module):
    """The reference's Encoder_Block: the trunk and aliases of its stages
    (the same tensors under a second name)."""

    def __init__(self, model_name: str):
        super().__init__()
        t = self.backbone = Trunk(model_name)
        self.layer0 = nn.Sequential(t.conv1, t.bn1, nn.ReLU())
        self.layer1 = nn.Sequential(nn.MaxPool2d(3, 2, 1), t.layer1)
        self.layer2, self.layer3, self.layer4 = t.layer2, t.layer3, t.layer4


class Shared(nn.Module):
    def __init__(self, model_name: str):
        super().__init__()
        self.backbone = EncoderBlock(model_name)


def conv_relu(cin, cout, k, pad):
    return nn.Sequential(nn.Conv2d(cin, cout, k, padding=pad), nn.ReLU())


class Decoder(nn.Module):
    def __init__(self, maps: int, fs: int, views: int):
        super().__init__()
        self.layer1_1x1 = conv_relu(64 * fs, 64 * fs, 1, 0)
        self.layer2_1x1 = conv_relu(128 * fs, 128 * fs, 1, 0)
        self.layer3_1x1 = conv_relu(256 * fs, 258 * fs, 1, 0)
        self.layer4_1x1 = conv_relu(512 * fs, 512 * fs, 1, 0)
        self.conv_up1 = conv_relu(256 * fs + 64 * fs, 256 * fs, 3, 1)
        self.conv_up2 = conv_relu(512 * fs + 128 * fs, 256 * fs, 3, 1)
        self.conv_up3 = conv_relu(512 * fs + 258 * fs, 512 * fs, 3, 1)
        self.conv_heatmap = nn.Conv2d(256 * fs, maps * views, 1)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsampling with aligned corners, NCHW."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


def _cr(seq, x, ar, pad):
    conv = seq[0]
    return torch.relu(ar.conv(x, conv.weight, conv.bias, 1, pad))


class HeatmapNet(nn.Module):
    """Stereo heatmap net (reference HeatMap_UnrealEgo_Shared): one ResNet
    over both views folded into the batch, the views' pyramids
    concatenated view-major on channels, a UNet decoder."""

    def __init__(self, maps: int, model_name: str = "resnet18",
                 views: int = 2):
        super().__init__()
        self.views = views
        expansion = 1 if RESNETS[model_name][0] == "basic" else 4
        self.backbone = Shared(model_name)
        self.after_backbone = Decoder(maps, expansion * views, views)

    def forward(self, rgb: torch.Tensor, ar: Arith = F32,
                train: bool = False) -> torch.Tensor:
        """(B, V, H, W, 3) -> (B, H/4, W/4, maps * V) heatmaps."""
        b, v = rgb.shape[:2]
        t = self.backbone.backbone.backbone
        x = rgb.reshape((b * v,) + tuple(rgb.shape[2:])).permute(0, 3, 1, 2)
        x = torch.relu(batch_norm(ar.conv(x, t.conv1.weight, None, 2, 3),
                                  t.bn1, train, v))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for li in range(1, 5):
            for blk in getattr(t, f"layer{li}"):
                x = blk.run(x, ar, train, v)
            _, c, h, w = x.shape
            feats.append(x.reshape(b, v * c, h, w))
        d = self.after_backbone
        x = upsample2x(_cr(d.layer4_1x1, feats[3], ar, 0))
        x = _cr(d.conv_up3, torch.cat([x, _cr(d.layer3_1x1, feats[2], ar, 0)],
                                      1), ar, 1)
        x = upsample2x(x)
        x = _cr(d.conv_up2, torch.cat([x, _cr(d.layer2_1x1, feats[1], ar, 0)],
                                      1), ar, 1)
        x = upsample2x(x)
        x = _cr(d.conv_up1, torch.cat([x, _cr(d.layer1_1x1, feats[0], ar, 0)],
                                      1), ar, 1)
        out = ar.conv(x, d.conv_heatmap.weight, d.conv_heatmap.bias)
        return out.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- lifter
def tile_permutation(tiles: int, patches: int) -> np.ndarray:
    """perm[tile-major token] = image-row-major position, for a square
    image of ``tiles`` x ``tiles`` heatmaps of ``patches`` x ``patches``."""
    t, j = np.divmod(np.arange(tiles * tiles * patches * patches),
                     patches * patches)
    row, col = np.divmod(t, tiles)
    pr, pc = np.divmod(j, patches)
    return ((row * patches + pr) * (tiles * patches)
            + (col * patches + pc)).astype(np.int64)


class _Holder(nn.Module):
    """An empty module to hang HF-layout submodules on."""


class ViTLayer(nn.Module):
    def __init__(self, d: int, mlp: int):
        super().__init__()
        self.attention = _Holder()
        self.attention.attention = _Holder()
        for n in ("query", "key", "value"):
            setattr(self.attention.attention, n, nn.Linear(d, d))
        self.attention.output = _Holder()
        self.attention.output.dense = nn.Linear(d, d)
        self.intermediate = _Holder()
        self.intermediate.dense = nn.Linear(d, mlp)
        self.output = _Holder()
        self.output.dense = nn.Linear(mlp, d)
        self.layernorm_before = nn.LayerNorm(d, eps=LN_EPS)
        self.layernorm_after = nn.LayerNorm(d, eps=LN_EPS)

    def run(self, x, ar, heads):
        b, s, d = x.shape
        sa = self.attention.attention
        y = F.layer_norm(x, (d,), self.layernorm_before.weight,
                         self.layernorm_before.bias, LN_EPS)

        def split(lin):
            z = ar.linear(y, lin.weight, lin.bias)
            return z.reshape(b, s, heads, d // heads).transpose(1, 2)

        q, k, v = split(sa.query), split(sa.key), split(sa.value)
        p = torch.softmax(ar.matmul(q, k.transpose(-1, -2))
                          / math.sqrt(d // heads), dim=-1)
        ctx = ar.matmul(p, v).transpose(1, 2).reshape(b, s, d)
        o = self.attention.output.dense
        x = x + ar.linear(ctx, o.weight, o.bias)
        y = F.layer_norm(x, (d,), self.layernorm_after.weight,
                         self.layernorm_after.bias, LN_EPS)
        i, o = self.intermediate.dense, self.output.dense
        return x + ar.linear(F.gelu(ar.linear(y, i.weight, i.bias)),
                             o.weight, o.bias)


class GridViT(nn.Module):
    """The reference's PatchedHeatmapFeatureExtractorViT over N heatmaps
    tiled into one square image, the dummy tiles' patches masked. The
    image is not built: each heatmap is patchified directly and the
    position embeddings gathered, which attention cannot tell apart."""

    def __init__(self, tiles_n: int, d: int, layers: int, heads: int,
                 mlp: int, res: int):
        super().__init__()
        self.n, self.heads = tiles_n, heads
        self.p = res // PATCH
        self.t = int(math.sqrt(tiles_n - 1)) + 1
        total = self.t ** 2 * self.p ** 2
        self.embeddings = _Holder()
        e = self.embeddings
        e.mask_token = nn.Parameter(torch.zeros(1, 1, d))
        e.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        e.position_embeddings = nn.Parameter(torch.zeros(1, total, d))
        e.patch_embeddings = _Holder()
        e.patch_embeddings.projection = nn.Conv2d(1, d, PATCH, PATCH)
        self.encoder = _Holder()
        self.encoder.layer = nn.ModuleList(ViTLayer(d, mlp)
                                           for _ in range(layers))
        self.layernorm = nn.LayerNorm(d, eps=LN_EPS)
        self.pooler = _Holder()
        self.pooler.dense = nn.Linear(d, d)

    def run(self, patches, ar):
        """(B, N, P*P, 256) patch pixels -> (B, N, P*P*D)."""
        b, n, tpt, _ = patches.shape
        e = self.embeddings
        proj = e.patch_embeddings.projection
        d = proj.weight.shape[0]
        real = ar.linear(patches, proj.weight.reshape(d, -1), proj.bias)
        real = real.reshape(b, n * tpt, d)
        dummy = e.mask_token.expand(b, self.t ** 2 * tpt - n * tpt, d)
        perm = torch.from_numpy(tile_permutation(self.t, self.p)).to(
            patches.device)
        x = torch.cat([real, dummy], 1) + e.position_embeddings[0, perm]
        for layer in self.encoder.layer:
            x = layer.run(x, ar, self.heads)
        x = F.layer_norm(x, (d,), self.layernorm.weight, self.layernorm.bias,
                         LN_EPS)
        return x[:, :n * tpt].reshape(b, n, tpt * d)


class FCBlock(nn.Module):
    """Linear + BatchNorm1d + LeakyReLU(0.2) (reference make_fc_layer)."""

    def __init__(self, d_in, d_out):
        super().__init__()
        self.fc = nn.Linear(d_in, d_out)
        self.bn = nn.BatchNorm1d(d_out, eps=BN_EPS)

    def run(self, x, ar, train):
        return leaky(batch_norm(ar.linear(x, self.fc.weight, self.fc.bias),
                                self.bn, train))


class FCStack(nn.Module):
    def __init__(self, d_in, hidden):
        super().__init__()
        self.fc1 = FCBlock(d_in, 2048)
        self.fc2 = FCBlock(2048, 512)
        self.fc3 = FCBlock(512, hidden)

    def run(self, x, ar, train):
        for blk in (self.fc1, self.fc2, self.fc3):
            x = blk.run(x, ar, train)
        return x


class ViTEncoder(FCStack):
    def __init__(self, tiles_n, hidden, d, layers, heads, mlp, res):
        super().__init__((res // PATCH) ** 2 * d, hidden)
        self.vit = GridViT(tiles_n, d, layers, heads, mlp, res)


class PUCell(nn.Module):
    def __init__(self, d_in: int, bridge: int, hidden: int):
        super().__init__()
        self.x2f = nn.Linear(d_in, hidden + bridge)
        self.x2h = nn.Linear(d_in, 4 * hidden)
        if bridge:
            self.b2h = nn.Linear(bridge, 4 * hidden)
        self.h2h = nn.Linear(hidden, 4 * hidden)


def _cell(gates, c):
    f, i, g, o = gates.chunk(4, dim=-1)
    c = c * torch.sigmoid(f) + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


class PUChain(nn.Module):
    """The reference's PropagationUnit stack walked as a flat chain."""

    def __init__(self, d_in: int, hidden: int, layers: int):
        super().__init__()
        self.hidden = hidden
        self.layers = nn.ModuleList(
            [PUCell(d_in, d_in, hidden)]
            + [PUCell(hidden, 0, hidden) for _ in range(layers - 1)])

    def run(self, x, bridge, ar):
        H, c0 = self.hidden, self.layers[0]
        bh = ar.linear(x, c0.x2f.weight, c0.x2f.bias)
        fh = torch.sigmoid(bh[..., :H])
        pre = (ar.linear(x, c0.x2h.weight, c0.x2h.bias)
               + ar.linear(torch.sigmoid(bh[..., H:]) * bridge,
                           c0.b2h.weight, c0.b2h.bias))
        b, J = x.shape[:2]
        state = [(x.new_zeros(b, H), x.new_zeros(b, H))
                 for _ in self.layers]
        outs = []
        for j in range(J):
            h, c = state[0]
            h, c = _cell(pre[:, j] + ar.linear(fh[:, j] * h, c0.h2h.weight,
                                               c0.h2h.bias), c)
            state[0] = (h, c)
            for li, cell in enumerate(self.layers[1:], start=1):
                hl, cl = state[li]
                fl = torch.sigmoid(ar.linear(h, cell.x2f.weight,
                                             cell.x2f.bias))
                h, c = _cell(ar.linear(h, cell.x2h.weight, cell.x2h.bias)
                             + ar.linear(fl * hl, cell.h2h.weight,
                                         cell.h2h.bias), cl)
                state[li] = (h, c)
            outs.append(h)
        return torch.stack(outs, 1)


class Lifter(nn.Module):
    """The reference's EgoTAPAutoEncoder with ``--patched_heatmap_ae
    --skel_layer PU``: heatmap stack (B, res, res, V*J + V*J*Ld) NHWC ->
    (B, J + 1, 3) pose (UnrealEgo: the head is estimated, a global offset
    added to every joint)."""

    def __init__(self, joints: int = 15, views: int = 2, limb_dim: int = 2,
                 hidden: int = 128, vit_hidden: int = 1024,
                 vit_layers: int = 3, vit_heads: int = 8,
                 vit_mlp: int = 4096, pu_layers: int = 2, res: int = 64):
        super().__init__()
        J, V = joints, views
        self.J, self.V, self.Ld, self.hid = J, V, limb_dim, hidden
        bh = hidden * V
        self.pos_heatmap_encoder = ViTEncoder(J * V, hidden, vit_hidden,
                                              vit_layers, vit_heads, vit_mlp,
                                              res)
        self.rot_heatmap_encoder = FCStack(limb_dim * res * res, hidden)
        self.skel_sequential_layer = nn.ModuleDict(
            {"lstm_custom": PUChain(bh, 2 * bh, pu_layers)})
        self.pose_mlp = _Holder()
        self.pose_mlp.pose_fcs = nn.ModuleList([nn.Linear(3 * bh, 3)])
        self.global_mlp = _Holder()
        self.global_mlp.pose_fcs = nn.ModuleList([nn.Linear(J * 2 * bh, 6)])

    def forward(self, hm: torch.Tensor, ar: Arith = F32,
                train: bool = False,
                taps: Optional[Dict] = None) -> torch.Tensor:
        """``taps``, when given, receives ``skel``: the per-joint features
        out of the PU chain, (B, J, 2 * views * hidden)."""
        B, res = hm.shape[:2]
        J, V, Ld, hid = self.J, self.V, self.Ld, self.hid
        bh, P = hid * V, res // PATCH
        pos = hm[..., :J * V].reshape(B, P, PATCH, P, PATCH, J * V)
        pos = pos.permute(0, 5, 1, 3, 2, 4).reshape(B, J * V, P * P,
                                                    PATCH * PATCH)
        rot = hm[..., J * V:].reshape(B, res * res, V, Ld, J)
        rot = rot.permute(0, 2, 4, 3, 1).reshape(B * V * J, Ld * res * res)
        enc = self.pos_heatmap_encoder
        z = enc.vit.run(pos, ar).reshape(B * J * V, -1)
        pos_e = enc.run(z, ar, train).reshape(B, V, J, hid)
        rot_e = self.rot_heatmap_encoder.run(rot, ar, train).reshape(
            B, V, J, hid)
        pos_pj = pos_e.transpose(1, 2).reshape(B, J, bh)
        rot_pj = rot_e.transpose(1, 2).reshape(B, J, bh)
        skel = self.skel_sequential_layer["lstm_custom"].run(pos_pj, rot_pj,
                                                             ar)
        if taps is not None:
            taps["skel"] = skel
        head = self.pose_mlp.pose_fcs[0]
        pose = ar.linear(torch.cat([pos_pj, skel], -1).reshape(B * J, -1),
                         head.weight, head.bias).reshape(B, J, 3)
        g = self.global_mlp.pose_fcs[0]
        others = ar.linear(skel.reshape(B, -1), g.weight, g.bias)
        pose = pose + others[:, None, :3]
        return torch.cat([pose.reshape(B, J * 3), others[:, 3:]],
                         1).reshape(B, J + 1, 3)


# ---------------------------------------------------------------- the whole
class EgoTAP(nn.Module):
    """Both stages: pos and rot heatmap nets, then the lifter."""

    def __init__(self, cfg: Dict):
        super().__init__()
        J, V, Ld = cfg["num_heatmap"], 2, 2
        res = cfg["load_size_heatmap"][0]
        m = cfg["model_name"]
        self.pos_net = HeatmapNet(J, m, V)
        self.rot_net = HeatmapNet(J * Ld, m, V)
        w = cfg["widths"]
        self.lifter = Lifter(J, V, Ld, cfg["ae_hidden_size"],
                             w["vit_hidden"], w["vit_layers"], w["vit_heads"],
                             w["vit_mlp"], w["pu_layers"], res)

    def heatmaps(self, rgb, ar: Arith = F32, train: bool = False):
        return (self.pos_net(rgb, ar, train), self.rot_net(rgb, ar, train))

    def forward(self, rgb, ar: Arith = F32):
        """Eval mode: (B, V, H, W, 3) rgb -> (pos maps, rot maps, pose)."""
        pos, rot = self.heatmaps(rgb, ar)
        return pos, rot, self.lifter(torch.cat([pos, rot], -1), ar)


# ---------------------------------------------------------------- training
def pose_losses(pose: torch.Tensor, gt: torch.Tensor, cfg: Dict,
                parents: Sequence[int]) -> torch.Tensor:
    """lambda_mpjpe * MPJPE + lambda_cos_sim * lambda_mpjpe * (summed
    bone cosine), reference utils/loss.py."""
    mpjpe = torch.linalg.vector_norm(gt - pose, dim=-1).mean()
    idx = torch.as_tensor(list(parents), device=pose.device)
    bp = (pose - pose[:, idx])[:, 1:]
    bg = (gt - gt[:, idx])[:, 1:]
    cos = (bp * bg).sum(-1) / (
        torch.linalg.vector_norm(bp, dim=-1).clamp_min(COS_EPS)
        * torch.linalg.vector_norm(bg, dim=-1).clamp_min(COS_EPS))
    lm, lc = cfg["lambda_mpjpe"], cfg["lambda_cos_sim"]
    return {"pose": lm * mpjpe, "cos_sim": lc * lm * cos.sum(-1).mean()}


def learning_rate(cfg: Dict, step: int) -> float:
    """cos_anneal_warmup: linear warmup over ``niter`` epochs of
    iterations, then a cosine to zero (HF get_cosine_schedule_with_warmup),
    read at the update count before the update."""
    ipe = cfg["iters_per_epoch"]
    warmup = cfg["niter"] * ipe
    if step < warmup:
        return cfg["lr"] * step / max(1, warmup)
    total = (cfg["niter"] + cfg["niter_decay"]) * ipe
    progress = min((step - warmup) / max(1, total - warmup), 1.0)
    return cfg["lr"] * max(0.0, 0.5 * (1 + math.cos(math.pi * progress)))


class AdamW:
    """Adam with decoupled weight decay, eps outside the square root."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: Dict):
        self.cfg, self.count = cfg, 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, params, grads) -> None:
        lr = learning_rate(self.cfg, self.count)
        self.count += 1
        eps, wd = self.cfg["opt_eps"], self.cfg["weight_decay"]
        for k, g in grads.items():
            if g is None:
                continue
            p = params[k]
            self.mu[k].mul_(B1).add_(g, alpha=1 - B1)
            self.nu[k].mul_(B2).addcmul_(g, g, value=1 - B2)
            upd = (self.mu[k] / (1 - B1 ** self.count)) / (
                (self.nu[k] / (1 - B2 ** self.count)).sqrt() + eps)
            p.sub_(lr * (upd + wd * p))


def train_steps(model: EgoTAP, batches: List[Dict[str, torch.Tensor]],
                cfg: Dict, parents: Sequence[int], ar: Arith = F32,
                batch_fault: Optional[str] = None):
    """The stage-2 training steps of the lifter on ``batches``: the heatmap
    nets frozen in train-mode BatchNorm, the lifter forward in train mode,
    the loss, its gradients and AdamW. Returns (the losses of each step,
    the per-leaf norms of the first step's gradients, the lifter's
    parameters before the steps). ``model`` ends holding the trained
    lifter. ``batch_fault="half"``: the loss over the first half of each
    batch only (a planted fault)."""
    params = dict(model.lifter.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = AdamW(params, cfg)
    losses, grad_norms = [], None
    for batch in batches:
        rgb, gt = batch["input_rgb"], batch["gt_local_pose"]
        if batch_fault == "half":
            rgb, gt = rgb[: len(rgb) // 2], gt[: len(gt) // 2]
        with torch.no_grad():
            hm = torch.cat(model.heatmaps(rgb, ar, train=True), -1)
        with torch.enable_grad():
            terms = pose_losses(model.lifter(hm, ar, train=True), gt, cfg,
                                parents)
            loss = sum(terms.values())
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
        grads = dict(zip(params, grads))
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()
                          if g is not None}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
    return losses, grad_norms, start
