"""The benchmark's plain int8 reference: EgoTAP as its int8 serving
deployment computes it, in plain PyTorch.

It builds on `reference.py` (the float32 EgoTAP, not edited): the same
modules and drawn state, with `Int8Arith`, an ``ar`` of its own, doing
the products, and a BatchNorm-folded forward of the heatmap nets. It
imports neither the program under test nor the JAX package; the JAX
package (``egotap_tpu``) defines the scheme, and each rule below names
where:

  * weights: symmetric per output channel, ``w_scale = max(max|w| / 127,
    1e-12)``, codes ``clip(round_half_even(w / w_scale), -127, 127)``
    (``egotap_tpu/ops/quant.py:46-51``, ``:143-146``);
  * activations: symmetric per tensor, ``a_scale = max(amax, 1e-12) /
    127``, static from calibration or, while calibrating, dynamic per call
    (``ops/quant.py:54-63``, ``:196-210``);
  * products: the integer sum exact (int32 there, float64 here, computed
    from the codes), dequantised as ``acc * (a_scale * w_scale) + bias``
    in float32, then stored in the compute dtype (``ops/quant.py:
    122-127``, ``:154-159``);
  * which convolutions quantise: 128 input channels or more always, 64 to
    127 only with a static scale, else a float convolution in the compute
    dtype; the 3-channel stem is always float (``ops/quant.py:353-367``,
    ``models/resnet.py:95-125``);
  * the ResNet trunk's BasicBlocks fold eval-mode BatchNorm into their
    convolutions' weights (``g = scale / sqrt(var + eps)``, the f32 root
    correctly rounded) before quantising them (``models/resnet.py:73-82``,
    ``:104-116``; ``ops/fused_layer1.py:41-48``);
  * the UNet decoder's convolutions, its final 1x1 one included, are int8
    (``models/layers.py:141-150``, ``models/heatmap_net.py``); its 2x
    upsampling takes two taps a row, then a column, at fractions computed
    in float64, ``a * (1 - f) + b * f`` in float32 (``ops/upsample.py:
    60-69``, ``:83-95``), rounded once to the stored dtype;
  * the lifter: the ViT's q, k, v, attention-output and MLP projections
    and every FC block of both encoders in int8, q, k and v sharing one
    quantisation of the LayerNorm output (``models/vit.py:61-82``,
    ``models/encoders.py:40-44``, ``:121-125``, ``models/layers.py:
    175-181``, ``models/lifter.py:58``, ``:87-94``); the patch projection,
    attention's two products, the PU chain and the pose heads stay float;
  * calibration: a forward over the calibration batches with dynamic
    scales for 128 input channels or more and float convolutions for 64
    to 127, recording max|x| at each int8 module's input (a q/k/v group
    once), the lifter on that forward's heatmap stack; each record
    becomes a static scale (``serving.py:177-240``, ``ops/quant.py:
    162-176``).

``bits`` below 8 (the control below the configuration's precision)
clamps codes to ``+-(2^(bits-1) - 1)`` and divides amax by that instead
of 127, for weights and activations alike.

Departures, each a choice of the reference's own:

  * everything not quantised runs in float32 (the deployment stores it in
    bfloat16); with ``bf16=True`` the heatmap nets' activations are
    rounded to bfloat16 where the program stores them, and the lifter's
    where they enter and leave a product (weights of float products too);
  * only the deployment with both int8 fields set is written: a ResNet of
    Bottleneck blocks (its int8 form is unfolded), or int8 in one stage
    alone, raises; no configuration of the benchmark runs one;
  * `Int8EgoTAP.use_scales` can install given static scales (the
    program's) in place of the reference's own calibration.

`Int8EgoTAP.sites` computes, for each module of the deployment that runs
int8 products, its output from a given input (the program's own input
to that module), with every product exact and the module's output left
unrounded: a trunk BasicBlock (its first convolution's output rounded as
stored, its second convolution, downsample and residual sum not), a
decoder convolution, a lifter projection.

`int8_products` gives the (M, N, K) of every product a configuration runs
in int8 in one forward, read on the meta device.
"""

from __future__ import annotations

import copy
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import reference as R

EPS = 1e-12
# ops/quant.py:353-354: the gating of a convolution by its input channels
QUANT_MIN_IN, DYNAMIC_MIN_IN = 64, 128


class _Everywhere(dict):
    """Static scales for a forward on the meta device: one for every key."""

    def __missing__(self, key):
        return torch.ones((), device="meta")


class Int8Arith(R.Arith):
    """The products of an int8 EgoTAP: those whose weight ``plan`` names
    (``id(weight)`` -> the key of its activation scale) in int ``bits``,
    the others float. ``amax`` (a dict) while calibrating; ``products``
    (a list) receives each integer product's (M, N, K) while recording."""

    def __init__(self, bits: int = 8, bf16: bool = False):
        super().__init__()
        self.qmax = float(2 ** (bits - 1) - 1)
        self.bf16 = bf16
        self.plan: Dict[int, str] = {}
        self.scales: Dict[str, torch.Tensor] = {}
        self.amax: Optional[Dict[str, torch.Tensor]] = None
        self.products: Optional[List[Tuple[int, int, int]]] = None
        self._codes: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    # ------------------------------------------------------------ rounding
    def store(self, x: torch.Tensor) -> torch.Tensor:
        """x as the deployment stores an activation (``bf16``)."""
        return x.to(torch.bfloat16).float() if self.bf16 else x

    def cast(self, t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """A float product's weight or bias in the compute dtype."""
        return None if t is None else self.store(t.float())

    def _q(self, like: torch.Tensor) -> torch.Tensor:
        # a tensor divisor: the IEEE quotient, as ops/quant.py computes it
        return torch.tensor(self.qmax, dtype=torch.float32,
                            device=like.device)

    def static_scale(self, key: str, x: torch.Tensor
                     ) -> Optional[torch.Tensor]:
        """The static activation scale of ``key``; while calibrating,
        record max|x| under ``key`` and return None (ops/quant.py:
        162-176)."""
        if self.amax is not None:
            a = x.detach().float().abs().amax()
            self.amax[key] = a if key not in self.amax \
                else torch.maximum(self.amax[key], a)
            return None
        return self.scales[key]

    def quantize(self, x: torch.Tensor, a_scale: Optional[torch.Tensor]):
        """(codes as float, scale): per tensor, static or dynamic
        (ops/quant.py:54-63)."""
        xf = x.float()
        if a_scale is None:
            a_scale = xf.abs().amax().clamp_min(EPS) / self._q(xf)
        codes = torch.round(xf / a_scale).clamp(-self.qmax, self.qmax)
        return codes, a_scale

    def weight_codes(self, w: torch.Tensor):
        """(codes, per-output-channel scale) of ``w`` (output channel
        first), kept per weight (ops/quant.py:46-51)."""
        hit = self._codes.get(id(w))
        if hit is not None and hit[0].device == w.device:
            return hit
        wf = w.detach().float()
        amax = wf.abs().amax(dim=tuple(range(1, wf.dim())))
        ws = (amax / self._q(wf)).clamp_min(EPS)
        shape = (-1,) + (1,) * (wf.dim() - 1)
        codes = torch.round(wf / ws.reshape(shape)).clamp(-self.qmax,
                                                          self.qmax)
        self._codes[id(w)] = (codes, ws)
        return codes, ws

    def unrounded(self) -> "Int8Arith":
        """This arithmetic (the same plan, scales and weight codes) with
        nothing rounded to bfloat16."""
        out = copy.copy(self)
        out.bf16 = False
        return out

    def _dequantize(self, acc, a_scale, ws, b, channel_dim: int):
        shape = [1] * acc.dim()
        shape[channel_dim] = -1
        out = acc.float() * (a_scale * ws).reshape(shape)
        if b is not None:
            out = out + b.float().reshape(shape)
        return self.store(out)

    # ------------------------------------------------------------ products
    def linear(self, x, w, b=None):
        x = self.store(x)
        key = self.plan.get(id(w))
        if key is None:
            return self.store(F.linear(x, self.cast(w), self.cast(b)))
        xq, a_scale = self.quantize(x, self.static_scale(key, x))
        wq, ws = self.weight_codes(w)
        rows = xq.reshape(-1, xq.shape[-1])
        if self.products is not None:
            self.products.append((rows.shape[0], wq.shape[0], wq.shape[1]))
        acc = (rows.double() @ wq.double().t()).reshape(
            tuple(x.shape[:-1]) + (wq.shape[0],))
        return self._dequantize(acc, a_scale, ws, b, -1)

    def conv(self, x, w, b=None, stride=1, padding=0):
        x = self.store(x)
        key = self.plan.get(id(w))
        cin = w.shape[1]
        a_scale = None
        if key is not None and cin >= QUANT_MIN_IN:
            a_scale = self.static_scale(key, x)
        if key is None or (a_scale is None and cin < DYNAMIC_MIN_IN):
            out = self.store(F.conv2d(x, self.cast(w), None, stride,
                                      padding))
            if b is None:
                return out
            return self.store(out + self.cast(b).reshape(1, -1, 1, 1))
        xq, a_scale = self.quantize(x, a_scale)
        wq, ws = self.weight_codes(w)
        acc = F.conv2d(xq.double(), wq.double(), None, stride, padding)
        if self.products is not None:
            n, o, h, wd = acc.shape
            self.products.append((n * h * wd, o, wq[0].numel()))
        return self._dequantize(acc, a_scale, ws, b, 1)


def _lerp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """2x align-corners interpolation along ``dim``, in float32."""
    n = x.shape[dim]
    src = np.arange(2 * n) * (n - 1) / max(2 * n - 1, 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    shape = [1] * x.dim()
    shape[dim] = -1
    f = torch.from_numpy((src - lo).astype(np.float32)).to(x.device)
    f = f.reshape(shape)
    a = x.index_select(dim, torch.from_numpy(lo).to(x.device))
    b = x.index_select(dim, torch.from_numpy(hi).to(x.device))
    return a * (1.0 - f) + b * f


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsampling with aligned corners of NCHW ``x``: rows,
    then columns (``egotap_tpu/ops/upsample.py:60-95``)."""
    return _lerp(_lerp(x.float(), 2), 3)


def fold_bn(conv: torch.nn.Conv2d, bn: torch.nn.BatchNorm2d):
    """(weight, bias) of ``conv`` with eval-mode ``bn`` folded in, in
    float32 (``egotap_tpu/ops/fused_layer1.py:41-48``)."""
    root = torch.sqrt((bn.running_var.float() + R.BN_EPS).double()).float()
    g = bn.weight.float() / root
    return (conv.weight.float() * g[:, None, None, None],
            bn.bias.float() - bn.running_mean.float() * g)


def _prefixed(module, prefix: str):
    return ((f"{prefix}.{name}" if name else prefix, m)
            for name, m in module.named_modules())


class Int8EgoTAP:
    """The reference's `EgoTAP` (its state loaded, eval mode) computed as
    the int8 deployment of ``cfg`` computes it: ``cfg`` sets
    ``int8_heatmap_inference`` and ``int8_lifter_inference`` both. Call
    `calibrate` (or `use_scales`) before a forward."""

    def __init__(self, model: R.EgoTAP, cfg: Dict, bits: int = 8,
                 bf16: bool = False):
        if not (cfg.get("int8_heatmap_inference")
                and cfg.get("int8_lifter_inference")):
            raise NotImplementedError("int8 in one stage alone: no "
                                      "benchmark configuration runs it")
        self.model = model.eval()
        self.ar = Int8Arith(bits, bf16)
        self.folded: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        # module path -> its output (f32) from the program's input to it
        self.sites: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {}
        for name in ("pos_net", "rot_net"):
            self._plan_heatmap_net(getattr(model, name), name)
        self._plan_lifter(model.lifter)

    def _plan_heatmap_net(self, net: R.HeatmapNet, name: str) -> None:
        trunk = net.backbone.backbone.backbone
        for path, blk in _prefixed(trunk, f"{name}.backbone.backbone"
                                          ".backbone"):
            if isinstance(blk, R.Bottleneck):
                raise NotImplementedError("int8 Bottleneck trunks: no "
                                          "benchmark configuration runs one")
            if not isinstance(blk, R.BasicBlock):
                continue
            for conv, bn, leaf in self._pairs(blk):
                w, c = self.folded[id(conv)] = fold_bn(conv, bn)
                self.ar.plan[id(w)] = f"{path}.{leaf}"
            self.sites[path] = partial(self._block_site, blk)
        for path, m in _prefixed(net.after_backbone,
                                 f"{name}.after_backbone"):
            if isinstance(m, torch.nn.Conv2d):
                self.ar.plan[id(m.weight)] = path
                self.sites[path] = partial(self._conv_site, m)

    @staticmethod
    def _pairs(blk: R.BasicBlock):
        pairs = [(blk.conv1, blk.bn1, "conv1"), (blk.conv2, blk.bn2, "conv2")]
        if blk.downsample is not None:
            pairs.append((blk.downsample[0], blk.downsample[1],
                          "downsample.0"))
        return pairs

    def _plan_lifter(self, lifter: R.Lifter) -> None:
        plan = self.ar.plan
        for path, m in _prefixed(lifter, "lifter"):
            if isinstance(m, R.ViTLayer):
                sa = m.attention.attention
                for sub in ("query", "key", "value"):
                    lin = sa.get_submodule(sub)
                    plan[id(lin.weight)] = f"{path}.qkv_in"
                    self._dense_site(f"{path}.attention.attention.{sub}",
                                     lin)
                for sub in ("attention.output.dense", "intermediate.dense",
                            "output.dense"):
                    lin = m.get_submodule(sub)
                    plan[id(lin.weight)] = f"{path}.{sub}"
                    self._dense_site(f"{path}.{sub}", lin)
            elif isinstance(m, R.FCBlock):
                plan[id(m.fc.weight)] = f"{path}.fc"
                self._dense_site(f"{path}.fc", m.fc)

    @property
    def exact(self) -> Int8Arith:
        """``ar`` with nothing rounded to bfloat16: the sites' outputs."""
        return self.ar.unrounded()

    def _dense_site(self, path: str, lin: torch.nn.Linear) -> None:
        self.sites[path] = lambda x: self.exact.linear(x, lin.weight,
                                                       lin.bias)

    # ------------------------------------------------------------ forward
    def _folded_conv(self, x, conv, stride, padding, ar=None):
        w, c = self.folded[id(conv)]
        return (ar or self.ar).conv(x, w, c, stride, padding)

    def _block(self, blk: R.BasicBlock, x, ar=None):
        """The BN-folded block; ``ar`` (default ``self.ar``) computes all
        but the first convolution."""
        ar = ar or self.ar
        out = torch.relu(self._folded_conv(x, blk.conv1, blk.conv1.stride,
                                           1))
        out = self._folded_conv(out, blk.conv2, 1, 1, ar)
        identity = x
        if blk.downsample is not None:
            ds = blk.downsample[0]
            identity = self._folded_conv(x, ds, ds.stride, 0, ar)
        return torch.relu(ar.store(out + identity))

    def _block_site(self, blk: R.BasicBlock, x: torch.Tensor):
        """NHWC block input -> NHWC output, left unrounded."""
        out = self._block(blk, self.ar.store(x.float()).permute(0, 3, 1, 2),
                          self.exact)
        return out.permute(0, 2, 3, 1)

    def _conv_site(self, conv: torch.nn.Conv2d, x: torch.Tensor):
        """NHWC decoder convolution input -> NHWC output, unrounded."""
        out = self.exact.conv(x.float().permute(0, 3, 1, 2), conv.weight,
                              conv.bias, conv.stride[0], conv.padding[0])
        return out.permute(0, 2, 3, 1)

    def heatmap_net(self, net: R.HeatmapNet, rgb: torch.Tensor
                    ) -> torch.Tensor:
        """(B, V, H, W, 3) -> (B, H/4, W/4, maps * V), as `reference.
        HeatmapNet.forward` with the trunk BN-folded and every product
        through ``ar``."""
        ar = self.ar
        t = net.backbone.backbone.backbone
        b, v = rgb.shape[:2]
        x = ar.store(rgb.reshape((b * v,) + tuple(rgb.shape[2:]))
                     ).permute(0, 3, 1, 2)
        x = ar.conv(x, t.conv1.weight, None, 2, 3)
        x = torch.relu(ar.store(R.batch_norm(x, t.bn1, False)))
        x = F.max_pool2d(x, 3, 2, 1)
        feats = []
        for li in range(1, 5):
            for blk in getattr(t, f"layer{li}"):
                x = self._block(blk, x)
            _, c, h, w = x.shape
            feats.append(x.reshape(b, v * c, h, w))
        d = net.after_backbone

        def cr(seq, inp, pad):
            return torch.relu(ar.conv(inp, seq[0].weight, seq[0].bias, 1,
                                      pad))

        def up(inp):
            return ar.store(upsample2x(inp))

        x = up(cr(d.layer4_1x1, feats[3], 0))
        x = cr(d.conv_up3, torch.cat([x, cr(d.layer3_1x1, feats[2], 0)], 1),
               1)
        x = cr(d.conv_up2, torch.cat([up(x), cr(d.layer2_1x1, feats[1], 0)],
                                     1), 1)
        x = cr(d.conv_up1, torch.cat([up(x), cr(d.layer1_1x1, feats[0], 0)],
                                     1), 1)
        out = ar.conv(x, d.conv_heatmap.weight, d.conv_heatmap.bias)
        return out.permute(0, 2, 3, 1)

    def heatmaps(self, rgb):
        return (self.heatmap_net(self.model.pos_net, rgb),
                self.heatmap_net(self.model.rot_net, rgb))

    def lifter(self, hm: torch.Tensor, taps: Optional[Dict] = None):
        return self.model.lifter(self.ar.store(hm.float()), self.ar,
                                 taps=taps)

    def __call__(self, rgb):
        """(B, V, H, W, 3) rgb -> (pos maps, rot maps, pose)."""
        pos, rot = self.heatmaps(rgb)
        return pos, rot, self.lifter(torch.cat([pos, rot], -1))

    # ------------------------------------------------------------ scales
    @torch.no_grad()
    def calibrate(self, batches) -> "Int8EgoTAP":
        """Static scales from a forward over ``batches`` ((B, V, H, W, 3)
        frames), by the protocol of the JAX package's
        `Predictor.calibrate` (``egotap_tpu/serving.py:177-240``)."""
        ar = self.ar
        ar.amax = {}
        try:
            for rgb in batches:
                self.lifter(torch.cat(self.heatmaps(rgb), -1))
            amax = ar.amax
        finally:
            ar.amax = None
        ar.scales = {k: a.clamp_min(EPS) / ar._q(a) for k, a in amax.items()}
        return self

    def use_scales(self, scales: Dict[str, torch.Tensor]) -> "Int8EgoTAP":
        """Install the given static scales (by the keys of this module's
        plan: ``<net>.<module path>``, a ViT layer's q/k/v group under
        ``<layer>.qkv_in``)."""
        self.ar.scales = {k: v.detach().float() for k, v in scales.items()}
        return self


def int8_products(cfg: Dict, batch: int) -> List[Tuple[int, int, int]]:
    """The (M, N, K) of every product that the configuration ``cfg`` runs
    in int8 in one serving forward at ``batch``, once static scales are
    installed; read on the meta device."""
    size = cfg["image_size"]
    with torch.device("meta"):
        model = R.EgoTAP(cfg)
        rgb = torch.empty(batch, cfg["views"], size, size, 3)
    ref = Int8EgoTAP(model, cfg)
    ref.ar.scales = _Everywhere()
    ref.ar.products = []
    with torch.no_grad():
        ref(rgb)
    return ref.ar.products
