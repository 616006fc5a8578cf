"""JAX package variables -> the port's modules (the weight bridge).

Takes the variables of `egotap_tpu`'s flax modules as nested dicts of
arrays (``{"params": ..., "batch_stats": ...}``; numpy or anything
``np.asarray`` accepts) and writes the reference-layout ``state_dict``
that the port's modules carry. This is the port's own copy of the
mapping in `egotap_tpu/compat/export.py:93-215` (`export_heatmap_net`,
`export_lifter`): conv HWIO -> OIHW, dense (in, out) -> (out, in),
BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
the ViT specials, the Encoder_Block alias keys, and zero tensors for the
reference-only tensors its forward never reads (torchvision ``fc``, ViT
``cls_token`` and ``pooler``). The same mapping carries the JAX package's
other stage-1 modules, which have no reference checkpoint: a
ResNetEncoder alone (any depth, the S2D stem), `FusedHeatmapUNet`, and
the legacy `ConvHeatmapEncoder` / `HeatmapDecoder`.

`task_state_from_jax` carries a JAX `HeatmapTask` or `LifterTask`
training state (the trained net with its running statistics, the frozen
nets of stage 2, the step and the optimizer state: Adam/AdamW moments or
a learned-LR optimizer's state) into the port's `train.state.TrainState`,
each per-parameter field through the same layout mapping as its
parameter, so that a run started in JAX continues in the port.

`install_jax_scales` carries the static activation scales of a JAX
``qparams`` collection (``a_scale`` entries, `amax_to_qparams`) into the
port's int8 modules, mapping each JAX module path to the port's
reference-layout module name (`port_module_name`).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Tuple

import numpy as np
import torch

from egotap_tpu_torch.core.config import Config
from egotap_tpu_torch.core.device import resolve_device
from egotap_tpu_torch.models.heatmap_net import HeatmapUNet
from egotap_tpu_torch.models.lifter import EgoTAPLifter
from egotap_tpu_torch.models.resnet import RESNET_SPECS, feature_expansion
from egotap_tpu_torch.models.vit import PATCH
from egotap_tpu_torch.serving import build_nets
from egotap_tpu_torch.train.optim import make_optimizer
from egotap_tpu_torch.train.state import TrainState


class _Writer:
    def __init__(self, variables: Dict[str, Any]):
        self.p = variables["params"]
        self.s = variables.get("batch_stats", {})
        self.out: Dict[str, np.ndarray] = collections.OrderedDict()

    @staticmethod
    def get(tree, *path) -> np.ndarray:
        for p in path:
            tree = tree[p]
        return np.asarray(tree, np.float32)

    def has(self, *path) -> bool:
        node = self.p
        for p in path:
            if not isinstance(node, dict) or p not in node:
                return False
            node = node[p]
        return True

    def raw(self, key: str, value: np.ndarray):
        self.out[key] = np.ascontiguousarray(value, np.float32)

    def conv(self, key: str, *path, bias: bool = True):
        self.raw(key + ".weight",
                 self.get(self.p, *path, "kernel").transpose(3, 2, 0, 1))
        if bias:
            self.raw(key + ".bias", self.get(self.p, *path, "bias"))

    def linear(self, key: str, *path):
        self.raw(key + ".weight", self.get(self.p, *path, "kernel").T)
        self.raw(key + ".bias", self.get(self.p, *path, "bias"))

    def bn(self, key: str, *path):
        self.raw(key + ".weight", self.get(self.p, *path, "scale"))
        self.raw(key + ".bias", self.get(self.p, *path, "bias"))
        self.raw(key + ".running_mean", self.get(self.s, *path, "mean"))
        self.raw(key + ".running_var", self.get(self.s, *path, "var"))
        self.out[key + ".num_batches_tracked"] = np.asarray(0, np.int64)

    def state_dict(self) -> "collections.OrderedDict[str, torch.Tensor]":
        return collections.OrderedDict(
            (k, torch.from_numpy(np.array(v))) for k, v in self.out.items())


def _resnet(w: _Writer, prefix: str, model_name: str,
            root: Tuple[str, ...] = ("backbone",)) -> None:
    """A ResNetEncoder's variables under ``root`` (Bottleneck nets: three
    convs a block; the S2D stem keeps ``conv1/kernel``)."""
    kind, depths = RESNET_SPECS[model_name]
    n_convs = 2 if kind == "basic" else 3
    w.conv(prefix + "conv1", *root, "conv1", bias=False)
    w.bn(prefix + "bn1", *root, "bn1")
    for li, depth in enumerate(depths, start=1):
        for bi in range(depth):
            f, t = f"layer{li}_{bi}", f"{prefix}layer{li}.{bi}"
            for ci in range(1, n_convs + 1):
                w.conv(f"{t}.conv{ci}", *root, f, f"conv{ci}", bias=False)
                w.bn(f"{t}.bn{ci}", *root, f, f"bn{ci}")
            if w.has(*root, f, "downsample_0"):
                w.conv(f"{t}.downsample.0", *root, f, "downsample_0",
                       bias=False)
                w.bn(f"{t}.downsample.1", *root, f, "downsample_1")


def _fc_head(w: _Writer, prefix: str, model_name: str) -> None:
    """torchvision's ``fc`` (zeros: in the checkpoints, never run)."""
    e = feature_expansion(model_name)
    w.raw(prefix + "fc.weight", np.zeros((1000, 512 * e), np.float32))
    w.raw(prefix + "fc.bias", np.zeros((1000,), np.float32))


def resnet_state_dict(variables: Dict[str, Any],
                      model_name: str = "resnet18"
                      ) -> "collections.OrderedDict[str, torch.Tensor]":
    """A JAX ResNetEncoder's own variables -> the port's `ResNetEncoder`
    state_dict (torchvision's keys)."""
    w = _Writer(variables)
    _resnet(w, "", model_name, root=())
    _fc_head(w, "", model_name)
    return w.state_dict()


_DECODER = ("layer1_1x1", "layer2_1x1", "layer3_1x1", "layer4_1x1",
            "conv_up1", "conv_up2", "conv_up3")


def heatmap_net_state_dict(variables: Dict[str, Any],
                           model_name: str = "resnet18"
                           ) -> "collections.OrderedDict[str, torch.Tensor]":
    """HeatmapUNet variables -> a ``*_net_HeatMap.pth``-layout state_dict."""
    w = _Writer(variables)
    canon = "backbone.backbone.backbone."
    _resnet(w, canon, model_name)
    _fc_head(w, canon, model_name)
    # Encoder_Block aliases: layer0 = (conv1, bn1, relu), layer1 =
    # (maxpool, resnet.layer1), layer2..4 = resnet.layer2..4
    alias = {}
    for k, v in w.out.items():
        rest = k[len(canon):]
        for src, dst in (("conv1.", "layer0.0."), ("bn1.", "layer0.1."),
                         ("layer1.", "layer1.1."), ("layer2.", "layer2."),
                         ("layer3.", "layer3."), ("layer4.", "layer4.")):
            if rest.startswith(src):
                alias["backbone.backbone." + dst + rest[len(src):]] = v
    w.out.update(alias)
    for name in _DECODER:
        w.conv(f"after_backbone.{name}.0", name, "conv")
    w.conv("after_backbone.conv_heatmap", "conv_heatmap")
    return w.state_dict()


def fused_heatmap_state_dict(variables: Dict[str, Any],
                             model_name: str = "resnet18"
                             ) -> "collections.OrderedDict[str, torch.Tensor]":
    """FusedHeatmapUNet variables -> the port's `FusedHeatmapUNet`
    state_dict (grouped kernels (k, k, in/G, out) -> (out, in/G, k, k),
    PyTorch's grouped layout)."""
    w = _Writer(variables)
    _resnet(w, "backbone.", model_name)
    for name in _DECODER:
        w.conv(f"{name}.0", name, "conv")
    g = 0
    while w.has(f"conv_heatmap_g{g}"):
        w.conv(f"conv_heatmap_g{g}", f"conv_heatmap_g{g}")
        g += 1
    return w.state_dict()


def _fc_blocks(w: _Writer, names) -> None:
    for n in names:
        w.linear(f"{n}.fc", n, "fc")
        w.bn(f"{n}.bn", n, "bn")


def conv_encoder_state_dict(variables: Dict[str, Any]
                            ) -> "collections.OrderedDict[str, torch.Tensor]":
    """ConvHeatmapEncoder variables -> the port's `ConvHeatmapEncoder`."""
    w = _Writer(variables)
    for i in (1, 2, 3):
        w.conv(f"conv{i}.conv", f"conv{i}", "conv")
        w.bn(f"conv{i}.bn", f"conv{i}", "bn")
    _fc_blocks(w, ("fc1", "fc2", "fc3"))
    return w.state_dict()


def heatmap_decoder_state_dict(variables: Dict[str, Any]
                               ) -> "collections.OrderedDict[str, torch.Tensor]":
    """HeatmapDecoder variables -> the port's `HeatmapDecoder`. Flax's
    ``ConvTranspose`` kernel (kh, kw, in, out) correlates the dilated,
    padded input; ``nn.ConvTranspose2d`` flips its (in, out, kh, kw)
    weight: the kernel goes across flipped in both spatial axes."""
    w = _Writer(variables)
    _fc_blocks(w, ("fc1", "fc2", "fc3"))
    for i in (1, 2, 3):
        k = w.get(w.p, f"deconv{i}", "kernel")
        w.raw(f"deconv{i}.weight", k[::-1, ::-1].transpose(2, 3, 0, 1))
        w.raw(f"deconv{i}.bias", w.get(w.p, f"deconv{i}", "bias"))
        w.bn(f"deconv_bn{i}", f"deconv_bn{i}")
    return w.state_dict()


def _vit(w: _Writer, path: Tuple[str, ...], prefix: str,
         num_layers: int) -> None:
    mask = w.get(w.p, *path, "mask_token")
    hidden = mask.shape[-1]
    w.raw(prefix + "embeddings.mask_token", mask[None, None])
    w.raw(prefix + "embeddings.cls_token", np.zeros((1, 1, hidden), np.float32))
    w.raw(prefix + "embeddings.position_embeddings",
          w.get(w.p, *path, "pos_embed")[None])
    k = w.get(w.p, *path, "patch_proj", "kernel")        # (C*16*16, hidden)
    c = k.shape[0] // (PATCH * PATCH)
    w.raw(prefix + "embeddings.patch_embeddings.projection.weight",
          k.reshape(c, PATCH, PATCH, hidden).transpose(3, 0, 1, 2))
    w.raw(prefix + "embeddings.patch_embeddings.projection.bias",
          w.get(w.p, *path, "patch_proj", "bias"))
    for i in range(num_layers):
        t, f = f"{prefix}encoder.layer.{i}.", path + (f"layer{i}",)
        for t_name, f_name in (("attention.attention.query", "query"),
                               ("attention.attention.key", "key"),
                               ("attention.attention.value", "value"),
                               ("attention.output.dense", "attn_out"),
                               ("intermediate.dense", "mlp_in"),
                               ("output.dense", "mlp_out")):
            w.linear(t + t_name, *f, f_name)
        for t_name, f_name in (("layernorm_before", "ln_before"),
                               ("layernorm_after", "ln_after")):
            w.raw(t + t_name + ".weight", w.get(w.p, *f, f_name, "scale"))
            w.raw(t + t_name + ".bias", w.get(w.p, *f, f_name, "bias"))
    w.raw(prefix + "layernorm.weight", w.get(w.p, *path, "ln_final", "scale"))
    w.raw(prefix + "layernorm.bias", w.get(w.p, *path, "ln_final", "bias"))
    w.raw(prefix + "pooler.dense.weight", np.zeros((hidden, hidden), np.float32))
    w.raw(prefix + "pooler.dense.bias", np.zeros((hidden,), np.float32))


def lifter_state_dict(variables: Dict[str, Any], num_vit_layers: int = 3
                      ) -> "collections.OrderedDict[str, torch.Tensor]":
    """EgoTAPLifter variables -> a ``*_net_AutoEncoder.pth``-layout
    state_dict. The skeleton layer is read from the variables: PU cells
    ``skelnet/cell{i}`` (any count) or LSTM layers ``skelnet/layer{i}``
    (``w_ih``/``w_hh`` stored (in, 4H), ``b_ih``/``b_hh``) to
    ``skel_sequential_layer.lstm.{weight,bias}_{ih,hh}_l{i}``, as the
    reference's nn.LSTM names them; the pass-through layers have none."""
    w = _Writer(variables)
    _vit(w, ("pos_encoder", "vit"), "pos_heatmap_encoder.vit.",
         num_vit_layers)
    for enc, prefix in (("pos_encoder", "pos_heatmap_encoder."),
                        ("rot_encoder", "rot_heatmap_encoder.")):
        for n in ("fc1", "fc2", "fc3"):
            w.linear(f"{prefix}{n}.fc", enc, n, "fc")
            w.bn(f"{prefix}{n}.bn", enc, n, "bn")
    i = 0
    while w.has("skelnet", f"cell{i}"):
        t = f"skel_sequential_layer.lstm_custom.layers.{i}."
        for name in ("x2f", "x2h", "b2h", "h2h"):
            if w.has("skelnet", f"cell{i}", name):
                w.linear(t + name, "skelnet", f"cell{i}", name)
        i += 1
    i = 0
    while w.has("skelnet", f"layer{i}"):
        t = "skel_sequential_layer.lstm."
        for leaf, name, transpose in (("w_ih", "weight_ih", True),
                                      ("w_hh", "weight_hh", True),
                                      ("b_ih", "bias_ih", False),
                                      ("b_hh", "bias_hh", False)):
            value = w.get(w.p, "skelnet", f"layer{i}", leaf)
            w.raw(f"{t}{name}_l{i}", value.T if transpose else value)
        i += 1
    w.linear("pose_mlp.pose_fcs.0", "pose_mlp", "head")
    if w.has("global_mlp"):
        w.linear("global_mlp.pose_fcs.0", "global_mlp", "head")
    return w.state_dict()


def heatmap_net_from_jax(variables: Dict[str, Any],
                         model_name: str = "resnet18", *, views: int = 2,
                         quant: bool = False, device="cuda") -> HeatmapUNet:
    """A `HeatmapUNet` holding the JAX HeatmapUNet's weights (strict)."""
    dev = resolve_device(device)
    sd = heatmap_net_state_dict(variables, model_name)
    maps = sd["after_backbone.conv_heatmap.weight"].shape[0] // views
    net = HeatmapUNet(maps, model_name, views, quant)
    net.load_state_dict(sd, strict=True)
    return net.eval().to(dev)


def lifter_from_jax(variables: Dict[str, Any], num_vit_layers: int = 3, *,
                    device="cuda", **lifter_kwargs) -> EgoTAPLifter:
    """An `EgoTAPLifter` holding the JAX EgoTAPLifter's weights (strict);
    ``lifter_kwargs`` are the lifter's constructor arguments, as JAX's
    (``skel_layer``, ``parents``, ``pu_semantics``, ``num_pu_layers``,
    ...)."""
    dev = resolve_device(device)
    sd = lifter_state_dict(variables, num_vit_layers)
    net = EgoTAPLifter(vit_layers=num_vit_layers, **lifter_kwargs)
    net.load_state_dict(sd, strict=True)
    return net.eval().to(dev)


def _optax_states(opt_state):
    """Every NamedTuple state inside an optax chain's nested tuples."""
    if hasattr(opt_state, "_fields"):
        yield opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            yield from _optax_states(sub)


def task_state_from_jax(jax_state: Any, cfg: Config, iters_per_epoch: int,
                        *, device="cuda") -> TrainState:
    """The port's `TrainState` holding a JAX task's state: for
    ``heatmap_shared`` (`HeatmapTask`) the HeatmapUNet's params and
    batch_stats, for ``egotap_autoencoder`` (`LifterTask`) the lifter's
    and the frozen ``heatmap`` / ``rot_heatmap`` nets with their running
    statistics; then ``step`` and the optimizer state: its count
    (``count``, or ``step`` for DSGD / DAdaGrad), each per-parameter
    field the port's optimizer keeps (Adam / AdamW ``mu`` / ``nu``;
    DAdam's and Prodigy's ``exp_avg``, ``exp_avg_sq``, ``grad_sum`` and
    Prodigy's ``params0``; DSGD's ``s``; DAdaGrad's ``s`` and ``a_sq``),
    each mapped like its parameter, and each scalar as it is
    (``estim_lr``, ``numerator_weighted``, ``d``, ``g0_norm``,
    ``grad_sum_sq``, ``weighted_sum``). The optimizer is the one JAX's
    ``init_state`` builds: stage-1 Adam for stage 1,
    `make_optimizer(cfg, iters_per_epoch)` for stage 2, and the lifter
    is built for ``cfg.skel_layer``."""
    dev = resolve_device(device)
    stats = jax_state.batch_stats
    if cfg.model == "heatmap_shared":
        net = HeatmapUNet(cfg.num_heatmap + cfg.num_rot_heatmap
                          * cfg.limb_dim, cfg.model_name, cfg.views)
        frozen = {}

        def to_state_dict(params):
            return heatmap_net_state_dict(
                {"params": params, "batch_stats": stats}, cfg.model_name)
        opt = make_optimizer(cfg, iters_per_epoch, stage1=True)
    else:
        pos_net, rot_net, net = build_nets(cfg)
        frozen = {"heatmap": pos_net, "rot_heatmap": rot_net}
        for key, frozen_net in frozen.items():
            frozen_net.load_state_dict(heatmap_net_state_dict(
                jax_state.frozen[key], cfg.model_name), strict=True)

        def to_state_dict(params):
            return lifter_state_dict({"params": params, "batch_stats": stats})
        opt = make_optimizer(cfg, iters_per_epoch)
    net.load_state_dict(to_state_dict(jax_state.params), strict=True)
    state = TrainState.create(net, frozen, opt, dev,
                              step=int(np.asarray(jax_state.step)))
    for sub in _optax_states(jax_state.opt_state):
        fields = sub._fields
        for count in ("count", "step"):
            if count in fields:
                opt.count = int(np.asarray(getattr(sub, count)))
        for field, tree in opt.trees.items():
            if field in fields:
                sd = to_state_dict(getattr(sub, field))
                for key in tree:
                    tree[key] = sd[key].to(dev)
        for field, value in opt.scalars.items():
            if field in fields:
                value.copy_(torch.as_tensor(np.asarray(getattr(sub, field),
                                                       np.float32)))
        if any(field in fields for field in opt.trees):
            break
    return state


# JAX ViTBlock submodule -> the port's (HF) name inside encoder.layer.{i}
_VIT_NAMES = {"query": "attention.attention.query",
              "key": "attention.attention.key",
              "value": "attention.attention.value",
              "attn_out": "attention.output.dense",
              "mlp_in": "intermediate.dense", "mlp_out": "output.dense",
              "qkv_in": "qkv_in"}
_ENCODERS = {"pos_encoder": "pos_heatmap_encoder",
             "rot_encoder": "rot_heatmap_encoder"}


def port_module_name(path: Tuple[str, ...]) -> str:
    """A JAX HeatmapUNet or EgoTAPLifter module path -> the port's module
    name, e.g. ``("backbone", "layer1_0", "conv1")`` ->
    ``backbone.backbone.backbone.layer1.0.conv1`` and ``("pos_encoder",
    "vit", "layer0", "qkv_in")`` ->
    ``pos_heatmap_encoder.vit.encoder.layer.0.qkv_in``."""
    head, rest = path[0], path[1:]
    if head == "backbone":                  # (layer{l}_{b}, conv)
        li, bi = rest[0][len("layer"):].split("_")
        conv = rest[1].replace("downsample_0", "downsample.0")
        return f"backbone.backbone.backbone.layer{li}.{bi}.{conv}"
    if head == "conv_heatmap":
        return "after_backbone.conv_heatmap"
    if head.endswith("_1x1") or head.startswith("conv_up"):
        return f"after_backbone.{head}.0"
    if head in _ENCODERS and rest[0] == "vit":      # (vit, layer{i}, name)
        i = rest[1][len("layer"):]
        return f"{_ENCODERS[head]}.vit.encoder.layer.{i}.{_VIT_NAMES[rest[2]]}"
    if head in _ENCODERS:                           # (fc{n}, fc)
        return f"{_ENCODERS[head]}.{rest[0]}.fc"
    raise KeyError(f"no port module for JAX path {'/'.join(path)}")


def jax_scales(qparams: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """{port module name: a_scale} for every ``a_scale`` entry of a JAX
    ``qparams`` tree (weight entries are ignored: the port quantizes its
    own weights, bit for bit the same)."""
    out: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for k, v in node.items():
            if k == "a_scale":
                out[port_module_name(path)] = np.asarray(v, np.float32)
            elif isinstance(v, dict):
                walk(v, path + (k,))

    walk(qparams, ())
    return out


def install_jax_scales(net: torch.nn.Module, qparams: Dict[str, Any]) -> int:
    """Set the static ``a_scale`` of each of ``net``'s int8 modules from a
    JAX ``qparams`` tree of the same network; returns how many."""
    dev = next(net.parameters()).device
    scales = jax_scales(qparams)
    for name, scale in scales.items():
        net.get_submodule(name).a_scale = torch.tensor(scale, device=dev)
    return len(scales)
