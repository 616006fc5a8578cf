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
``cls_token`` and ``pooler``).
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Tuple

import numpy as np
import torch

from egotap_tpu_torch.core.device import resolve_device
from egotap_tpu_torch.models.heatmap_net import HeatmapUNet
from egotap_tpu_torch.models.lifter import EgoTAPLifter
from egotap_tpu_torch.models.resnet import RESNET_SPECS, feature_expansion
from egotap_tpu_torch.models.vit import PATCH


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


def _resnet(w: _Writer, prefix: str, model_name: str) -> None:
    kind, depths = RESNET_SPECS[model_name]
    n_convs = 2 if kind == "basic" else 3
    w.conv(prefix + "conv1", "backbone", "conv1", bias=False)
    w.bn(prefix + "bn1", "backbone", "bn1")
    for li, depth in enumerate(depths, start=1):
        for bi in range(depth):
            f, t = f"layer{li}_{bi}", f"{prefix}layer{li}.{bi}"
            for ci in range(1, n_convs + 1):
                w.conv(f"{t}.conv{ci}", "backbone", f, f"conv{ci}", bias=False)
                w.bn(f"{t}.bn{ci}", "backbone", f, f"bn{ci}")
            if w.has("backbone", f, "downsample_0"):
                w.conv(f"{t}.downsample.0", "backbone", f, "downsample_0",
                       bias=False)
                w.bn(f"{t}.downsample.1", "backbone", f, "downsample_1")


def heatmap_net_state_dict(variables: Dict[str, Any],
                           model_name: str = "resnet18"
                           ) -> "collections.OrderedDict[str, torch.Tensor]":
    """HeatmapUNet variables -> a ``*_net_HeatMap.pth``-layout state_dict."""
    w = _Writer(variables)
    canon = "backbone.backbone.backbone."
    _resnet(w, canon, model_name)
    e = feature_expansion(model_name)
    w.raw(canon + "fc.weight", np.zeros((1000, 512 * e), np.float32))
    w.raw(canon + "fc.bias", np.zeros((1000,), np.float32))
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
    for name in ("layer1_1x1", "layer2_1x1", "layer3_1x1", "layer4_1x1",
                 "conv_up1", "conv_up2", "conv_up3"):
        w.conv(f"after_backbone.{name}.0", name, "conv")
    w.conv("after_backbone.conv_heatmap", "conv_heatmap")
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


def lifter_state_dict(variables: Dict[str, Any], num_vit_layers: int = 3,
                      num_pu_layers: int = 2
                      ) -> "collections.OrderedDict[str, torch.Tensor]":
    """EgoTAPLifter variables -> a ``*_net_AutoEncoder.pth``-layout
    state_dict."""
    w = _Writer(variables)
    _vit(w, ("pos_encoder", "vit"), "pos_heatmap_encoder.vit.",
         num_vit_layers)
    for enc, prefix in (("pos_encoder", "pos_heatmap_encoder."),
                        ("rot_encoder", "rot_heatmap_encoder.")):
        for n in ("fc1", "fc2", "fc3"):
            w.linear(f"{prefix}{n}.fc", enc, n, "fc")
            w.bn(f"{prefix}{n}.bn", enc, n, "bn")
    for i in range(num_pu_layers):
        t = f"skel_sequential_layer.lstm_custom.layers.{i}."
        for name in ("x2f", "x2h", "b2h", "h2h"):
            if w.has("skelnet", f"cell{i}", name):
                w.linear(t + name, "skelnet", f"cell{i}", name)
    w.linear("pose_mlp.pose_fcs.0", "pose_mlp", "head")
    if w.has("global_mlp"):
        w.linear("global_mlp.pose_fcs.0", "global_mlp", "head")
    return w.state_dict()


def heatmap_net_from_jax(variables: Dict[str, Any],
                         model_name: str = "resnet18", *, views: int = 2,
                         device="cuda") -> HeatmapUNet:
    """A `HeatmapUNet` holding the JAX HeatmapUNet's weights (strict)."""
    dev = resolve_device(device)
    sd = heatmap_net_state_dict(variables, model_name)
    maps = sd["after_backbone.conv_heatmap.weight"].shape[0] // views
    net = HeatmapUNet(maps, model_name, views)
    net.load_state_dict(sd, strict=True)
    return net.eval().to(dev)


def lifter_from_jax(variables: Dict[str, Any], num_vit_layers: int = 3, *,
                    device="cuda", **lifter_kwargs) -> EgoTAPLifter:
    """An `EgoTAPLifter` holding the JAX EgoTAPLifter's weights (strict);
    ``lifter_kwargs`` are the lifter's constructor arguments."""
    dev = resolve_device(device)
    sd = lifter_state_dict(variables, num_vit_layers)
    net = EgoTAPLifter(vit_layers=num_vit_layers, **lifter_kwargs)
    net.load_state_dict(sd, strict=True)
    return net.eval().to(dev)
