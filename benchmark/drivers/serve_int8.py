"""The int8 serving driver (traffic ``kind`` ``serve_int8``): the serving
driver's closed loop of `Predictor` requests (`drivers/serve.py`, the same
traffic keys) on a configuration whose int8 fields are set, with a second
check beside the float32 one.

Set-up, window and traced window are the serving driver's: the
`Predictor` follows the configuration's int8 fields and calibrates its
static scales on `serve.calibration_frames`.

The check keeps `serve.Driver.check`'s readings against the float32
reference (``heatmap_rms``, ``skel_rms``, ``pose_max`` ...) and adds, on
the same sampled slots, readings against the plain int8 reference
(`reference_int8.py`) in the configuration's precision, its static scales
calibrated on the same frames by the deployment's protocol; each reading
relative to the reference's largest or rms value, the worst request, slot
or module:

  * ``int8_scale_gap``: the largest relative gap between a static scale
    the program installed and the reference's own; a scale of the
    reference that the program lacks reads NaN;
  * ``int8_product_rms``: every module that runs int8 products (a trunk
    BasicBlock, a decoder convolution, a lifter projection), its output
    on the first sampled slot's request against the reference's exact
    product of the program's own input to it with the program's static
    scale (the reference's own where the program has none), left
    unrounded: a sound module reads the rounding of its stored output
    alone, nothing carried through later layers; a module not found or
    not called reads NaN;
  * ``int8_skel_rms``: the per-joint features against the reference's
    int8 lifter, with the program's scales, on the program's own heatmap
    stack (stage 2 alone);
  * ``int8_pose_max`` (and ``int8_pose_rms``): the pose against the
    reference's own int8 answer from the frames, with its own scales: no
    number of the program enters it.

`reading` adds the int8 products' summed bound and MACs a request
(`reference_int8.int8_products`, `bounds_int8.py`).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark import bounds_int8
from benchmark import reference_int8 as Q
from benchmark import weights as W
from benchmark.common import KEYS, draw_states
from benchmark.drivers import serve

TRAFFIC = serve.TRAFFIC
NETS = ("pos_net", "rot_net", "lifter")
INT8_MATMUL = ("egotap.int8.matmul",)
INT8_CALLS = ("egotap.int8.conv", "egotap.int8.dense")


def program_scales(pred) -> Dict[str, torch.Tensor]:
    """The static activation scales installed in the program's nets, by
    ``<net>.<module path>``."""
    out = {}
    for name in NETS:
        for path, m in getattr(pred, name).named_modules():
            scale = getattr(m, "a_scale", None)
            if isinstance(scale, torch.Tensor):
                out[f"{name}.{path}"] = scale.detach().float()
    return out


def scale_gap(program: Dict[str, torch.Tensor],
              own: Dict[str, torch.Tensor]) -> float:
    """The largest relative gap of the program's scales from ``own``; NaN
    where the program lacks one of them."""
    if set(own) - set(program):
        return math.nan
    return max((float((program[k] - own[k]).abs() / own[k]) for k in own),
               default=math.nan)


@torch.no_grad()
def product_rms(pred, ref: Q.Int8EgoTAP, rgb: np.ndarray) -> float:
    """The worst module's output of one request of ``pred`` against
    ``ref.sites`` on the program's own input to it (module doc)."""
    got, hooks = {}, []

    def keeper(path):
        def keep(_mod, args, _kwargs, out):
            got[path] = (args[0].detach().clone(), out.detach().clone())
        return keep
    try:
        for path in ref.sites:
            net, _, sub = path.partition(".")
            try:
                mod = getattr(pred, net).get_submodule(sub)
            except AttributeError:
                return math.nan
            hooks.append(mod.register_forward_hook(keeper(path),
                                                   with_kwargs=True))
        pred(rgb)
    finally:
        for h in hooks:
            h.remove()
    worst = 0.0
    for path, site in ref.sites.items():
        if path not in got:
            return math.nan
        x, y = got.pop(path)
        worst = max(worst, serve.rel_rms(y.float(), site(x)))
    return worst


class Driver(serve.Driver):
    def reading(self, peaks) -> Dict:
        out = super().reading(peaks)
        products = Q.int8_products(self.cfg, self.tr["batch"])
        out.update(
            int8_macs_per_unit=sum(m * n * k for m, n, k in products),
            int8_bound_per_unit=(bounds_int8.products_bound(products, peaks)
                                 if peaks else None),
            int8_matmul=INT8_MATMUL, int8_calls=INT8_CALLS)
        return out

    # ------------------------------------------------------------ check
    def check(self) -> Dict[str, float]:
        """The readings against the plain int8 reference while the program
        is alive, then `serve.Driver.check` on the same slots."""
        used = sorted(self.captured)
        rng = np.random.default_rng(W.sub_seed(self.seed, KEYS["sample"]))
        k = min(self.tr["check_slots"], len(used))
        slots = sorted(rng.choice(used, size=k, replace=False).tolist())
        kept = {s: self.captured[s] for s in slots}
        poses = [(s, p) for s, p in self.poses if s in kept]
        out = self.int8_check(slots, kept, poses)
        out.update(super().check())
        return out

    @torch.no_grad()
    def int8_check(self, slots, kept, poses) -> Dict[str, float]:
        cfg, dev = self.cfg, self.device
        model, _ = draw_states(cfg, self.seed, dev)
        ref = Q.Int8EgoTAP(model, cfg, bf16=cfg["precision"] == "bfloat16")
        ref.calibrate(serve.calibration_frames(cfg, self.seed,
                                               self.tr["batch"], dev))
        own = dict(ref.ar.scales)
        program = program_scales(self.pred)
        out = {"int8_scale_gap": scale_gap(program, own),
               "int8_skel_rms": 0.0, "int8_pose_max": 0.0,
               "int8_pose_rms": 0.0}
        ref.use_scales({**own, **{k: program[k] for k in own
                                  if k in program}})
        out["int8_product_rms"] = product_rms(self.pred, ref,
                                              self.pool[slots[0]])
        for s in slots:
            (pos_maps, rot_maps, skel), _ = kept[s]
            taps = {}
            ref.lifter(torch.cat([pos_maps.float(), rot_maps.float()], -1),
                       taps=taps)
            out["int8_skel_rms"] = max(out["int8_skel_rms"], serve.rel_rms(
                skel.float(), taps["skel"]))
        ref.use_scales(own)
        for s in slots:
            _, _, pose = ref(torch.from_numpy(self.pool[s]).to(dev))
            for slot, p in poses:
                if slot != s:
                    continue
                got = torch.from_numpy(p).to(dev)
                out["int8_pose_max"] = max(out["int8_pose_max"],
                                           serve.rel_max(got, pose))
                out["int8_pose_rms"] = max(out["int8_pose_rms"],
                                           serve.rel_rms(got, pose))
        return out
