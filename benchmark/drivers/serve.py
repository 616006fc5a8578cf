"""The serving driver (traffic ``kind`` ``serve``): a closed loop of
`Predictor` requests.

Set-up draws one reference-layout state for the two heatmap nets and the
lifter on the device from the seed, builds `egotap_tpu_torch.serving.
Predictor` from it (its modules constructed on the device), draws the
traffic's pool of distinct stereo batches into host memory, and warms the
one request shape up. The window then sends the pool's batches in turn,
one client, each request sent when the previous one has returned its
numpy pose, until ``--seconds`` have passed; the window ends when the
last request returns.

The check: forward hooks keep each pool slot's latest heatmap stack (both
nets' outputs of a timed call) and the lifter's per-joint features out of
its PU chain, with the pose; after the window, a sample of slots drawn
from the seed is run through the float32 reference on the same drawn
weights, and every timed request of those slots is compared with it. The
readings, each relative to the reference's largest or rms value (the
worst request or slot): the pose's largest and rms error, the heatmap
stack's, and ``skel_rms``, the features' rms error against the reference
lifter run on the program's own heatmap stack (stage 2 alone: the ViT
with kernel B, the limb encoder and the PU chain of kernel C).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from egotap_tpu_torch.serving import Predictor

from benchmark import bounds, flops, spans
from benchmark import weights as W
from benchmark.common import KEYS, build_kernels, draw_states, port_config

# the traffic file's keys this driver reads, besides ``kind`` and ``about``
TRAFFIC = ("batch", "pool", "warmup", "trace_units", "check_slots")
STAGE1 = ("bench.pos_net", "bench.rot_net")
STAGE2 = ("bench.lifter",)


def calibration_frames(cfg: Dict, seed: int, batch: int, device):
    """2 batches of frames + 0.1 noise, drawn from ``seed``: what an int8
    deployment calibrates its static scales on."""
    key = KEYS["calibration"]
    frames = W.frames(batch, cfg["image_size"], 2, seed, key, device)
    g = W.generator(device, seed, key, 1)
    return [f + 0.1 * torch.randn(f.shape, generator=g, device=device)
            for f in frames]


def predictor(cfg: Dict, states: Dict, device, seed: int, batch: int,
              int8=None):
    """The system under test: a `Predictor` on the drawn states, in the
    configuration's precision and int8 fields (``int8`` overrides them);
    an int8 path gets static scales calibrated on `calibration_frames`."""
    with torch.device(device):
        pred = Predictor(port_config(cfg), states["pos_net"],
                         states["rot_net"], states["lifter"],
                         bf16=cfg["precision"] == "bfloat16", int8=int8,
                         device=device)
    if any(pred.int8):
        pred.calibrate(calibration_frames(cfg, seed, batch, device))
    return pred


def skeleton_layer(lifter: torch.nn.Module) -> torch.nn.Module:
    """The lifter's propagation over the joints (its one module under
    ``skel_sequential_layer``), whose output the check compares."""
    (layer,) = lifter.skel_sequential_layer.values()
    return layer


def rel_max(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).square().mean().sqrt()
                 / ref.square().mean().sqrt().clamp_min(1e-30))


class Driver:
    def __init__(self, cell, seed: int, device: str, program=None):
        self.seed, self.device = seed, device
        self.cfg, self.tr = cell.config, cell.traffic
        self.program = program or predictor
        self.attempted = self.failed = 0

    # ------------------------------------------------------------ set-up
    def setup(self, phases: Dict[str, float]) -> None:
        cfg, tr, dev = self.cfg, self.tr, self.device
        build_kernels(dev, phases)
        t = time.perf_counter()
        self.pool = [x.cpu().numpy() for x in W.frames(
            tr["batch"], cfg["image_size"], tr["pool"], self.seed,
            KEYS["frames"], dev)]
        phases["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        _, states = draw_states(cfg, self.seed, dev)
        self.pred = self.program(cfg, states, dev, self.seed, tr["batch"])
        del states
        phases["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        self._kept = [None, None, None]
        self.captured = {}
        taps = (self.pred.pos_net, self.pred.rot_net,
                skeleton_layer(self.pred.lifter))
        self._hooks = [m.register_forward_hook(self._keeper(i))
                       for i, m in enumerate(taps)]
        for i in range(tr["warmup"]):
            self.pred(self.pool[i % len(self.pool)])
        if dev == "cuda":
            torch.cuda.synchronize()
        phases["warmup"] = time.perf_counter() - t

    def _keeper(self, i):
        def keep(_mod, _args, out):
            self._kept[i] = out
        return keep

    # ------------------------------------------------------------ window
    def _request(self, slot: int):
        out = self.pred(self.pool[slot])
        self.captured[slot] = (tuple(self._kept), out)
        return out

    def window(self, seconds: float) -> None:
        n = len(self.pool)
        self.poses, lat = [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        i = 0
        while True:
            slot = i % n
            ts = time.perf_counter()
            out = self._request(slot)
            te = time.perf_counter()
            lat.append(te - ts)
            self.poses.append((slot, out))
            i += 1
            if te >= deadline:
                break
        self.window_s = te - t0
        self.latencies_s = lat
        self.attempted = i
        shape = (self.tr["batch"], self.cfg["joints_out"], 3)
        self.failed = sum(1 for _, p in self.poses
                          if p.shape != shape or not np.isfinite(p).all())

    def traced(self):
        n, units = len(self.pool), self.tr["trace_units"]
        sp = spans.Spans()
        sp.module(self.pred.pos_net, STAGE1[0])
        sp.module(self.pred.rot_net, STAGE1[1])
        sp.module(self.pred.lifter, STAGE2[0])

        def loop():
            for i in range(units):
                self._request(i % n)
            if self.device == "cuda":
                torch.cuda.synchronize()
        try:
            return spans.profile(loop)
        finally:
            sp.remove()

    def reading(self, peaks) -> Dict:
        batch = self.tr["batch"]
        itemsize = 2 if self.cfg["precision"] == "bfloat16" else 4
        return dict(batch=batch, window_s=self.window_s,
                    units=self.attempted, pairs=batch * self.attempted,
                    latencies_s=self.latencies_s,
                    traced_units=self.tr["trace_units"],
                    flops_per_unit=flops.count(self.cfg, batch, False),
                    bounds_per_unit=(bounds.forward_bounds(
                        self.cfg, batch, itemsize, peaks) if peaks else None),
                    kernel_names=bounds.KERNELS,
                    stage1=STAGE1, stage2=STAGE2)

    # ------------------------------------------------------------ check
    def free(self) -> None:
        for h in getattr(self, "_hooks", ()):
            h.remove()
        self.pred = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        """The sampled slots' timed requests against the reference."""
        used = sorted(self.captured)
        rng = np.random.default_rng(W.sub_seed(self.seed, KEYS["sample"]))
        k = min(self.tr["check_slots"], len(used))
        slots = sorted(rng.choice(used, size=k, replace=False).tolist())
        kept = {s: self.captured[s] for s in slots}
        poses = [(s, p) for s, p in self.poses if s in kept]
        self.captured.clear()
        self.free()
        model, _ = draw_states(self.cfg, self.seed, self.device)
        model.eval()
        out = {"pose_max": 0.0, "pose_rms": 0.0, "heatmap_max": 0.0,
               "heatmap_rms": 0.0, "skel_rms": 0.0}
        with torch.no_grad():
            for s in slots:
                rgb = torch.from_numpy(self.pool[s]).to(self.device)
                pos, rot, pose = model(rgb)
                ref_hm = torch.cat([pos, rot], -1)
                (pos_maps, rot_maps, skel), _ = kept[s]
                hm = torch.cat([pos_maps.float(), rot_maps.float()], -1)
                out["heatmap_max"] = max(out["heatmap_max"],
                                         rel_max(hm, ref_hm))
                out["heatmap_rms"] = max(out["heatmap_rms"],
                                         rel_rms(hm, ref_hm))
                taps = {}
                model.lifter(hm, taps=taps)
                out["skel_rms"] = max(out["skel_rms"],
                                      rel_rms(skel.float(), taps["skel"]))
                for slot, p in poses:
                    if slot != s:
                        continue
                    got = torch.from_numpy(p).to(self.device)
                    out["pose_max"] = max(out["pose_max"], rel_max(got, pose))
                    out["pose_rms"] = max(out["pose_rms"], rel_rms(got, pose))
                del pos, rot, pose, ref_hm, hm, taps
        out["compared_requests"] = float(len(poses))
        return out
