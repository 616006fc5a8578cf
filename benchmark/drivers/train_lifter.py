"""The stage-2 training driver (traffic ``kind`` ``train_lifter``): steps
of `LifterTask.train_step`.

Set-up builds the task and one training state: the frozen heatmap nets
and the lifter take states drawn on the device from the seed (the lifter
in the reference's initialisation), the optimizer starts from zero. The
traffic's pool of distinct batches (stereo frames and ground-truth poses)
is drawn on the device. Set-up then drives that same state through its
first ``check_steps`` steps, on the first pool batches, through the
window's own call: they warm every shape up, and give the readings the
check compares (each step's loss, each leaf's first gradient as AdamW's
first moment holds it after one step, each leaf's change over the
steps). The window runs further steps on the same state, cycling through
the pool, and ends in ``torch.cuda.synchronize()``.

The check follows the same steps with the float32 reference
(`reference.train_steps`) from the same drawn state and batches.
"""

from __future__ import annotations

import math
import statistics
import time
from typing import Dict

import torch
from egotap_tpu_torch.ops import attention, pu_kernel, upsample
from egotap_tpu_torch.train.tasks import LifterTask

from benchmark import flops, spans
from benchmark import reference as R
from benchmark import weights as W
from benchmark.common import KEYS, build_kernels, draw_states, port_config

# the traffic file's keys this driver reads, besides ``kind`` and ``about``
TRAFFIC = ("batch", "pool", "check_steps", "trace_units")
FROZEN = ("bench.frozen_pos_net", "bench.frozen_rot_net")
OPTIMIZER = "bench.optimizer"
B1 = 0.9
# a leaf whose reference gradient is under this share of the median
# leaf's moves by round-off alone under Adam (a bias before BatchNorm):
# its change is not compared
NOUGHT = 1e-3


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             leaves) -> float:
    """The worst leaf's |‖got‖ - ‖ref‖|, against the larger of its
    reference norm and the median leaf's."""
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers of the training check, each program reading
    against the reference's (dicts of ``losses``, ``grad_norms``,
    ``change_norms``)."""
    losses = max(abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(prog["losses"], ref["losses"]))
    leaves = sorted(ref["grad_norms"])
    med = statistics.median(ref["grad_norms"][k] for k in leaves)
    moved = [k for k in leaves if ref["grad_norms"][k] >= NOUGHT * med]
    return {"loss_gap": losses,
            "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"],
                                 leaves),
            "change_gap": leaf_gap(prog["change_norms"],
                                   ref["change_norms"], moved),
            "leaves_compared": float(len(moved))}


def reference_readings(cfg: Dict, seed: int, batches, device,
                       ar=R.F32, batch_fault=None) -> Dict:
    """The reference's readings over ``batches`` from the drawn state."""
    model, _ = draw_states(cfg, seed, device, lifter_style="train")
    losses, grads, start = R.train_steps(model, batches, cfg,
                                         cfg["parents"], ar, batch_fault)
    change = {k: float((p.detach() - start[k]).norm())
              for k, p in model.lifter.named_parameters()}
    return {"losses": losses, "grad_norms": grads, "change_norms": change}


def draw_pool(cfg: Dict, tr: Dict, seed: int, device):
    """The traffic's pool of distinct batches: stereo frames and
    ground-truth poses, drawn on the device from ``seed``."""
    rgb = W.frames(tr["batch"], cfg["image_size"], tr["pool"], seed,
                   KEYS["frames"], device)
    gt = W.poses(tr["batch"], cfg["joints_out"], tr["pool"], seed,
                 KEYS["poses"], device)
    return [{"input_rgb": x, "gt_local_pose": y} for x, y in zip(rgb, gt)]


class Driver:
    def __init__(self, cell, seed: int, device: str, program=None):
        if program is not None:
            raise ValueError("a training cell's program is not replaced: "
                             "benchmark/control.py reads its controls")
        self.seed, self.device = seed, device
        self.cfg, self.tr = cell.config, cell.traffic
        self.attempted = self.failed = 0
        self.steps = 0

    def setup(self, phases: Dict[str, float]) -> None:
        cfg, tr, dev = self.cfg, self.tr, self.device
        build_kernels(dev, phases)
        t = time.perf_counter()
        self.pool = draw_pool(cfg, tr, self.seed, dev)
        phases["inputs"] = time.perf_counter() - t
        t = time.perf_counter()
        _, states = draw_states(cfg, self.seed, dev, lifter_style="train")
        self.task = LifterTask(port_config(cfg), device=dev)
        self.state = self.task.init_state(
            seed=W.sub_seed(self.seed, KEYS["init"]) % 2 ** 31,
            iters_per_epoch=cfg["iters_per_epoch"],
            heatmap_state=states["pos_net"],
            rot_heatmap_state=states["rot_net"])
        self.state.net.load_state_dict(states["lifter"], strict=True)
        del states
        phases["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        params = dict(self.state.net.named_parameters())
        start = {k: p.detach().clone() for k, p in params.items()}
        losses, grad_norms = [], None
        for i in range(tr["check_steps"]):
            _, loss_d = self.task.train_step(self.state, self.pool[i])
            losses.append(float(sum(loss_d.values())))
            if grad_norms is None:   # AdamW's first moment: (1 - b1) g
                grad_norms = {k: float(m.norm()) / (1 - B1)
                              for k, m in self.state.opt.mu.items()}
        change = {k: float((p.detach() - start[k]).norm())
                  for k, p in params.items()}
        del start
        self.readings = {"losses": losses, "grad_norms": grad_norms,
                         "change_norms": change}
        self.next = tr["check_steps"]
        if dev == "cuda":
            torch.cuda.synchronize()
        phases["warmup"] = time.perf_counter() - t

    def _step(self) -> None:
        batch = self.pool[self.next % len(self.pool)]
        self.next += 1
        self.task.train_step(self.state, batch)

    def _sync(self) -> None:
        if self.device == "cuda":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        while time.perf_counter() < deadline:
            self._step()
            n += 1
        self._sync()
        self.window_s = time.perf_counter() - t0
        self.steps = self.attempted = n

    def traced(self):
        sp = spans.Spans()
        sp.module(self.state.frozen["heatmap"], FROZEN[0])
        sp.module(self.state.frozen["rot_heatmap"], FROZEN[1])
        sp.module(self.state.net, "bench.lifter")
        sp.function(self.state.opt, "step", OPTIMIZER)

        def loop():
            for _ in range(self.tr["trace_units"]):
                self._step()
            self._sync()
        try:
            return spans.profile(loop)
        finally:
            sp.remove()

    def reading(self, peaks) -> Dict:
        batch = self.tr["batch"]
        return dict(batch=batch, window_s=self.window_s,
                    units=self.steps, pairs=batch * self.steps,
                    latencies_s=None, traced_units=self.tr["trace_units"],
                    flops_per_unit=flops.count(self.cfg, batch, True),
                    recompute=(upsample.BACKWARD_LABEL,
                               attention.BACKWARD_LABEL,
                               pu_kernel.BACKWARD_LABEL),
                    optimizer=OPTIMIZER)

    def free(self) -> None:
        self.task = self.state = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        prog = self.readings
        batches = self.pool[:self.tr["check_steps"]]
        self.free()
        ref = reference_readings(self.cfg, self.seed, batches, self.device)
        self.failed += sum(1 for v in prog["losses"] if not math.isfinite(v))
        return compare(prog, ref)
