"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name `BENCHMARK.json` gives it:

  * ``configs/<config>.json``: the model as it is run, each field once:
    the sizes the reference, the FLOP count and the kernel bounds read,
    and under ``program`` the names of the fields that make the
    program's `Config`;
  * ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names
    the general driver that reads them, ``drivers/<kind>.py`` (`serve`: a
    closed loop of `Predictor` requests; `train_lifter`:
    `LifterTask.train_step` steps), whose ``TRAFFIC`` lists the keys it
    reads: a mix with another key is refused;
  * ``metrics/<metric>.py``: a reader, ``read(run)`` -> a number or None
    (nothing to read: the metric is left out of the line); the cells
    that report it are those `BENCHMARK.json` lists;
  * ``limits/<workload>.json``: the limit of each number the check
    compares, set from the readings `PERF.md` gives.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
import types
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "egotap_tpu")


class Cell(types.SimpleNamespace):
    """A workload of `BENCHMARK.json` with its files read."""


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    here = os.path.join(root, "benchmark")
    with open(os.path.join(here, "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    limits_path = os.path.join(here, "limits", f"{name}.json")
    limits = {}
    if os.path.exists(limits_path):
        with open(limits_path) as f:
            limits = json.load(f)["limits"]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(name=name, root=root, chips=w["chips"], config=config,
                traffic=traffic,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]), limits=limits)


def _load(path: str, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str, root: str = ROOT) -> Callable:
    return _load(os.path.join(root, "benchmark", "metrics", f"{metric}.py"),
                 f"benchmark_metric_{metric}").read


def peaks_for(kind: str) -> Optional[Dict]:
    """The published peaks of the card named ``kind`` (None: not in the
    table, so no share of a peak is reported)."""
    with open(os.path.join(HERE, "peaks.json")) as f:
        table = json.load(f)
    for key, peaks in table.items():
        if key != "about" and key in kind:
            return peaks
    return None


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


_DRIVERS: Dict = {}


def driver_for(cell: Cell):
    """The driver class that the cell's traffic ``kind`` names, after its
    traffic file is held to the keys that driver reads."""
    tr = cell.traffic
    module = _DRIVERS.get((cell.root, tr["kind"]))
    if module is None:
        module = _load(os.path.join(cell.root, "benchmark", "drivers",
                                    f"{tr['kind']}.py"),
                       f"benchmark_driver_{tr['kind']}")
        _DRIVERS[(cell.root, tr["kind"])] = module
    keys = set(tr) - {"kind", "about"}
    if keys != set(module.TRAFFIC):
        raise ValueError(
            f"traffic of {cell.name}: driver {tr['kind']!r} reads "
            f"{sorted(module.TRAFFIC)}, the file has {sorted(keys)}")
    return module.Driver


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, phases: Dict[str, float],
             program=None, log=print) -> dict:
    """One run of ``cell``; returns the result object. ``phases`` holds the
    set-up already spent (imports) and gains the driver's phases;
    ``program`` replaces the system under test (a control)."""
    import torch
    drv = driver_for(cell)(cell, seed, device, program)
    drv.setup(phases)
    setup_s = time.perf_counter() - t_start
    log("setup phases: " + ", ".join(f"{k} {v:.3f} s"
                                     for k, v in phases.items())
        + f"; setup_s {setup_s:.3f} s")
    on_card = device == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    drv.window(seconds)
    traced = drv.traced() if trace else None
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    peaks = peaks_for(kind) if on_card else None
    run = types.SimpleNamespace(**drv.reading(peaks), setup_s=setup_s,
                                trace=traced, peaks=peaks)
    checks = drv.check()          # frees the program, then the reference
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"], cell.root)(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    compared = {}
    correct = drv.failed == 0
    for name, limit in cell.limits.items():
        value = checks.get(name, float("nan"))
        ok = math.isfinite(value)
        compared[name] = {"value": value if ok else None, "limit": limit}
        correct = correct and ok and value <= limit
    if not cell.limits:
        correct = False
    log("readings: " + ", ".join(f"{k} {v:.6e}" for k, v in checks.items()))
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": drv.attempted,
              "failed": drv.failed, "metrics": metrics, "device": dev,
              "readings": {k: v if math.isfinite(v) else None
                           for k, v in checks.items()}}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in traced.device_ops],
            "idle_gaps": [[n, s] for n, s in traced.idle_gaps]}
    result["checks"] = compared
    return result
