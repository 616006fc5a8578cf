"""Where the serving forward's device time goes, on one card.

    python -m egotap_tpu_torch.breakdown           # bf16 and f32
    python -m egotap_tpu_torch.breakdown --int8    # the int8 serving forward

Builds a full-width `Predictor` (the `serving_config()` configuration,
seeded random weights) in bf16 and in f32, or with ``--int8`` in the
int8 serving configuration (bf16 compute, int8 heatmap nets and lifter,
static scales calibrated on 2 batches of the input + 0.1 noise, as
`bench.py` does), runs `ITERS` forwards of ``(BATCH, 2, 256, 256, 3)``
under `torch.profiler`, and prints per forward: the host wall time, the
summed device time of the kernels, the device's idle share of the wall
time, and the device time by kernel group (the port's kernels, int8 and
float matrix products, convolutions, the rest), each group's top
kernels by name. Needs a CUDA card; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import subprocess
import sys
import time

import torch

BATCH = 32                 # the serving batch of `chip_smoke.py`
ITERS = 3                  # profiled forwards, after one warm-up

GROUPS = (("kernel A upsample", ("upsample2x",)),
          ("kernel B attention", ("attention_",)),
          ("kernel C pu_chain", ("pu_chain",)),
          ("int8 matrix product (_int_mm)", ("gemm_s8", "i8i32", "imma")),
          ("convolution (cuDNN)", ("conv", "cudnn", "implicit", "winograd",
                                   "fprop", "dgrad", "sm90_xmma")),
          ("matrix product (cuBLAS)", ("gemm", "cutlass", "nvjet")),
          ("other", ("",)))


def group_of(name: str) -> str:
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


def profile(pred, rgb) -> None:
    from torch.profiler import ProfilerActivity, profile as torch_profile
    pred._forward(rgb)                               # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    walls = []
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            t0 = time.perf_counter()
            pred._forward(rgb)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    by_name = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_name[evt.name] += evt.device_time_total / 1e3 / ITERS  # ms
    device_ms = sum(by_name.values())
    wall_ms = 1e3 * statistics.median(walls)
    print(f"  wall {wall_ms:.3f} ms per forward (median of {ITERS}; under "
          f"the profiler), device kernels {device_ms:.3f} ms, idle share "
          f"{1 - device_ms / wall_ms:.3f}")
    if device_ms == 0:
        print("  device time: not measured (the profiler saw no kernels)")
        return
    groups = collections.defaultdict(list)
    for name, ms in by_name.items():
        groups[group_of(name)].append((ms, name))
    for label, _ in GROUPS:
        rows = sorted(groups.get(label, []), reverse=True)
        total = sum(ms for ms, _ in rows)
        print(f"  {label:26s} {total:9.3f} ms  {100 * total / device_ms:5.1f}%")
        for ms, name in rows[:3]:
            print(f"      {ms:9.3f} ms  {name[:90]}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--int8", action="store_true",
                        help="profile the calibrated int8 serving forward")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 2
    from egotap_tpu_torch.serving import Predictor
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    g = torch.Generator().manual_seed(1)
    rgb = torch.randn(BATCH, 2, 256, 256, 3, generator=g).cuda()
    modes = [("int8", True)] if args.int8 else [("bf16", True),
                                                 ("f32", False)]
    for label, bf16 in modes:
        print(f"{label} forward, batch {BATCH} [{card}]")
        pred = Predictor(bf16=bf16, int8=args.int8, device="cuda", seed=0)
        if args.int8:
            gc = torch.Generator(device="cuda").manual_seed(10)
            pred.calibrate([rgb + 0.1 * torch.randn(
                rgb.shape, generator=gc, device="cuda") for _ in range(2)])
        profile(pred, rgb)
        del pred
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
