"""Where the serving forward's device time goes, on one card.

    python -m egotap_tpu_torch.breakdown           # bf16 and f32
    python -m egotap_tpu_torch.breakdown --int8    # the int8 serving forward
    python -m egotap_tpu_torch.breakdown --train   # the stage-2 training step

Builds a full-width `Predictor` (the `serving_config()` configuration,
seeded random weights) in bf16 and in f32, or with ``--int8`` in the
int8 serving configuration (bf16 compute, int8 heatmap nets and lifter,
static scales calibrated on 2 batches of the input + 0.1 noise, as
`bench.py` does), runs `ITERS` forwards of ``(BATCH, 2, 256, 256, 3)``
under `torch.profiler`, and prints per forward: the host wall time, the
summed device time of the kernels, the device's idle share of the wall
time, and the device time by kernel group (the port's kernels, int8 and
float matrix products, convolutions, the rest), each group's top
kernels by name. ``--train`` profiles `ITERS` stage-2 training steps
instead (`train.tasks.LifterTask` with the egotap_unrealego preset: bf16
amp, AdamW, batch 32, seeded `init_state`), and adds the device time of
the backward recompute of kernels B and C (their profiler ranges). Needs
a CUDA card; it does not fall back to the CPU.
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


def range_kernels_ms(evt, ranges=()) -> float:
    """Device time of the kernels launched inside the profiler range (or
    op) ``evt`` and its children, in ms. A `record_function` range also
    shows on the device as an event of its own name spanning its
    kernels; that span is not a kernel and is not counted."""
    own = sum(k.duration for k in evt.kernels if k.name not in ranges)
    return own / 1e3 + sum(range_kernels_ms(c, ranges)
                           for c in evt.cpu_children)


def profile(step, what: str = "forward", ranges=()) -> None:
    """Profile ``ITERS`` calls of ``step`` after one warm-up; ``ranges``
    are profiler range names whose device time is reported per call."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    step()                                           # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    walls = []
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    by_name = collections.Counter()
    in_range = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if evt.name not in ranges:      # a range's span on the device
                by_name[evt.name] += evt.device_time_total / 1e3 / ITERS
        elif evt.name in ranges:
            in_range[evt.name] += range_kernels_ms(evt, ranges) / ITERS
    device_ms = sum(by_name.values())
    wall_ms = 1e3 * statistics.median(walls)
    print(f"  wall {wall_ms:.3f} ms per {what} (median of {ITERS}; under "
          f"the profiler), device kernels {device_ms:.3f} ms, idle share "
          f"{1 - device_ms / wall_ms:.3f}")
    for name in ranges:
        print(f"  {name}: {in_range[name]:.3f} ms of device time per {what}")
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


def profile_train(rgb, card) -> None:
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.ops import attention, pu_kernel
    from egotap_tpu_torch.train.tasks import LifterTask
    cfg = Config.from_preset("egotap_unrealego", batch_size=BATCH)
    task = LifterTask(cfg, device="cuda")
    state = task.init_state(seed=0, iters_per_epoch=1000)
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = {"input_rgb": rgb,
             "gt_local_pose": torch.randn(BATCH, 16, 3, generator=g,
                                          device="cuda")}
    print(f"training step, batch {BATCH}, bf16 amp, AdamW [{card}]")
    profile(lambda: task.train_step(state, batch), "training step",
            (attention.BACKWARD_LABEL, pu_kernel.BACKWARD_LABEL))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--int8", action="store_true",
                        help="profile the calibrated int8 serving forward")
    parser.add_argument("--train", action="store_true",
                        help="profile the stage-2 training step")
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
    if args.train:
        profile_train(rgb, card)
        return 0
    modes = [("int8", True)] if args.int8 else [("bf16", True),
                                                 ("f32", False)]
    for label, bf16 in modes:
        print(f"{label} forward, batch {BATCH} [{card}]")
        pred = Predictor(bf16=bf16, int8=args.int8, device="cuda", seed=0)
        if args.int8:
            gc = torch.Generator(device="cuda").manual_seed(10)
            pred.calibrate([rgb + 0.1 * torch.randn(
                rgb.shape, generator=gc, device="cuda") for _ in range(2)])
        profile(lambda: pred._forward(rgb))
        del pred
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
