#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: check its whole paths, time
its kernels.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (it imports
``egotap_tpu_torch``; it imports nothing of JAX or ``egotap_tpu``).
Exits non-zero, printing no result, when there is no card. Phases:

1. Print the card's name and power limit; build every kernel from
   ``egotap_tpu_torch/csrc`` (one ``nvcc`` per source, all at once).
2. Each kernel beside its plain version on the card, at the serving
   forward's shapes, in f32 and bf16, for the kernel table (`PERF.md`
   section 6): the max and rms error relative to the plain output, each
   within the kernel module's ``TOL`` (tests/test_torch_kernels_cuda.py
   also rejects faulty controls and reads each kernel's resources);
   median CUDA-event times of the kernel, its plain version and a
   one-call PyTorch yardstick where one exists (never used by the
   port); for A, C, D and E the device time of a launch alone
   (torch.profiler; a trace that dropped most launches is taken again,
   up to 3 in all), for C also of its walk with its grid barriers alone,
   its latency floor; each kernel's bound at the card's peaks
   (`benchmark/peaks.json`; A, and B and C in bf16, by
   `benchmark/bounds.py`, the bounds the benchmark's roofline divides
   by). Kernels: A upsample, B
   packed attention and B on the unpacked layout, C PU chain, D fused
   int8 layer1 (also timed against the unfused int8 layer1 it
   replaces), E eval BatchNorm + residual + ReLU at resnet50's layer1
   shapes (its device time held within 1.5 times its byte bound), F's
   pack and epilogue at each int8 product of the r18 int8 serving
   forward in bf16, beside their plain twins, summed over a request
   (their device time held within 2.5 times their byte bound).
3. Full path: a full-width `Predictor` (UnrealEgo, resnet18, Grid-ViT
   width 1024 x 3 layers, PU hidden 512) with seeded random weights
   serves 3 requests of (32, 2, 256, 256, 3) in bf16, in f32 and in the
   int8 serving configuration (bf16 compute, int8 heatmap nets and
   lifter, static scales calibrated on 2 batches of rgb + 0.1 noise);
   the launch counters must rise by exactly 6 (upsample), 3 (attention)
   and 1 (PU chain) per forward, and kernel E's by 34 (bf16, f32) or 2
   (int8: the stems' BatchNorms), F's by 72 packs and 78 epilogues
   (int8); batch-2 f32 requests are cross-checked
   against the same port on the CPU (the int8 one under the card's
   static scales, free-running and with the card's int8 codes held
   against the CPU's and replaced by them, `CodeTape`, which runs the
   card's int8 products as the plain sequence), the bf16 poses
   against the f32 ones and the int8 poses against the bf16 ones.
4. Entry points off the Predictor's path: the int8 ResNet encoder with
   the fused layer1 (kernel D once per forward, E once: the stem, F 13
   times: layer2-4's convs of 128 channels or more, dynamic scales) on
   (64, 256, 256, 3)
   bf16 against the unfused int8 encoder, and one call of the unpacked
   attention wrapper at the Grid-ViT's (32, 8, 576, 128) in bf16 and
   in f32, within ``TOL`` of its plain version.
5. Stage-2 training at full width (`bench.py` train: the egotap_unrealego
   preset, UnrealEgo, resnet18 frozen nets, Grid-ViT 1024 x 3 layers x 8
   heads over 576 tokens, PU hidden 512, bf16 amp, AdamW under
   cos_anneal_warmup, batch 32): `LifterTask.train_step` 12 times from a
   seeded `init_state` on N(0, 1) rgb and poses; the median CUDA-event
   time of the last 10 and pairs/s; losses finite, lifter parameters
   moved (the ViT's query weights and the PU chain's top cell, reachable
   only through the backward of B and C), the frozen nets' parameters
   unchanged bit for bit and their running statistics moved, launches
   per step A 6, B 3, C 1, D 0, E 0 (train-mode BatchNorm) and C's
   backward 1; B's backward
   recompute and C's backward kernel timed, C's gradients first each
   within `pu_kernel.GRAD_TOL` of the plain recompute (C's also by the host clock,
   its reverse walk on the device, beside its bound, latency floor and
   the plain recompute it replaced) and inside one profiled step. Then
   one f32 step of batch 2 on the card against the same step on the CPU
   (losses, and the lifter's flattened gradient by relative L2), and the
   same check rejecting a faulty control (B's output detached from the
   graph).
6. The eval step of the serving configuration (bf16, int8 heatmap nets
   and lifter calibrated by `prepare_inference` on 2 batches of rgb + 0.1
   noise, batch 32): launches as the int8 forward, its pose equal bit for bit
   to a `Predictor` with the same weights and scales, mpjpe / pa_mpjpe
   within 1e-4 of float64 numpy (norms, SVD Procrustes with the
   reflection fix), the median time of 10 steps.
7. Stage-1 training at full width (`bench.py` train1: the
   unrealego_heatmap_joint and unrealego_heatmap_limb presets, resnet18,
   256 x 256 stereo, 64 x 64 maps, bf16 amp, stage-1 Adam, batch 16):
   a raw batch drawn with numpy (joints out of view, a zero-length bone),
   its targets rendered on the card by `make_device_preprocess` and held
   to the CPU's; `HeatmapTask.train_step` 12 times on that fixed batch
   from a seeded `init_state`: the median CUDA-event time of the last 10
   and pairs/s, kernel A's 3 launches a step and its 3 backward
   recomputes (profiler ranges), every trained parameter and running
   statistic moved, the loss at steps 1 and 12 (finite, falling). For the
   joint preset the f32 eval step of the trained state against the CPU's
   (mse_heatmap; A 3 and E 17 launches); kernel A's backward recompute a launch by events; one
   f32 step of batch 2 on the card against the CPU (losses, the UNet's
   gradient by relative L2) and the same check rejecting A's output
   detached from the graph.
8. The train and test CLIs end to end at full width, each through its
   `main` as a user calls it (no device argument: the card): a synthetic
   UnrealEgo dataset (`data/synthetic.py`, 2 sequences x 32 frames a
   split, 256 x 256 RGB, 64 x 64 maps) in a temporary directory; then
   `cli.train` with the unrealego_heatmap_joint and unrealego_heatmap_limb
   presets (batch 16, 4 steps an epoch), the egotap_unrealego preset
   (batch 32, 2 steps an epoch) warm-started from both ``ckpt_best``
   through the preset's own path_to_trained_heatmap, each for 2 epochs
   (``--niter 1 --niter_decay 1``), and `cli.test` on the stage-2 run.
   Checks: every run returns; its artifacts (train_opt.txt, the summary,
   ckpt_best and ckpt_2 but no ckpt_1, test_result.txt with categories
   001 and 002; detail_result.txt with 64 rows, categorical_result.txt,
   pred_pose.npy of (64, 16, 3)); the launches of A, B and C, one set a
   training step or eval batch, and E's, 17 (stage 1) or 34 (stage 2)
   an eval batch and none a training step; every tensor of each final state on the
   card; the stage-2 state right after `_init_task_state` equal to both
   stage-1 ``ckpt_best`` bit for bit (a copy with one element changed
   caught), and its frozen parameters still equal after training;
   ``ckpt_best`` in a fresh f32 template giving pred_pose.npy's rows on
   the test split's first batch within 1e-6 of their max (one tensor
   perturbed rejected). Printed: each run's wall time; each epoch's time
   and its parts from the run's summary (the step loop, its time waiting
   on the loader as a share of the loop and of the epoch, validation, the
   checkpoint writes); `evaluate`'s pairs/s in `cli.test`.
9. The lifter's other skeleton layers and the learned-LR optimizers at
   full width. (a) A bf16 `Predictor` with skel_layer "LSTM" (the
   Config default: a tree walk, no kernel C) serves 3 requests of (32,
   2, 256, 256, 3), launches A 6, B 3, C 0, E 34 a forward; then the lifter
   alone, on that Predictor's bf16 heatmap stack, for each of LSTM,
   LSTMSplit, LSTMNoRel, None, NoneNoRel, the PU tree walk and a 3-layer
   PU chain (both walked in plain PyTorch): the median time of 5 bf16
   forwards at batch 32 with B 3, C 0 launches each, and an f32 pose of
   batch 2 card vs CPU within 1e-4 of its max; the LSTM walked as a
   chain (each joint from the previous joint's state) must fall outside
   that limit. (b) `LifterTask.train_step` with the LSTM lifter (the
   egotap_unrealego preset otherwise: bf16 amp, cos_anneal_warmup over
   epochs of 4 steps, batch 32) under DAdam, Prodigy, DSGD and
   DAdaGrad, 12 steps on one fixed batch from a seeded `init_state`:
   the median CUDA-event time of the last 10 and pairs/s, launches A 6,
   B 3, C 0 a step, losses finite, the LSTM's weight_hh_l1 moved, the
   estimate d of each step and the step's own estimate d_hat, of which
   d must end above its initial 1e-6 or d_hat rise over the run; then
   one f32 Prodigy step of batch 2 ('lambda' schedule,
   so that it moves the parameters) card vs CPU: losses (rtol 1e-4),
   the lifter's gradient (1e-3 relative L2), the parameters after the
   update (1e-5 of their max). (c) `cli.train --preset egotap_unrealego
   --skel_layer LSTM --optimizer_type DAdam` (1 epoch) on phase 8's
   dataset, warm-started from phase 8's stage-1 ckpt_best (the preset's
   lr 0 at step 0 is DAdam's zero-denominator step), then `cli.test`:
   launches A 6, B 3, C 0 a step or eval batch and E 34 an eval batch,
   finite epoch losses,
   the run's artifacts, DAdam's state in ckpt_best, and ckpt_best in a
   fresh f32 template giving pred_pose.npy's rows within 1e-6 of their
   max (one tensor perturbed rejected).
10. Bridges for a trained model and parallelism at full width (the
   egotap_unrealego preset; every rank and shard on the one card, so a
   check of what runs, not a speed for several cards). (a) 2 bf16
   stage-2 steps of batch 32 saved as ckpt_best: `Predictor.
   from_checkpoint` bit for bit `LifterTask.eval_step`'s pose; the
   reference .pth export (timed) through `from_reference_checkpoints`
   bit for bit the same; a torch AdamW over the lifter stepped twice
   under a LambdaLR of the port's schedule, saved and resumed by the
   port (moments bit for bit torch's, one more f32 step within 1e-4 of
   torch's, the moments one position late rejected);
   `load_partial_weights(parts=["pos_heatmap_encoder"])` loads exactly
   those keys. (b) The bf16 step through one NCCL rank bit for bit the
   single-process step (then both timed); `python -m
   egotap_tpu_torch.parallel.dryrun` with two gloo ranks sharing cuda:0
   for an f32 stage-2 step (16 rows a rank) and an f32 stage-1 step (8
   rows a rank) against one process at the global batch (losses rtol
   1e-4, gradients 1e-3 rel-L2, running statistics 1e-4, the ranks bit
   for bit equal), each with the per-rank-statistics control rejected;
   two ranks of `cli.train` (one epoch) and `cli.test` on phase 8's
   dataset: one set of files, test means within 1e-6 of a 1-rank
   `cli.test`. (c) Kernel B at a shard's (16, 576, 512) with 4 heads
   within ``TOL`` of its plain version, timed; `Predictor.shard(2, num_model=2,
   devices=[cuda:0] * 4)` in f32, bf16 and calibrated int8 at batch 32
   and a ragged 31 against the same predictor unsharded (1e-5, and
   phase 3's bf16 and int8 budgets), launches a forward A 12, B 12, C 2,
   E 68 (int8: 4, and F 156 packs and 180 epilogues: the split Grid-ViT's
   products run on F as the unsplit ones do, `parallel/tp.py`);
   the bf16 forward's time unsharded and over 1 x 2 and 2 x 2 shards.
   Each part's wall time.
11. The Bottleneck nets and the fused net at full width. (a) resnet50
   `Predictor`s (Grid-ViT 1024 x 3 x 8 heads, PU hidden 512, seeded
   weights) serve 3 requests of (32, 2, 256, 256, 3) in bf16, f32 and
   calibrated int8, launches A 6, B 3, C 1, D 0, E 98 a forward (int8:
   F 138 packs and 144 epilogues; a resnet101 forward E 200); bf16 vs f32
   and int8 vs bf16 within phase 3's limits; the f32 heatmap stack at
   batch 1 on 128 x 128 images against the same nets on the CPU (1e-4 of
   max); a resnet101 bf16 `Predictor` likewise (3 requests). (b)
   `HeatmapTask.train_step` with the unrealego_heatmap_joint preset and a
   resnet50 net, as in phase 7 (12 bf16 steps of batch 16 on a fixed
   batch: the median of the last 10, pairs/s, A 3 launches and 3
   backward recomputes a step, every parameter and running statistic
   moved, a falling loss), then one f32 step of batch 2 on 128 x 128
   images card vs CPU with its control. (c) `FusedHeatmapUNet` built by
   `fuse_heatmap_variables` from phase 3's two resnet18 nets at (32, 2,
   256, 256, 3): f32 within 2e-4 of the separate nets, bf16 within 2e-2
   of max, A 3 and E 17 launches a forward, fused and separate forwards
   timed.
   (d) Kernel A beside its plain version at the resnet50 decoder's
   shapes (32, 8, 8, 4096), (32, 16, 16, 4096), (32, 32, 32, 2048), as in
   phase 2, in a process of its own, run first (after phase 10 this
   process's profiler dropped most of A's launches). (e) `ConvHeatmapEncoder`, `HeatmapDecoder` and the S2D-stem
   resnet18 encoder, f32 card vs CPU (1e-4 of max); the S2D stem vs the
   plain stem of the same weight on the card (1e-5 of max), both timed.
   Each part's wall time.
12. One JSON line with every kernel's numbers (F's two entry points
   summed over a request, launches those of phase 3's int8 forwards;
   each bf16 kernel's
   launches per training and eval step, A's per stage-1 step, the
   backward recompute time a launch of A (stage 1) and B, E's launches
   in the resnet18 and resnet50 serving forwards, C's backward
   kernel's times, bound and launches a training step, the
   launches of A, B and C in each CLI run of phase 8, each bf16
   kernel's launches per LSTM training step and in the LSTM CLI runs of
   phase 9, and each kernel's launches in phase 10's data-parallel step
   (the bf16 rows: the one NCCL rank's; the f32 rows: gloo rank 0's
   stage-2 step) and in its sharded forward, with a row for B at 4
   heads and B's launches counted by head count, and a row for A at the
   resnet50 decoder's widths with its launches in phase 11's resnet50
   forwards, resnet101 forward, stage-1 step and fused forward), then the
   result line.
"""

import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ITERS = 20
BF16_POSE_TOL = 5e-2               # bf16 vs f32 pose, relative to max|f32|
# int8 (static scales) vs bf16 pose of the same weights, relative to
# max|bf16|: int8 rounds every activation and weight of both stages to
# 1/127 of its scale, and a flipped code cascades through the lifter (on
# the CPU a 1e-7 change of the input moves the int8 lifter's pose by
# 2.5% of its max, tests/test_torch_quant.py). An H100 read 2.9e-2; the
# limit is about 3 times that
INT8_POSE_TOL = 1e-1
# the int8 f32 forward on the card vs on the CPU under the same static
# scales, relative to max|cpu|: the f32 float paths differ in summation
# order (1e-7), which flips a few int8 codes, cascading as above. An
# H100 read 2.5e-2; the limit is 4 times that
INT8_CPU_TOL = 1e-1
# the same two forwards with the card's int8 codes held against the
# CPU's and replaced by them (`CodeTape`), so that flips cannot cascade:
# at most FLIP_RATE of one call's codes one step off, and the heatmap
# stacks and poses within FORCED_TOL of their max. An H100 read 52 of
# 128M codes off (4e-7), the heatmap stacks equal and the pose 5.5e-7
# of its max: what is left is f32 summation order. FORCED_TOL is about
# 20 times that reading; FLIP_RATE leaves room for a small call's share
FLIP_RATE, FORCED_TOL = 1e-2, 1e-5
# fused vs unfused int8 encoder, rel-L2 per layer: the JAX package's own
# bound (tests/test_fused_layer1.py:132)
FUSED_ENCODER_TOL = 0.06


def time_ms(torch, fn, iters=ITERS, warmup=3):
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


DEVICE_TRACES = 3


def device_ms(torch, fn, kernel, iters=ITERS):
    """Median device time of one launch of the kernel whose name holds
    ``kernel``, one launch a call of ``fn``, under torch.profiler: the
    kernel alone, without its wrapper's host time and small allocations
    (a short kernel's CUDA-event time is its host time when the host is
    the slower side). A trace that dropped most launches is taken again,
    up to `DEVICE_TRACES` traces in all."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(DEVICE_TRACES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        times = [evt.device_time_total / 1e3 for evt in prof.events()
                 if evt.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in evt.name]
        # the trace may drop events (an H100 once showed 18 of 20
        # launches, and 5 of 20 of kernel E's 0.05-ms launches); more
        # than asked for means another kernel matched
        if iters // 2 <= len(times) <= iters:
            return statistics.median(times)
        print(f"    the profiler saw {len(times)} launches of {kernel}, "
              f"not {iters} (trace {attempt + 1} of {DEVICE_TRACES})")
    raise AssertionError(f"the profiler saw {len(times)} launches of "
                         f"{kernel}, not {iters}")


def reading(name, got, ref, tol):
    """A kernel's output against its plain version, the kernel table's
    reads column: the max error, and the max and rms error relative to
    the plain output, each held to its limit in ``tol`` (the kernel
    module's ``TOL``). Raises when either is outside it."""
    from egotap_tpu_torch.ops import kernel_errors
    max_abs, max_rel, rms_rel = kernel_errors(got, ref)
    ok = max_rel <= tol[0] and rms_rel <= tol[1]     # False when not finite
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(tol {tol[0]:.0e}) rms_rel_err={rms_rel:.3e} (tol {tol[1]:.0e})"
          f"{'' if ok else '  FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: outside its module's TOL")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel,
            "rms_rel_err": rms_rel}


def yardstick(torch, fn, ref):
    """Print which kernels a library call runs and how close its output
    comes to the plain version (no limit: the port never calls it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from egotap_tpu_torch.ops import kernel_errors
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = sorted({e.key for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA})
    _, max_rel, rms_rel = kernel_errors(out, ref)
    print(f"    yardstick runs {names}: max_rel_err={max_rel:.3e} "
          f"rms_rel_err={rms_rel:.3e}")


@functools.lru_cache(maxsize=None)
def card_peaks():
    """The card's published peaks: `benchmark/peaks.json`'s entry for its
    name (`benchmark.harness.peaks_for`), and the dense int8 peak
    (`benchmark.bounds_int8`) as ``int8_ops_per_s``."""
    import torch
    from benchmark.bounds_int8 import INT8_OPS_PER_S
    from benchmark.harness import peaks_for
    name = torch.cuda.get_device_name(0)
    peaks = peaks_for(name)
    if peaks is None:
        raise AssertionError(f"benchmark/peaks.json has no peaks for {name}")
    return dict(peaks, int8_ops_per_s=INT8_OPS_PER_S)


def shared_bound(fn, *args):
    """ms of the `benchmark.bounds` function ``fn`` at ``args`` and the
    card's peaks: the bound the benchmark's roofline divides by."""
    return 1e3 * fn(*args, card_peaks())


def own_bound(ops, peak, nbytes):
    """(ms, what bounds it) of work the benchmark does not bound: ``ops``
    operations at the card's ``peak`` against ``nbytes`` at its memory
    bandwidth."""
    peaks = card_peaks()
    t_ops, t_bytes = ops / peaks[peak], nbytes / peaks["hbm_bytes_per_s"]
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def attention_bound(torch, q):
    """(bound ms, bound_by) of one kernel B launch on (B, S, H*Dh): q, k,
    v read and the output written once against QK^T's and PV's
    operations. In bf16 the benchmark's bound; f32 runs 3xTF32, three
    TF32 products for each operation."""
    from benchmark import bounds
    ops = 4 * q.shape[0] * q.shape[1] ** 2 * q.shape[2]
    nbytes = 4 * q.numel() * q.element_size()
    if q.dtype == torch.float32:
        return own_bound(3 * ops, "tf32_flops_per_s", nbytes)
    _, by = own_bound(ops, "bf16_flops_per_s", nbytes)
    return shared_bound(bounds.attention_bound, *q.shape,
                        q.element_size()), by


def pu_chain_bound(torch, b, joints, hidden, dt):
    """(bound ms, bound_by) of one kernel C launch: 13 hidden^2 products
    a joint and row against its weights in ``dt`` and its f32 gates,
    output and biases, each moved once. In bf16 the benchmark's bound;
    f32 runs its products on the CUDA cores."""
    from benchmark import bounds
    h, rows = hidden, b * joints
    ops = 2 * rows * 13 * h * h
    nbytes = 13 * h * h * dt.itemsize + 4 * (6 * rows * h + 9 * h)
    if dt == torch.float32:
        return own_bound(ops, "f32_flops_per_s", nbytes)
    _, by = own_bound(ops, "bf16_flops_per_s", nbytes)
    return shared_bound(bounds.pu_chain_bound, b, joints, hidden,
                        dt.itemsize), by


# kernel A's three calls a net at batch 32: the resnet18 decoder's, and
# the resnet50/101 decoder's (fs = 4 x 2 views: 4096, 4096, 2048 channels)
RESNET18_SHAPES = [(32, 8, 8, 1024), (32, 16, 16, 1024), (32, 32, 32, 512)]
RESNET50_SHAPES = [(32, 8, 8, 4096), (32, 16, 16, 4096), (32, 32, 32, 2048)]


def worst(tot, reads):
    """Fold a shape's readings into a row's: the largest of each."""
    for k, v in reads.items():
        tot[k] = max(tot.get(k, 0.0), v)


def upsample_rows(torch, F, card, key, shapes, g):
    """Kernel A beside its plain version at ``shapes`` in f32 and bf16
    (readings, times, the device time of a launch, the bound,
    F.interpolate); rows {(key, dtype): sums over the shapes, the worst
    readings}."""
    from benchmark.bounds import upsample_bound
    from egotap_tpu_torch.ops.upsample import (TOL, upsample2x_align_corners,
                                               upsample2x_plain)
    dev = torch.device("cuda")
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "device_ms": 0.0}
        for shp in shapes:
            x = torch.randn(shp, generator=g, device=dev).to(dt)
            worst(tot, reading(f"upsample {dt} {shp}",
                               upsample2x_align_corners(x),
                               upsample2x_plain(x), TOL[dt]))
            nchw = x.permute(0, 3, 1, 2)
            ms = time_ms(torch, lambda: upsample2x_align_corners(x))
            dms = device_ms(torch, lambda: upsample2x_align_corners(x),
                            "upsample2x_kernel")
            pms = time_ms(torch, lambda: upsample2x_plain(x))
            lms = time_ms(torch, lambda: F.interpolate(
                nchw, scale_factor=2, mode="bilinear", align_corners=True))
            bound = shared_bound(upsample_bound, shp, x.element_size())
            print(f"    {shp}: kernel {ms:.4f} ms (its launch alone on the "
                  f"device {dms:.4f} ms), plain {pms:.4f} ms, F.interpolate "
                  f"{lms:.4f} ms, bound {bound:.4f} ms [{card}]")
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", bound), ("device_ms", dms)):
                tot[k] += v
        # 5 bytes of each element's type moved for its 24 operations
        rows[(key, dt)] = dict(tot, bound_by="bytes")
    return rows


# kernel E at resnet50's layer1 for one net (64 images): a bottleneck's
# last conv (256 channels, plus the block input, ReLU) and its inner
# convs (64 channels, ReLU); its device time must stay within
# BN_ACT_BOUND_RATIO times its byte bound
BN_ACT_SHAPES = (((64, 64, 64, 256), True), ((64, 64, 64, 64), False))
BN_ACT_BOUND_RATIO = 1.5


def bn_act_rows(torch, card, g):
    """Kernel E beside the plain sequence at `BN_ACT_SHAPES` in f32 and
    bf16 (readings, times, the device time of a launch against its bytes
    bound); rows {("bn_act", dtype): sums over the shapes, the worst
    readings}."""
    from egotap_tpu_torch.ops import bn_act as E
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "device_ms": 0.0}
        for shp, residual in BN_ACT_SHAPES:
            c = shp[-1]
            bn = torch.nn.BatchNorm2d(c, eps=E.BN_EPS).cuda().eval()
            bn.requires_grad_(False)
            with torch.no_grad():
                bn.running_mean.normal_(0.0, 0.5, generator=g)
                bn.running_var.uniform_(0.05, 4.0, generator=g)
                bn.weight.normal_(1.0, 0.3, generator=g)
                bn.bias.normal_(0.0, 0.5, generator=g)
            x = torch.randn(shp, generator=g, device="cuda").to(dt)
            r = torch.randn(shp, generator=g, device="cuda").to(dt) \
                if residual else None
            form = "+ block input, ReLU" if residual else "ReLU"
            worst(tot, reading(f"bn_act {dt} {shp} BatchNorm {form}",
                               E.bn_act(x, bn, r), E.bn_act_plain(x, bn, r),
                               E.TOL[dt]))
            ms = time_ms(torch, lambda: E.bn_act(x, bn, r))
            dms = device_ms(torch, lambda: E.bn_act(x, bn, r),
                            "bn_act_kernel")
            pms = time_ms(torch, lambda: E.bn_act_plain(x, bn, r))
            nbytes = (3 if residual else 2) * x.numel() * x.element_size()
            bound = 1e3 * nbytes / card_peaks()["hbm_bytes_per_s"]
            print(f"    {shp}: kernel {ms:.4f} ms (its launch alone on the "
                  f"device {dms:.4f} ms, {dms / bound:.2f} x the bound), "
                  f"plain {pms:.4f} ms, bound {bound:.4f} ms (bytes: x"
                  f"{', the residual' if residual else ''} read once, the "
                  f"output written once) [{card}]")
            if not dms <= BN_ACT_BOUND_RATIO * bound:
                raise AssertionError(f"bn_act {dt} {shp}: its launch takes "
                                     f"{dms / bound:.2f} x its bound")
            for k, v in (("ms", ms), ("plain_ms", pms), ("bound_ms", bound),
                         ("device_ms", dms)):
                tot[k] += v
        rows[("bn_act", dt)] = dict(tot, library_ms=None, bound_by="bytes")
    return rows


# kernel F at every int8 product of the r18 int8 serving forward at batch
# 32 (bf16), its device time a request within INT8_PACK_BOUND_RATIO times
# its byte bound
INT8_PACK_BOUND_RATIO = 2.5


def int8_pack_rows(torch, card, g):
    """Kernel F beside its plain twins at `int8_products()` in bf16 (each
    entry point's readings, times and device time of a launch; the bound:
    the pack's rows written and x read once, the epilogue's int32 product
    read and its output written once); rows {("int8_pack", bf16),
    ("int8_epilogue", bf16)}: sums over a request, the worst readings."""
    from egotap_tpu_torch.ops import int8_pack as F8
    from egotap_tpu_torch.ops.quant import quantize_weights
    dt = torch.bfloat16
    hbm = card_peaks()["hbm_bytes_per_s"]
    tot = {key: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                 "device_ms": 0.0} for key in ("int8_pack", "int8_epilogue")}
    for (shape, kernel, stride, padding, n_out), (count, packs) \
            in int8_products().items():
        # a conv's input is a ReLU's output (half of it zeros), a dense
        # product's a LayerNorm's or a projection's
        x = 40 * torch.randn(shape, generator=g, device="cuda")
        x = (torch.relu(x) if shape[1:3] != (1, 1) else x).to(dt)
        a = torch.tensor(7.0, device="cuda")
        w_q, w_scale = quantize_weights(torch.randn(
            n_out, shape[-1] * kernel * kernel, generator=g, device="cuda"))
        bias = torch.randn(n_out, generator=g, device="cuda")
        rows, (ho, wo) = F8.pack(x, a, kernel, stride, padding)
        m = shape[0] * ho * wo
        acc = torch._int_mm(rows, F8.weight_rows(w_q).t())
        label = f"int8 {tuple(shape)} k{kernel} s{stride} N{n_out}"
        calls = {
            "int8_pack": (lambda: F8.pack(x, a, kernel, stride, padding),
                          lambda: F8.pack_plain(x, a, kernel, stride,
                                                padding),
                          "pack_kernel", packs,
                          rows.numel() + x.numel() * x.element_size()),
            "int8_epilogue": (
                lambda: F8.epilogue(acc, m, n_out, a, w_scale, bias, dt),
                lambda: F8.epilogue_plain(acc, m, n_out, a, w_scale, bias,
                                          dt),
                "epilogue_kernel", count,
                4 * acc.numel() + m * n_out * x.element_size())}
        parts = []
        for key, (fn, plain, kname, times, nbytes) in calls.items():
            got, want = fn(), plain()
            got, want = (got[0], want[0]) if key == "int8_pack" \
                else (got, want)
            worst(tot[key], reading(f"{key} {label}", got.float(),
                                    want.float(), F8.TOL[dt]))
            ms, pms = time_ms(torch, fn), time_ms(torch, plain)
            dms = device_ms(torch, fn, kname)
            bound = 1e3 * nbytes / hbm
            parts.append(f"{key} {ms:.4f} ms (device {dms:.4f} ms, "
                         f"{dms / bound:.2f} x the bound {bound:.4f}), "
                         f"plain {pms:.4f} ms")
            for k, v in (("ms", ms), ("plain_ms", pms), ("bound_ms", bound),
                         ("device_ms", dms)):
                tot[key][k] += times * v
        print(f"    {label} x {count}: {'; '.join(parts)} [{card}]")
    rows = {}
    for key, t in tot.items():
        print(f"  {key} a request: device {t['device_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms (bytes), plain {t['plain_ms']:.4f} ms "
              f"[{card}]")
        rows[(key, dt)] = dict(t, library_ms=None, bound_by="bytes")
    device = sum(t["device_ms"] for t in tot.values())
    bound = sum(t["bound_ms"] for t in tot.values())
    if not device <= INT8_PACK_BOUND_RATIO * bound:
        raise AssertionError(f"int8 pack and epilogue: {device:.4f} ms a "
                             f"request, {device / bound:.2f} x their bound")
    return rows


def phase_kernels(torch, F, card):
    from egotap_tpu_torch.models.layers import BN_EPS
    from egotap_tpu_torch.models.resnet import BasicBlock
    from egotap_tpu_torch.ops import attention, fused_layer1, pu_kernel
    from egotap_tpu_torch.ops.attention import (attention_packed_plain,
                                                multihead_attention,
                                                multihead_attention_packed)
    from egotap_tpu_torch.ops.fused_layer1 import (fused_layer1_int8,
                                                   fused_layer1_plain,
                                                   pack_blocks)
    from egotap_tpu_torch.ops.quant import (Calibrated, install_scales,
                                            prequantize, set_calibrating)
    from egotap_tpu_torch.serving import init_weights
    from egotap_tpu_torch.ops.pu_kernel import pu_chain_fused, pu_chain_plain
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    # ---- A: upsample at the decoder's three grids (one net's calls)
    rows.update(upsample_rows(torch, F, card, "upsample", RESNET18_SHAPES,
                              g))

    # ---- B: packed attention at the Grid-ViT's shape
    b, s, heads, hd = 32, 576, 8, 128
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(b, s, heads * hd, generator=g,
                               device=dev).to(dt) for _ in range(3))
        ref = attention_packed_plain(q, k, v, heads)
        reads = reading(f"attention {dt} {(b, s, heads * hd)}",
                        multihead_attention_packed(q, k, v, heads), ref,
                        attention.TOL[dt])
        split = [x.view(b, s, heads, hd).transpose(1, 2) for x in (q, k, v)]
        ms = time_ms(torch, lambda: multihead_attention_packed(q, k, v, heads))
        pms = time_ms(torch, lambda: attention_packed_plain(q, k, v, heads))
        lms = time_ms(torch, lambda: F.scaled_dot_product_attention(*split))
        if dt == torch.float32:
            yardstick(torch, lambda: F.scaled_dot_product_attention(*split)
                      .transpose(1, 2).reshape(q.shape), ref)
        bound, by = attention_bound(torch, q)
        print(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, SDPA {lms:.4f} ms, "
              f"bound {bound:.4f} ms [{card}]")
        rows[("attention", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
            bound_by=by, **reads)

    # ---- C: PU chain at the lifter's shape
    b, J, H = 32, 15, 512
    for dt in (torch.float32, torch.bfloat16):
        def u(*shape, bound=H ** -0.5):
            return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound
        fh = torch.sigmoid(torch.randn(b, J, H, generator=g, device=dev))
        gp = 0.5 * torch.randn(b, J, 4 * H, generator=g, device=dev)
        # (in, out) kernels as the lifter passes them: transposed views of
        # (out, in) Linear weights, which the kernel reads without a copy
        w0 = u(4 * H, H).to(dt).t()
        cell1 = {"x2f": {"kernel": u(H, H).to(dt).t(), "bias": u(H)},
                 "x2h": {"kernel": u(4 * H, H).to(dt).t(), "bias": u(4 * H)},
                 "h2h": {"kernel": u(4 * H, H).to(dt).t(), "bias": u(4 * H)}}
        reads = reading(f"pu_chain {dt} B={b} J={J} H={H}",
                        pu_chain_fused(fh, gp, w0, cell1),
                        pu_chain_plain(fh, gp, w0, cell1), pu_kernel.TOL[dt])
        ms = time_ms(torch, lambda: pu_chain_fused(fh, gp, w0, cell1))
        pms = time_ms(torch, lambda: pu_chain_plain(fh, gp, w0, cell1))
        dms = device_ms(torch, lambda: pu_chain_fused(fh, gp, w0, cell1),
                        "pu_chain_kernel")
        floor = device_ms(torch, lambda: pu_kernel.barrier_walk(b, J, H, dt,
                                                                dev),
                          "pu_chain_kernel")
        bound, by = pu_chain_bound(torch, b, J, H, dt)
        print(f"    kernel {ms:.4f} ms (its launch alone on the device "
              f"{dms:.4f} ms), plain {pms:.4f} ms, bound {bound:.4f} ms, "
              f"latency floor (the walk's {J + 1} grid barriers alone, on "
              f"the device) {floor:.4f} ms [{card}]")
        rows[("pu_chain", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=None, bound_ms=bound,
            device_ms=dms, latency_floor_ms=floor, bound_by=by, **reads)

    # ---- B on the unpacked (B, H, S, Dh) layout (`multihead_attention`)
    b, heads, s, hd = 32, 8, 576, 128
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(b, heads, s, hd, generator=g,
                               device=dev).to(dt) for _ in range(3))

        def plain_unpacked(q, k, v):
            flat = [x.reshape(b * heads, s, hd) for x in (q, k, v)]
            return attention_packed_plain(*flat, heads=1).reshape(q.shape)
        reads = reading(f"attention unpacked {dt} {(b, heads, s, hd)}",
                        multihead_attention(q, k, v), plain_unpacked(q, k, v),
                        attention.TOL[dt])
        ms = time_ms(torch, lambda: multihead_attention(q, k, v))
        pms = time_ms(torch, lambda: plain_unpacked(q, k, v))
        lms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        bound, by = attention_bound(torch, q.reshape(b * heads, s, hd))
        print(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, SDPA {lms:.4f} ms, "
              f"bound {bound:.4f} ms [{card}]")
        rows[("attention_unpacked", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
            bound_by=by, **reads)

    # ---- D: fused int8 layer1 at one net's shape (batch 32 x 2 views);
    # image i scaled by 1 + i/8, so that the per-image scales differ
    blocks = torch.nn.Sequential(BasicBlock(64, 64, quant=True),
                                 BasicBlock(64, 64, quant=True))
    init_weights(blocks, torch.Generator().manual_seed(2))
    blocks.to(dev).eval()
    wq, ws, bias = pack_blocks(blocks, BN_EPS)
    n, hw, c = 64, 64, 64
    ramp = 1 + torch.arange(n, device=dev)[:, None, None, None] / 8
    for dt in (torch.float32, torch.bfloat16):
        x = (torch.randn(n, hw, hw, c, generator=g, device=dev) * ramp).to(dt)
        reads = reading(f"fused_layer1 {dt} {tuple(x.shape)}",
                        fused_layer1_int8(x, wq, ws, bias),
                        fused_layer1_plain(x, wq, ws, bias),
                        fused_layer1.TOL[dt])
        # the path it replaces: the int8 BasicBlocks, with static scales
        # calibrated on this input, as the served encoder runs them
        set_calibrating([blocks], True)
        blocks(x)
        set_calibrating([blocks], False)
        install_scales([blocks])
        prequantize([blocks])
        ms = time_ms(torch, lambda: fused_layer1_int8(x, wq, ws, bias))
        dms = device_ms(torch, lambda: fused_layer1_int8(x, wq, ws, bias),
                        "layer1_kernel")
        pms = time_ms(torch, lambda: fused_layer1_plain(x, wq, ws, bias))
        ums = time_ms(torch, lambda: blocks(x))
        for m in blocks.modules():               # fresh scales per dtype
            if isinstance(m, Calibrated):
                m.a_scale = None
        bound, by = own_bound(
            2 * n * hw * hw * 9 * c * c * wq.shape[0], "int8_ops_per_s",
            2 * x.numel() * x.element_size() + wq.numel()
            + 4 * (ws.numel() + bias.numel()))
        print(f"    kernel {ms:.4f} ms (its launch alone on the device "
              f"{dms:.4f} ms), plain {pms:.4f} ms, unfused int8 layer1 "
              f"{ums:.4f} ms, bound {bound:.4f} ms [{card}]")
        rows[("fused_layer1", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=None, unfused_ms=ums,
            device_ms=dms, bound_ms=bound, bound_by=by, **reads)

    # ---- E: eval BatchNorm, residual add and ReLU at resnet50's layer1
    rows.update(bn_act_rows(torch, card, g))

    # ---- F: the passes around the int8 products of the int8 serving path
    rows.update(int8_pack_rows(torch, card, g))
    return rows


def reset_counts():
    from egotap_tpu_torch.ops import launch_counts
    launch_counts(reset=True)


def read_counts():
    """Each kernel wrapper's launches, by the name the JSON line gives
    it."""
    from egotap_tpu_torch.ops import launch_counts
    return launch_counts()


def read_head_counts():
    """Kernel B's launches through the packed wrapper, by head count."""
    from egotap_tpu_torch.ops import attention_launches_by_heads
    return attention_launches_by_heads()


# kernel E's launches per eval-mode forward of one resnet18 trunk: each
# BatchNorm (the stem's and two a basic block); an int8 trunk runs the
# stem's alone (its basic blocks fold theirs)
E_PER_NET = 17
E_PER_INT8_NET = 1


@functools.lru_cache(maxsize=None)
def int8_products(model_name="resnet18"):
    """The int8 products of one serving forward of the configuration with
    ``model_name`` at batch 32, read on the meta device
    (`tests/test_torch_kernel_launch.py:int8_serving_products`): {(x's
    NHWC shape, kernel, stride, padding, N): [products, packs]}."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:       # as pytest puts it there (no package)
        sys.path.insert(0, tests)
    from test_torch_kernel_launch import int8_serving_products
    return int8_serving_products(model_name=model_name)


def f_per_int8_forward(model_name="resnet18"):
    """Kernel F's launches per int8 serving forward: an epilogue a
    product, a pack a quantized input (the Grid-ViT's q, k and v share one
    `QuantStub`'s codes)."""
    counts = int8_products(model_name).values()
    return {"int8_pack": sum(packs for _, packs in counts),
            "int8_epilogue": sum(products for products, _ in counts)}


# launches per Predictor forward (the two resnet18 heatmap nets), in
# every precision but kernel E's and F's in int8 (`E_PER_INT8_NET` a net)
PER_FORWARD = {"upsample": 6, "attention": 3, "pu_chain": 1,
               "attention_unpacked": 0, "fused_layer1": 0,
               "pu_chain_backward": 0, "bn_act": 2 * E_PER_NET,
               "int8_pack": 0, "int8_epilogue": 0}


def per_int8_forward():
    return {**PER_FORWARD, "bn_act": 2 * E_PER_INT8_NET,
            **f_per_int8_forward()}


def serve(torch, pred, rgb_dev, label, card, requests=3,
          per_forward=PER_FORWARD):
    """Warm up, then serve ``requests`` batches with the launch counters
    zeroed just before; checks the counts (``per_forward`` a request) and
    the output. Returns (counts, last output)."""
    import numpy as np
    pred._forward(rgb_dev)                      # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    reset_counts()
    times = []
    for _ in range(requests):
        t0 = time.perf_counter()
        out = pred(rgb_dev)
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    print(f"  {label}: launches over {requests} forwards: {counts}")
    for n, c in counts.items():
        if c != requests * per_forward[n]:
            raise AssertionError(f"{label}: {n} launched {c} times, "
                                 f"expected {requests * per_forward[n]}")
    batch = rgb_dev.shape[0]
    if out.shape != (batch, 16, 3) or not np.isfinite(out).all():
        raise AssertionError(f"{label}: bad output {out.shape}")
    med = statistics.median(times)
    print(f"  {label}: forward median {1e3 * med:.3f} ms over {requests} "
          f"requests of batch {batch} = {batch / med:.2f} pairs/s [{card}]")
    return counts, out


class CodeTape:
    """The card's int8 forward held against the CPU's, code by code. In
    ``record`` mode the port's `quantize_activation` keeps every int8
    code array it makes (the CPU forward); in ``force`` mode it holds the
    card's codes at each call against the next kept ones (same shape, at
    most FLIP_RATE of them one step off) and goes on with the CPU's, so a
    code flipped by float sums in another order cannot cascade. While it
    runs, the card's int8 products are the plain sequence in kernel F's
    place (bit for bit the same, `tests/test_torch_kernels_cuda.py`), so
    that their codes pass through `quantize_activation`."""

    def __init__(self):
        from egotap_tpu_torch.ops import int8_pack, quant
        self.quant, self.real = quant, quant.quantize_activation
        self.int8_pack = int8_pack
        self.kernel_f = {n: getattr(int8_pack, n)
                         for n in ("conv", "dense", "quantize")}
        self.codes, self.used, self.flips, self.total = [], 0, 0, 0
        self.worst = 0.0                 # the largest share of one call

    def record(self, x, a_scale=None):
        xq, scale = self.real(x, a_scale)
        self.codes.append(xq.clone())
        return xq, scale

    def force(self, x, a_scale=None):
        xq, scale = self.real(x, a_scale)
        want = self.codes[self.used].to(xq.device)
        self.used += 1
        if xq.shape != want.shape:
            raise AssertionError(f"int8 call {self.used}: shape {xq.shape}, "
                                 f"the CPU's {want.shape}")
        diff = (xq.int() - want.int()).abs()
        flips = int((diff > 0).sum())
        self.flips += flips
        self.total += diff.numel()
        self.worst = max(self.worst, flips / diff.numel())
        if int(diff.max()) > 1 or flips > FLIP_RATE * diff.numel():
            raise AssertionError(f"int8 call {self.used}: {flips} of "
                                 f"{diff.numel()} codes differ, by up to "
                                 f"{int(diff.max())}")
        return want, scale

    def plain(self, name):
        """The plain sequence for kernel F's entry ``name``, calling
        `quantize_activation` as it stands."""
        q = self.quant
        return {"conv": lambda x, wq, w_scale, stride, padding, bias, a_scale,
                w_rows: q.conv_plain(x, wq, w_scale, stride, padding, bias,
                                     a_scale),
                "dense": lambda x, wq, w_scale, bias, a_scale, pre_q, w_rows:
                q.dense_plain(x, wq, w_scale, bias, a_scale, pre_q),
                "quantize": lambda x, a_scale: q.quantize_activation(
                    x, a_scale)}[name]

    def run(self, mode, fn, *args):
        self.quant.quantize_activation = getattr(self, mode)
        for name in self.kernel_f:
            setattr(self.int8_pack, name, self.plain(name))
        try:
            return fn(*args)
        finally:
            self.quant.quantize_activation = self.real
            for name, entry in self.kernel_f.items():
                setattr(self.int8_pack, name, entry)


def max_dev(got, ref):
    import numpy as np
    return float(np.abs(got - ref).max()), float(np.abs(ref).max())


def phase_full_path(torch, card):
    from egotap_tpu_torch.ops.quant import Calibrated
    from egotap_tpu_torch.serving import Predictor

    g = torch.Generator().manual_seed(1)
    rgb = torch.randn(32, 2, 256, 256, 3, generator=g)
    rgb_dev = rgb.cuda()
    launches, outputs = {}, {}
    for bf16 in (True, False):
        label = "bf16" if bf16 else "f32"
        t0 = time.perf_counter()
        pred = Predictor(bf16=bf16, device="cuda", seed=0)
        torch.cuda.synchronize()
        print(f"  {label}: Predictor built in {time.perf_counter() - t0:.2f} s")
        launches[label], outputs[label] = serve(torch, pred, rgb_dev, label,
                                                card)
        if not bf16:
            cpu = Predictor(bf16=False, device="cpu", seed=0)
            err, scale = max_dev(pred(rgb_dev[:2]), cpu(rgb[:2]))
            # f32 on both sides (TF32 off): only summation order differs
            print(f"  f32 card vs CPU, batch 2: max_abs_err={err:.3e} "
                  f"(tol 1e-4, max|cpu|={scale:.3e})")
            if err > 1e-4:
                raise AssertionError("card and CPU forwards disagree")
        del pred
        torch.cuda.empty_cache()
    dev, scale = max_dev(outputs["bf16"], outputs["f32"])
    # bf16 rounds every conv and matrix operand: the gap is a few bf16
    # ulps of the pose, not a kernel's flip of one rounding
    print(f"  bf16 vs f32 pose on the card: max_abs_dev={dev:.3e} "
          f"(tol {BF16_POSE_TOL:.0e} x max|f32|={scale:.3e})")
    if dev > BF16_POSE_TOL * scale:
        raise AssertionError("bf16 and f32 forwards disagree")

    # ---- the int8 serving configuration (bench.py:115-150)
    gc = torch.Generator(device="cuda").manual_seed(10)
    calib = [rgb_dev + 0.1 * torch.randn(rgb_dev.shape, generator=gc,
                                         device="cuda") for _ in range(2)]
    t0 = time.perf_counter()
    pred = Predictor(bf16=True, int8=True, device="cuda", seed=0)
    pred.calibrate(calib)
    torch.cuda.synchronize()
    print(f"  int8: Predictor built and calibrated in "
          f"{time.perf_counter() - t0:.2f} s, static scales: "
          f"{pred._has_static_scales()}")
    launches["int8"], outputs["int8"] = serve(
        torch, pred, rgb_dev, "int8", card, per_forward=per_int8_forward())
    del pred
    dev, scale = max_dev(outputs["int8"], outputs["bf16"])
    print(f"  int8 vs bf16 pose on the card: max_abs_dev={dev:.3e} "
          f"(tol {INT8_POSE_TOL:.0e} x max|bf16|={scale:.3e})")
    if dev > INT8_POSE_TOL * scale:
        raise AssertionError("int8 and bf16 forwards disagree")
    # int8 in f32, batch 2: the card against the CPU under the same scales
    pred = Predictor(bf16=False, int8=True, device="cuda", seed=0)
    pred.calibrate([c[:2] for c in calib])
    cpu = Predictor(bf16=False, int8=True, device="cpu", seed=0)
    for net, cpu_net in zip(pred.nets, cpu.nets):
        cpu_mods = dict(cpu_net.named_modules())
        for name, m in net.named_modules():
            if isinstance(m, Calibrated) and m.a_scale is not None:
                cpu_mods[name].a_scale = m.a_scale.cpu()
    err, scale = max_dev(pred(rgb_dev[:2]), cpu(rgb[:2]))
    print(f"  int8 f32 card vs CPU, batch 2, same static scales: "
          f"max_abs_err={err:.3e} (tol {INT8_CPU_TOL:.0e} x "
          f"max|cpu|={scale:.3e})")
    if err > INT8_CPU_TOL * scale:
        raise AssertionError("int8 card and CPU forwards disagree")
    tape = CodeTape()
    ref = [tape.run("record", f, rgb[:2]) for f in (cpu.heatmaps, cpu)]
    got = [tape.run("force", f, rgb_dev[:2]) for f in (pred.heatmaps, pred)]
    if tape.used != len(tape.codes):
        raise AssertionError(f"card made {tape.used} int8 calls, the CPU "
                             f"{len(tape.codes)}")
    print(f"  int8 f32 card vs CPU, codes held to the CPU's: {tape.flips} "
          f"of {tape.total} codes one step off in {tape.used} calls, at "
          f"most {tape.worst:.3e} of one call's (tol {FLIP_RATE:.0e})")
    for name, g, r in zip(("heatmap stack", "pose"), got, ref):
        err, scale = max_dev(g, r)
        print(f"    {name}: max_abs_err={err:.3e} (tol {FORCED_TOL:.0e} x "
              f"max|cpu|={scale:.3e})")
        if err > FORCED_TOL * scale:
            raise AssertionError(f"int8 card and CPU {name}s disagree")
    del pred
    torch.cuda.empty_cache()
    return launches


# kernel F's packs (and epilogues) a forward of the fused-layer1 int8
# encoder without static scales: layer2's conv2s and its second block's
# conv1, and every conv of layer3 and layer4 (128 input channels or more)
F_FUSED_ENCODER = 13


def phase_entry_points(torch, card):
    """The encoder with the fused int8 layer1, and the unpacked attention
    wrapper, each through its own entry point."""
    from egotap_tpu_torch.models.resnet import ResNetEncoder
    from egotap_tpu_torch.ops.attention import (TOL, attention_packed_plain,
                                                multihead_attention)
    from egotap_tpu_torch.ops.quant import prequantize
    from egotap_tpu_torch.serving import init_weights

    fused = ResNetEncoder("resnet18", quant=True, fused_layer1=True)
    init_weights(fused, torch.Generator().manual_seed(3))
    unfused = ResNetEncoder("resnet18", quant=True)
    unfused.load_state_dict(fused.state_dict())
    encs = [e.eval().cuda() for e in (fused, unfused)]
    prequantize(encs)
    x = torch.randn(64, 256, 256, 3, generator=torch.Generator().manual_seed(4)
                    ).cuda().bfloat16()
    fused(x)                                      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    got = fused(x)
    counts = read_counts()
    ref = unfused(x)
    print(f"  fused-layer1 encoder, one forward of {tuple(x.shape)} bf16: "
          f"launches {counts}")
    if counts != dict(PER_FORWARD, fused_layer1=1, upsample=0, attention=0,
                      pu_chain=0, bn_act=E_PER_INT8_NET,
                      int8_pack=F_FUSED_ENCODER,
                      int8_epilogue=F_FUSED_ENCODER):
        raise AssertionError("the fused encoder must launch kernel D once, "
                             "E once (the stem), F's pack and epilogue once "
                             "a conv of layer2-4 with 128 channels or more, "
                             "and nothing else")
    for i in range(2, 6):
        a, b = got[i].float(), ref[i].float()
        rel = float((a - b).norm() / b.norm())
        print(f"    layer{i - 1} fused vs unfused int8: rel-L2 {rel:.3e} "
              f"(tol {FUSED_ENCODER_TOL})")
        if not rel < FUSED_ENCODER_TOL:
            raise AssertionError("fused and unfused encoders disagree")
    fms = time_ms(torch, lambda: fused(x), iters=5)
    ums = time_ms(torch, lambda: unfused(x), iters=5)
    print(f"    encoder forward: fused {fms:.3f} ms, unfused {ums:.3f} ms "
          f"[{card}]")
    enc_counts = counts
    del fused, unfused, encs
    torch.cuda.empty_cache()

    # the unpacked wrapper, one call at the Grid-ViT's shape in each dtype
    g = torch.Generator(device="cuda").manual_seed(5)
    unpacked = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(32, 8, 576, 128, generator=g, device="cuda"
                               ).to(dt) for _ in range(3))
        reset_counts()
        got = multihead_attention(q, k, v)
        counts = read_counts()
        print(f"  unpacked attention, one call of {tuple(q.shape)} {dt}: "
              f"launches {counts}")
        if counts != dict(PER_FORWARD, upsample=0, attention=0, pu_chain=0,
                          attention_unpacked=1, bn_act=0):
            raise AssertionError("the unpacked wrapper must launch kernel B "
                                 "once")
        flat = [x.reshape(256, 576, 128) for x in (q, k, v)]
        reading(f"unpacked attention output {dt}", got, attention_packed_plain(
            *flat, heads=1).reshape(got.shape), TOL[dt])
        unpacked[dt] = counts["attention_unpacked"]
    return enc_counts["fused_layer1"], unpacked


# stage-2 training (bench.py:200-210): the egotap_unrealego preset
TRAIN_ITERS_PER_EPOCH = 1000
TRAIN_STEPS = 12                   # the last TIMED_STEPS are timed
TIMED_STEPS = 10
# launches per training step: the frozen nets' decoders (A, 3 a net, no
# gradient), the Grid-ViT's 3 blocks (B) and the PU chain (C) forward;
# B's backward recomputes its plain version, C's is its reverse walk
# (the frozen nets run train-mode BatchNorm in a training step: no E)
PER_TRAIN_STEP = {"upsample": 6, "attention": 3, "pu_chain": 1,
                  "attention_unpacked": 0, "fused_layer1": 0,
                  "pu_chain_backward": 1, "bn_act": 0, "int8_pack": 0,
                  "int8_epilogue": 0}
# f32 step on the card vs on the CPU from the same weights and batch:
# losses within TRAIN_LOSS_RTOL (cos_sim, a sum of 15 bone cosines that
# cancels to near 0 at random weights, against its largest value), and
# the lifter's flattened gradient within TRAIN_GRAD_TOL relative L2
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
COS_SIM_SCALE = 0.01 * 0.1 * 15    # |lambda_cos_sim * lambda_mpjpe| x bones
EVAL_METRIC_RTOL = 1e-4            # eval metrics vs float64 numpy


def train_inputs(torch, gen, batch):
    return {"input_rgb": torch.randn(batch, 2, 256, 256, 3, generator=gen,
                                     device=gen.device),
            "gt_local_pose": torch.randn(batch, 16, 3, generator=gen,
                                         device=gen.device)}


def flat_grad(torch, grads, like):
    """The gradients of the parameters that have one in ``like``,
    flattened into one f32 vector on the host; a missing one is zero."""
    return torch.cat([(grads[n] if grads[n] is not None else
                       torch.zeros_like(g)).float().flatten().cpu()
                      for n, g in like.items() if g is not None])


def loss_gap(name, got, want):
    """|got - want| over the scale its rtol is taken against."""
    scale = COS_SIM_SCALE if name == "cos_sim" else abs(want)
    return abs(got - want) / scale


PU_LEAVES = ("fh", "gates_pre", "h2h0.kernel", "x2f.kernel", "x2f.bias",
             "x2h.kernel", "x2h.bias", "h2h.kernel", "h2h.bias")


def recompute_ms(torch, card):
    """Per launch, in bf16 and f32 at the training step's shapes: kernel
    B's backward recompute (`ops.plain_vjp` over the plain version) by
    CUDA events; kernel C's backward (its reverse-walk kernel and the
    weight products), each leaf's gradient first held within
    `pu_kernel.GRAD_TOL` of the plain recompute it replaced, then timed
    by the host clock around the call and by CUDA events, beside the
    whole backward's bound, and its
    reverse walk's launch alone on the device (`device_ms`) beside the
    walk's own bound and its latency floor (the walk's J + 1 barriers);
    and the plain recompute (`plain_vjp` over `pu_chain_plain`)."""
    from egotap_tpu_torch.ops import attention, plain_vjp, pu_kernel
    g = torch.Generator(device="cuda").manual_seed(21)
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q, k, v, ct = (torch.randn(32, 576, 1024, generator=g,
                                   device="cuda").to(dt) for _ in range(4))
        out[("attention", dt)] = time_ms(torch, lambda: plain_vjp(
            lambda q, k, v: attention.attention_packed_plain(q, k, v, 8),
            (q, k, v), (True,) * 3, ct, attention.BACKWARD_LABEL), iters=5)
        b, J, H = 32, 15, 512

        def u(*shape):
            return (torch.rand(shape, generator=g, device="cuda") * 2 - 1
                    ) * H ** -0.5
        saved = (torch.sigmoid(torch.randn(b, J, H, generator=g,
                                           device="cuda")),
                 0.5 * torch.randn(b, J, 4 * H, generator=g, device="cuda"),
                 u(4 * H, H).to(dt).t(), u(H, H).to(dt).t(), u(H),
                 u(4 * H, H).to(dt).t(), u(4 * H), u(4 * H, H).to(dt).t(),
                 u(4 * H))
        ct = torch.randn(b, J, H, generator=g, device="cuda")

        def chain(fh, gp, w0, *cell1):
            return pu_kernel.pu_chain_plain(fh, gp, w0,
                                            pu_kernel._nested(cell1))

        def recompute():
            return plain_vjp(chain, saved, (True,) * 9, ct, "plain recompute")
        plain = time_ms(torch, recompute, iters=5)
        leaves = [t.detach().requires_grad_(True) for t in saved]
        with torch.enable_grad():            # the smoke runs under no_grad
            y = pu_kernel.pu_chain_fused(*leaves[:3],
                                         pu_kernel._nested(leaves[3:]))

        def backward():
            return torch.autograd.grad(y, leaves, ct, retain_graph=True)
        for name, got, want in zip(PU_LEAVES, backward(), recompute()):
            reading(f"C's backward {dt} d{name}", got, want,
                    pu_kernel.GRAD_TOL[dt])
        events = time_ms(torch, backward)
        hosts = []
        for _ in range(ITERS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            backward()
            hosts.append(1e3 * (time.perf_counter() - t0))
        host = statistics.median(hosts)
        device = device_ms(torch, backward, "pu_chain_reverse")
        floor = device_ms(torch, lambda: pu_kernel.barrier_walk(
            b, J, H, dt, "cuda"), "pu_chain_kernel")
        # the walk: its transposed products, f32 on the CUDA cores,
        # against the states, output, output gradient and fh it reads and
        # the gate gradients, dzf, dfh and operands it writes, each once,
        # and its weights read once
        walk_flops = 2 * b * J * 13 * H * H
        rows = pu_kernel.STATES + 3 + 4 + 4 + 1 + 1 + 3
        walk_bytes = 4 * b * J * H * rows + 13 * H * H * dt.itemsize
        walk_bound, _ = own_bound(walk_flops, "f32_flops_per_s", walk_bytes)
        # the whole backward: the walk, then the weight products as many
        # operations again, which read the operands and gate gradients
        # once more and write the weight gradients
        bound, _ = own_bound(2 * walk_flops, "f32_flops_per_s",
                             walk_bytes + 4 * b * J * H * (3 + 4 + 4 + 1)
                             + 13 * H * H * dt.itemsize)
        out[("pu_chain", dt)] = dict(ms=events, host_ms=host, bound_ms=bound,
                                     device_ms=device,
                                     device_bound_ms=walk_bound,
                                     latency_floor_ms=floor, plain_ms=plain)
        print(f"  backward {dt}: kernel B recompute "
              f"{out[('attention', dt)]:.3f} ms a launch; kernel C "
              f"{events:.3f} ms a call (host {host:.3f} ms), bound "
              f"{bound:.4f} ms (the walk and the weight products, f32 "
              f"operations); the reverse walk on the device {device:.4f} ms, "
              f"bound {walk_bound:.4f} ms (its f32 operations), latency "
              f"floor {floor:.4f} ms; the plain recompute it replaces "
              f"{plain:.3f} ms [{card}]")
    return out


def range_kernels_ms(evt, ranges=()):
    """Device time of the kernels launched inside the profiler range (or
    op) ``evt`` and its children, in ms. A `record_function` range also
    shows on the device as an event of its own name spanning its
    kernels; that span is not a kernel and is not counted."""
    own = sum(k.duration for k in evt.kernels if k.name not in ranges)
    return own / 1e3 + sum(range_kernels_ms(c, ranges)
                           for c in evt.cpu_children)


def profile_train_step(torch, task, state, batch, card):
    """Device time of the kernels of one training step under
    torch.profiler, and of those of the backward of B (its recompute) and
    of C within it (their profiler ranges; a range's own span on the
    device is not a kernel and is printed apart; C's reverse walk is
    launched from outside PyTorch's ops, so the profiler's op tree gives
    its range only the weight products, and the span holds it)."""
    from torch.profiler import ProfilerActivity, profile
    from egotap_tpu_torch.ops import attention, pu_kernel
    labels = {"attention": attention.BACKWARD_LABEL,
              "pu_chain": pu_kernel.BACKWARD_LABEL}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.train_step(state, batch)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    total = sum(e.device_time_total for e in events if e.device_type == cuda
                and e.name not in labels.values()) / 1e3
    ranges, spans = {}, {}
    for key, label in labels.items():
        ranges[key] = sum(range_kernels_ms(e, labels.values()) for e in events
                          if e.name == label and e.device_type != cuda)
        spans[key] = sum(e.device_time_total for e in events
                         if e.name == label and e.device_type == cuda) / 1e3
    print(f"  profiled training step: wall {wall:.3f} ms, device kernels "
          f"{total:.3f} ms, of which the backward recompute of B "
          f"{ranges['attention']:.3f} ms (3 launches; their spans on the "
          f"device {spans['attention']:.3f} ms) and C's backward "
          f"{ranges['pu_chain']:.3f} ms of weight products (span, with "
          f"the reverse walk, {spans['pu_chain']:.3f} ms) "
          f"[{card}]")


def phase_train(torch, card):
    """Stage-2 training at full width (bench.py train): TRAIN_STEPS steps
    of batch 32 in bf16 with the launch counters zeroed before them; then
    the f32 step on the card against the CPU at batch 2, and its faulty
    control."""
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.models import vit
    from egotap_tpu_torch.train.tasks import LifterTask

    cfg = Config.from_preset("egotap_unrealego")
    print(f"  config: {cfg.model_name} frozen nets, Grid-ViT 1024 x 3 x 8 "
          f"heads, ae_hidden_size {cfg.ae_hidden_size}, "
          f"{cfg.optimizer_type} {cfg.lr_policy} lr {cfg.lr}, niter "
          f"{cfg.niter} + {cfg.niter_decay}, batch {cfg.batch_size}, "
          f"use_amp {cfg.use_amp}")
    t0 = time.perf_counter()
    task = LifterTask(cfg, device="cuda")
    state = task.init_state(seed=0, iters_per_epoch=TRAIN_ITERS_PER_EPOCH)
    torch.cuda.synchronize()
    print(f"  state built in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(20)
    batches = [train_inputs(torch, gen, cfg.batch_size)
               for _ in range(TRAIN_STEPS)]
    lifter0 = {n: p.detach().clone()
               for n, p in state.net.named_parameters()}
    frozen0 = {k: {n: t.clone() for n, t in net.state_dict().items()}
               for k, net in state.frozen.items()}
    reset_counts()
    times, losses = [], []
    for b in batches:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        state, loss = task.train_step(state, b)
        e.record()
        times.append((s, e))
        losses.append(loss)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"  launches over {TRAIN_STEPS} training steps: {counts}")
    for n, c in counts.items():
        if c != TRAIN_STEPS * PER_TRAIN_STEP[n]:
            raise AssertionError(f"training: {n} launched {c} times, "
                                 f"expected {TRAIN_STEPS * PER_TRAIN_STEP[n]}")
    values = [{k: float(v) for k, v in loss.items()} for loss in losses]
    print(f"  losses, first and last step: {values[0]} {values[-1]}")
    if not all(math.isfinite(v) for d in values for v in d.values()):
        raise AssertionError("training: a loss is not finite")
    ms = statistics.median(s.elapsed_time(e) for s, e in times[-TIMED_STEPS:])
    print(f"  training step median {ms:.3f} ms over the last {TIMED_STEPS} "
          f"of {TRAIN_STEPS} steps of batch {cfg.batch_size} = "
          f"{1e3 * cfg.batch_size / ms:.2f} pairs/s [{card}]")
    moved = [n for n, p in state.net.named_parameters()
             if not torch.equal(p, lifter0[n])]
    print(f"  lifter: {len(moved)} of {len(lifter0)} parameter tensors moved")
    for name in ("pos_heatmap_encoder.vit.encoder.layer.0.attention."
                 "attention.query.weight",          # only through B's backward
                 "skel_sequential_layer.lstm_custom.layers.1.h2h.weight"):
        if name not in moved:                       # only through C's
            raise AssertionError(f"training: {name} did not move")
    for key, net in state.frozen.items():
        for n, p in net.named_parameters():
            if not torch.equal(p, frozen0[key][n]):
                raise AssertionError(f"frozen {key}: {n} changed")
        stats = [n for n, t in net.state_dict().items()
                 if n.endswith("running_mean")
                 and not torch.equal(t, frozen0[key][n])]
        print(f"  frozen {key}: parameters unchanged bit for bit, "
              f"{len(stats)} running means moved")
        if not stats:
            raise AssertionError(f"frozen {key}: running stats did not move")
    backward = recompute_ms(torch, card)
    profile_train_step(torch, task, state, batches[0], card)
    del state, task, batches
    torch.cuda.empty_cache()

    # ---- f32, batch 2: the card's step against the CPU's
    cfg32 = Config.from_preset("egotap_unrealego", use_amp=False,
                               batch_size=2)
    batch = train_inputs(torch, torch.Generator(device="cuda").manual_seed(22),
                         2)
    readings = {}
    for dev in ("cuda", "cpu"):
        task = LifterTask(cfg32, device=dev)
        st = task.init_state(seed=1, iters_per_epoch=TRAIN_ITERS_PER_EPOCH)
        t0 = time.perf_counter()
        readings[dev] = task.gradients(
            st, {k: v.to(dev) for k, v in batch.items()})
        print(f"  f32 step on the {dev}: {time.perf_counter() - t0:.2f} s")
        if dev == "cuda":
            real = vit.multihead_attention_packed
            # faulty control: B's output cut from the graph, so nothing
            # reaches q, k, v or what lies before them through attention
            vit.multihead_attention_packed = \
                lambda *a: real(*a).detach()
            try:
                st = task.init_state(seed=1,
                                     iters_per_epoch=TRAIN_ITERS_PER_EPOCH)
                readings["control"] = task.gradients(
                    st, {k: v.to(dev) for k, v in batch.items()})
            finally:
                vit.multihead_attention_packed = real
        del task, st
    ref_loss, ref_grad = readings["cpu"]
    ref = flat_grad(torch, ref_grad, ref_grad)
    gaps = {}
    for label in ("cuda", "control"):
        loss, grad = readings[label]
        gap = max(loss_gap(k, float(loss[k]), float(ref_loss[k]))
                  for k in ref_loss)
        rel = float((flat_grad(torch, grad, ref_grad) - ref).norm()
                    / ref.norm())
        gaps[label] = rel
        values = {k: float(v) for k, v in loss.items()}
        refs = {k: float(v) for k, v in ref_loss.items()}
        print(f"  f32 {label} vs CPU: losses {values} vs {refs}, loss gap "
              f"{gap:.3e} (rtol {TRAIN_LOSS_RTOL:.0e}); gradient rel-L2 "
              f"{rel:.3e} (tol {TRAIN_GRAD_TOL:.0e})")
        if label == "cuda" and (gap > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_TOL):
            raise AssertionError("the f32 training step on the card and the "
                                 "CPU disagree")
    if not gaps["control"] > 10 * TRAIN_GRAD_TOL:
        raise AssertionError("the gradient check did not reject B's "
                             "backward dropped")
    print(f"  control (B's output detached) rejected: rel-L2 "
          f"{gaps['control']:.3e} > 10 x {TRAIN_GRAD_TOL:.0e}")
    torch.cuda.empty_cache()
    return {"counts": counts, "backward": backward}


def numpy_metrics(pred, gt):
    """mpjpe / pa_mpjpe in mm, float64 numpy: norms, and an SVD Procrustes
    with the reflection fix."""
    import numpy as np
    pred, gt = pred.astype(np.float64), gt.astype(np.float64)
    mu1, mu2 = pred.mean(1, keepdims=True), gt.mean(1, keepdims=True)
    x1, x2 = pred - mu1, gt - mu2
    k = np.einsum("bji,bjk->bik", x1, x2)
    u, _, vh = np.linalg.svd(k)
    v = vh.transpose(0, 2, 1)
    z = np.tile(np.eye(3), (len(k), 1, 1))
    z[:, -1, -1] = np.sign(np.linalg.det(u @ vh))
    r = v @ z @ u.transpose(0, 2, 1)
    scale = np.einsum("bij,bji->b", r, k) / (x1 ** 2).sum((1, 2))
    aligned = scale[:, None, None] * x1 @ r.transpose(0, 2, 1) + mu2
    err = lambda p: 10 * np.linalg.norm(gt - p, axis=-1).mean(-1)  # noqa
    return {"mpjpe": err(pred), "pa_mpjpe": err(aligned)}


def phase_eval(torch, card):
    """The eval step of the serving configuration (bench.py:153-157):
    bf16, int8 heatmap nets and lifter calibrated by `prepare_inference`
    on 2 batches of rgb + 0.1 noise, batch 32."""
    import numpy as np
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.serving import Predictor
    from egotap_tpu_torch.train.tasks import LifterTask

    cfg = Config.from_preset("egotap_unrealego", int8_heatmap_inference=True,
                             int8_lifter_inference=True)
    task = LifterTask(cfg, device="cuda")
    state = task.init_state(seed=2, iters_per_epoch=TRAIN_ITERS_PER_EPOCH)
    gen = torch.Generator(device="cuda").manual_seed(23)
    batch = train_inputs(torch, gen, cfg.batch_size)
    rgb = batch["input_rgb"]
    calib = [{"input_rgb": rgb + 0.1 * torch.randn(
        rgb.shape, generator=gen, device="cuda")} for _ in range(2)]
    t0 = time.perf_counter()
    prepared = task.prepare_inference(state, calib)
    torch.cuda.synchronize()
    print(f"  prepare_inference (int8 twins, 2 calibration batches) in "
          f"{time.perf_counter() - t0:.2f} s")
    task.eval_step(prepared, batch)                 # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = task.eval_step(prepared, batch)
    counts = read_counts()
    print(f"  launches in one eval step: {counts}")
    if counts != per_int8_forward():
        raise AssertionError("the eval step must launch A, B, C and E as "
                             "the int8 serving forward does")
    pred = Predictor(cfg, state.frozen["heatmap"].state_dict(),
                     state.frozen["rot_heatmap"].state_dict(),
                     state.net.state_dict(), bf16=True, device="cuda")
    scales = 0
    for net, twin in zip(pred.nets, prepared.inference.nets):
        mods = dict(net.named_modules())
        for name, m in twin.named_modules():
            if getattr(m, "a_scale", None) is not None:
                mods[name].a_scale = m.a_scale.clone()
                scales += 1
    want = pred._forward(rgb)
    same = torch.equal(out["pred_pose"], want)
    print(f"  eval step pose vs a Predictor with the same weights and "
          f"{scales} static scales: "
          f"{'equal bit for bit' if same else 'DIFFERENT  FAIL'}")
    if not same:
        raise AssertionError("eval_step and Predictor forward differ")
    ref = numpy_metrics(out["pred_pose"].cpu().numpy(),
                        batch["gt_local_pose"].cpu().numpy())
    for k in ("mpjpe", "pa_mpjpe"):
        got = out["metrics"][k].cpu().numpy()
        gap = float(np.abs(got - ref[k]).max() / np.abs(ref[k]).max())
        print(f"  {k}: mean {got.mean():.4f} mm, vs float64 numpy "
              f"{gap:.3e} relative (tol {EVAL_METRIC_RTOL:.0e})")
        if not (np.isfinite(got).all() and gap <= EVAL_METRIC_RTOL):
            raise AssertionError(f"eval {k} disagrees with float64 numpy")
    ms = time_ms(torch, lambda: task.eval_step(prepared, batch), iters=10,
                 warmup=1)
    print(f"  eval step median {ms:.3f} ms over 10 steps of batch "
          f"{cfg.batch_size} = {1e3 * cfg.batch_size / ms:.2f} pairs/s "
          f"[{card}]")
    del pred, prepared, state, task
    torch.cuda.empty_cache()
    return counts


# stage-1 training (bench.py:200-206, train1): both stage-1 presets at
# their batch of 16, bf16 amp, stage-1 Adam, on targets rendered on the
# card from a raw batch
STAGE1_PRESETS = ("unrealego_heatmap_joint", "unrealego_heatmap_limb")
# launches per stage-1 training step: the decoder's three calls of A
# forward; A's backward recomputes the plain version (profiler range)
PER_TRAIN1_STEP = {"upsample": 3, "attention": 0, "pu_chain": 0,
                   "attention_unpacked": 0, "fused_layer1": 0,
                   "pu_chain_backward": 0, "bn_act": 0, "int8_pack": 0,
                   "int8_epilogue": 0}
# the targets rendered on the card vs on the CPU: the same operations on
# both, f32 rounding apart; relative where a value exceeds 1 (pixel
# lengths reach about 90, where one ulp is 7.6e-6)
TARGET_TOL = 1e-6
EVAL_MSE_RTOL = 1e-4               # f32 eval step, card vs CPU


def stage1_recompute_ms(torch, card):
    """CUDA-event times of kernel A's backward recompute (`ops.plain_vjp`
    over the plain version) at the stage-1 decoder's three bf16 calls,
    batch 16; returns their mean, the time a launch."""
    from egotap_tpu_torch.ops import plain_vjp, upsample
    g = torch.Generator(device="cuda").manual_seed(32)
    times = []
    for n, h, w, c in ((16, 8, 8, 1024), (16, 16, 16, 1024),
                       (16, 32, 32, 512)):
        x = torch.randn(n, h, w, c, generator=g, device="cuda").bfloat16()
        ct = torch.randn(n, 2 * h, 2 * w, c, generator=g,
                         device="cuda").bfloat16()
        times.append(time_ms(torch, lambda: plain_vjp(
            upsample.upsample2x_plain, (x,), (True,), ct,
            upsample.BACKWARD_LABEL), iters=10))
    print(f"  kernel A backward recompute, bf16, at (16, 8, 8, 1024), "
          f"(16, 16, 16, 1024), (16, 32, 32, 512): "
          f"{', '.join(f'{t:.4f}' for t in times)} ms, "
          f"{sum(times) / 3:.4f} ms a launch [{card}]")
    return sum(times) / 3


def profile_recompute(torch, step, card):
    """Launches of A's backward recompute in one training step (its
    profiler ranges) and the device time of their kernels."""
    from torch.profiler import ProfilerActivity, profile
    from egotap_tpu_torch.ops import upsample
    label = upsample.BACKWARD_LABEL
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    ranges = [e for e in prof.events() if e.name == label
              and e.device_type != torch.autograd.DeviceType.CUDA]
    ms = sum(range_kernels_ms(e, (label,)) for e in ranges)
    print(f"  profiled step: {len(ranges)} backward recomputes of kernel A, "
          f"their kernels {ms:.3f} ms on the device [{card}]")
    return len(ranges)


def raw_stage1_batch(torch, batch, seed, device="cuda"):
    """A raw stage-1 batch of 256 x 256 stereo pairs and 16 joints drawn
    with numpy from ``seed`` (the loaders' keys,
    `data.pipeline.make_device_preprocess`): N(0, 1) rgb, 2D joints
    uniform over 1024-space and beyond it (some out of view), one bone of
    zero length in 2D and one with no length in xy, 3D poses of N(0, 30)
    cm around pelvises of N(0, 5)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {f"input_rgb_{s}": rng.standard_normal(
        (batch, 256, 256, 3), dtype=np.float32) for s in ("left", "right")}
    for side in ("left", "right"):
        c2d = rng.uniform(-150, 1150, (batch, 16, 2)).astype(np.float32)
        c2d[0, 3] = c2d[0, 2]
        out[f"gt_camera_2d_{side}"] = c2d
    pose = rng.normal(0, 30, (batch, 16, 3)).astype(np.float32)
    pose[-1, 4, :2] = pose[-1, 0, :2]
    out.update(gt_local_pose=pose,
               gt_local_rot=rng.normal(0, 1, (batch, 16, 3)).astype(
                   np.float32),
               gt_pelvis_left=rng.normal(0, 5, (batch, 3)).astype(np.float32),
               gt_pelvis_right=rng.normal(0, 5, (batch, 3)).astype(
                   np.float32),
               mask=np.ones((batch,), np.float32))
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def check_targets(torch, feed, cpu_feed):
    """Every output of the preprocess on the card against the CPU's."""
    worst = 0.0
    for k, ref in cpu_feed.items():
        got = feed[k].cpu()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"target {k}: {tuple(got.shape)} on the "
                                 f"card, {tuple(ref.shape)} on the CPU")
        err = float(((got - ref).abs() / ref.abs().clamp_min(1)).max())
        worst = max(worst, err)
        if err > TARGET_TOL:
            raise AssertionError(f"target {k}: card vs CPU {err:.3e}")
    print(f"  targets rendered on the card vs the CPU: {len(cpu_feed)} "
          f"tensors, max err {worst:.3e} (tol {TARGET_TOL:.0e})")
    return worst


def train1_run(torch, preset, card, **overrides):
    """TRAIN_STEPS bf16 stage-1 steps at full width on one fixed batch
    rendered on the card (``overrides`` over the preset); returns the
    state and what was counted."""
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.data.pipeline import make_device_preprocess
    from egotap_tpu_torch.train.tasks import HeatmapTask
    cfg = Config.from_preset(preset, **overrides)
    raw = raw_stage1_batch(torch, cfg.batch_size, seed=30)
    pre = make_device_preprocess(cfg)
    feed = pre(raw)
    targets = check_targets(torch, feed, pre({k: v.cpu()
                                              for k, v in raw.items()}))
    t0 = time.perf_counter()
    task = HeatmapTask(cfg, device="cuda")
    state = task.init_state(seed=0, iters_per_epoch=TRAIN_ITERS_PER_EPOCH)
    torch.cuda.synchronize()
    print(f"  {preset}: {cfg.model_name}, heatmap_type {cfg.heatmap_type}, "
          f"{task.nh + task.nr * task.ld} maps a view, batch "
          f"{cfg.batch_size}, use_amp {cfg.use_amp}, lr {cfg.lr}; state "
          f"built in {time.perf_counter() - t0:.2f} s")
    params0 = {n: p.detach().clone()
               for n, p in state.net.named_parameters()}
    stats0 = {n: t.clone() for n, t in state.net.state_dict().items()
              if n.endswith(("running_mean", "running_var"))}
    reset_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        state, loss = task.train_step(state, feed)
        e.record()
        times.append((s, e))
        losses.append(loss)
    torch.cuda.synchronize()
    counts = read_counts()
    print(f"  launches over {TRAIN_STEPS} steps: {counts}")
    for n, c in counts.items():
        if c != TRAIN_STEPS * PER_TRAIN1_STEP[n]:
            raise AssertionError(f"stage 1: {n} launched {c} times, expected "
                                 f"{TRAIN_STEPS * PER_TRAIN1_STEP[n]}")
    total = [sum(float(v) for v in loss.values()) for loss in losses]
    print(f"  loss on the fixed batch: step 1 {total[0]:.6f}, step "
          f"{TRAIN_STEPS} {total[-1]:.6f}; every step {total}")
    if not (all(math.isfinite(t) for t in total) and total[-1] < total[0]):
        raise AssertionError("stage 1: the loss did not fall")
    ms = statistics.median(s.elapsed_time(e) for s, e in times[-TIMED_STEPS:])
    print(f"  stage-1 step median {ms:.3f} ms over the last {TIMED_STEPS} of "
          f"{TRAIN_STEPS} = {1e3 * cfg.batch_size / ms:.2f} pairs/s [{card}]")
    unmoved = [n for n, p in state.net.named_parameters()
               if ".fc." not in n and torch.equal(p, params0[n])]
    stale = [n for n, t in stats0.items()
             if torch.equal(state.net.state_dict()[n], t)]
    print(f"  {len(params0) - 2 - len(unmoved)} of {len(params0) - 2} "
          f"trained parameter tensors moved, {len(stats0) - len(stale)} of "
          f"{len(stats0)} running statistics moved")
    if unmoved or stale:
        raise AssertionError(f"stage 1: unmoved {unmoved} {stale}")
    recomputes = profile_recompute(
        torch, lambda: task.train_step(state, feed), card)
    if recomputes != 3:
        raise AssertionError("stage 1: kernel A's backward must run once a "
                             "decoder call")
    return state, feed, {"counts": counts, "ms": ms, "targets": targets,
                         "recomputes": recomputes}


def eval_card_vs_cpu(torch, state, feed, preset):
    """The f32 eval step (the input uncast, running statistics) of the
    trained state on the card against the same on the CPU."""
    import copy
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.train.tasks import HeatmapTask
    cfg = Config.from_preset(preset)
    reset_counts()
    out = HeatmapTask(cfg, device="cuda").eval_step(state, feed)
    counts = read_counts()
    cpu_state = copy.copy(state)
    cpu_state.net = copy.deepcopy(state.net).cpu()
    ref = HeatmapTask(cfg, device="cpu").eval_step(
        cpu_state, {k: v.cpu() for k, v in feed.items()})
    got, want = (o["metrics"]["mse_heatmap"].cpu() for o in (out, ref))
    gap = float(((got - want).abs() / want.abs()).max())
    print(f"  f32 eval step, batch {got.shape[0]}: kernel A launches "
          f"{counts['upsample']}, E {counts['bn_act']}, mse_heatmap mean "
          f"{float(got.mean()):.6f}, card vs CPU {gap:.3e} relative (tol "
          f"{EVAL_MSE_RTOL:.0e})")
    if counts["upsample"] != 3 or counts["bn_act"] != E_PER_NET \
            or not gap <= EVAL_MSE_RTOL:
        raise AssertionError("stage-1 eval step: card and CPU disagree")


def train1_card_vs_cpu(torch, card, held="", **overrides):
    """One f32 stage-1 step of batch 2 (joint preset, full width;
    ``overrides`` over it) on the card against the CPU, and the same check
    rejecting kernel A's output detached from the graph. The weights come
    from `serving.init_weights` (biases and BatchNorm affine non-zero):
    with the reference init's zero biases many ReLU inputs sit exactly on
    the kink. The gradients held to TRAIN_GRAD_TOL are those of the
    parameters named ``held...`` (all by default); the whole net's is
    printed beside."""
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.data.pipeline import make_device_preprocess
    from egotap_tpu_torch.models import heatmap_net
    from egotap_tpu_torch.serving import init_weights
    from egotap_tpu_torch.train.tasks import HeatmapTask
    cfg = Config.from_preset(STAGE1_PRESETS[0], use_amp=False, batch_size=2,
                             **overrides)
    start = HeatmapTask(cfg, device="cpu").init_state(1, 1).net
    init_weights(start, torch.Generator().manual_seed(2))
    weights = start.state_dict()
    raw = raw_stage1_batch(torch, 2, seed=31, device="cpu")
    readings = {}
    real = heatmap_net.upsample2x_align_corners
    for label, dev in (("cuda", "cuda"), ("cpu", "cpu"),
                       ("control", "cuda")):
        task = HeatmapTask(cfg, device=dev)
        state = task.init_state(seed=1, iters_per_epoch=1)
        state.net.load_state_dict(weights)
        feed = make_device_preprocess(cfg)({k: v.to(dev)
                                            for k, v in raw.items()})
        if label == "control":          # A's output cut from the graph
            heatmap_net.upsample2x_align_corners = \
                lambda x: real(x).detach()
        t0 = time.perf_counter()
        try:
            readings[label] = task.gradients(state, feed)
        finally:
            heatmap_net.upsample2x_align_corners = real
        print(f"  f32 stage-1 step ({label}): "
              f"{time.perf_counter() - t0:.2f} s")
    ref_loss, ref_grad = readings["cpu"]
    held_grad = {n: g for n, g in ref_grad.items() if n.startswith(held)}
    ref = flat_grad(torch, held_grad, held_grad)
    whole = flat_grad(torch, ref_grad, ref_grad)
    gaps = {}
    for label in ("cuda", "control"):
        loss, grad = readings[label]
        gap = max(abs(float(loss[k]) - float(ref_loss[k]))
                  / abs(float(ref_loss[k])) for k in ref_loss)
        rel = float((flat_grad(torch, grad, held_grad) - ref).norm()
                    / ref.norm())
        if held:
            rel_whole = float((flat_grad(torch, grad, ref_grad) - whole)
                              .norm() / whole.norm())
            print(f"  f32 {label} vs CPU, the whole net's gradient: rel-L2 "
                  f"{rel_whole:.3e}")
        gaps[label] = rel
        print(f"  f32 {label} vs CPU: loss gap {gap:.3e} (rtol "
              f"{TRAIN_LOSS_RTOL:.0e}); {held or 'UNet'} gradient rel-L2 "
              f"{rel:.3e} (tol {TRAIN_GRAD_TOL:.0e})")
        if label == "cuda" and (gap > TRAIN_LOSS_RTOL
                                or rel > TRAIN_GRAD_TOL):
            raise AssertionError("the f32 stage-1 step on the card and the "
                                 "CPU disagree")
    if not gaps["control"] > 10 * TRAIN_GRAD_TOL:
        raise AssertionError("the gradient check did not reject kernel A's "
                             "backward dropped")
    print(f"  control (A's output detached) rejected: rel-L2 "
          f"{gaps['control']:.3e} > 10 x {TRAIN_GRAD_TOL:.0e} [{card}]")


def phase_train1(torch, card):
    """Stage-1 training at full width: both presets (TRAIN_STEPS bf16
    steps of batch 16 with the launch counters zeroed before them), the
    f32 eval step and the f32 training step held to the CPU."""
    runs = {}
    for preset in STAGE1_PRESETS:
        state, feed, runs[preset] = train1_run(torch, preset, card)
        if preset == STAGE1_PRESETS[0]:
            eval_card_vs_cpu(torch, state, feed, preset)
        del state, feed
        torch.cuda.empty_cache()
    backward = stage1_recompute_ms(torch, card)
    train1_card_vs_cpu(torch, card)
    torch.cuda.empty_cache()
    return {"counts": runs[STAGE1_PRESETS[0]]["counts"], "backward": backward}


# the CLIs end to end (phase 8): a synthetic UnrealEgo dataset of 2
# sequences x CLI_FRAMES frames a split at full width (256 x 256 RGB,
# 64 x 64 maps), both stage-1 presets, then the stage-2 preset warm-started
# from their ckpt_best, then the test CLI
CLI_FRAMES = 32
CLI_PRESETS = ("unrealego_heatmap_joint", "unrealego_heatmap_limb",
               "egotap_unrealego")
# kernel launches a training step or an eval batch (stage 1: A in the
# UNet's decoder; stage 2 and its eval: the two frozen nets' decoders, the
# Grid-ViT's three blocks and the PU chain)
PER_UNIT = {"heatmap_shared": {"upsample": 3},
            "egotap_autoencoder": {"upsample": 6, "attention": 3,
                                   "pu_chain": 1}}
# what a training step launches besides: C's backward in stage 2
PER_STEP_BACKWARD = {"heatmap_shared": {},
                     "egotap_autoencoder": {"pu_chain_backward": 1}}
# what an eval batch launches besides: E in the eval-mode trunks (one
# resnet18 net in stage 1, the two frozen ones in stage 2; a training
# step's BatchNorms run in train mode)
PER_EVAL_BATCH = {"heatmap_shared": {"bn_act": E_PER_NET},
                  "egotap_autoencoder": {"bn_act": 2 * E_PER_NET}}
# ckpt_best reloaded into a fresh f32 template: its pose on the test
# split's first batch against pred_pose.npy's rows, relative to their max
RELOAD_TOL = 1e-6
CONTROL_PARAM = "pose_mlp.pose_fcs.0.bias"


def empty_cache(torch):
    """Wait for the card and free its cached blocks (no-op without one,
    in a CPU rehearsal)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cli(torch, main, argv, **kw):
    """``main(argv, **kw)`` with the launch counters zeroed just before:
    (wall s, launch counts, what it returned)."""
    reset_counts()
    t0 = time.perf_counter()
    result = main(argv, **kw)
    empty_cache(torch)
    return time.perf_counter() - t0, read_counts(), result


def differing(got, want):
    """Names of the entries of two state_dicts that are not equal bit for
    bit (all of them when the key sets differ)."""
    import torch
    if sorted(got) != sorted(want):
        return sorted(set(got) | set(want))
    return [k for k in want if not torch.equal(got[k].cpu(), want[k].cpu())]


def state_tensors(state):
    """Every tensor a training state holds, by a flat name."""
    out = {f"net.{k}": v for k, v in state.net.state_dict().items()}
    for key, net in state.frozen.items():
        out.update({f"{key}.{k}": v for k, v in net.state_dict().items()})
    for name, tree in state.opt.trees.items():
        out.update({f"opt.{name}.{k}": v for k, v in tree.items()})
    out.update({f"opt.{k}": v for k, v in state.opt.scalars.items()})
    return out


def cli_eval_batches(cfg, make_loader, epochs):
    """Eval batches of one run: a validation each training epoch, the
    test split and its motion categories."""
    from egotap_tpu_torch.eval.categories import MOTION_CATEGORIES
    return (epochs * len(make_loader(cfg, "validation"))
            + len(make_loader(cfg, "test"))
            + sum(len(make_loader(cfg, "test", c))
                  for c in MOTION_CATEGORIES))


def cli_units(cfg, make_loader, epochs):
    """Training steps and eval batches of one run (`cli_eval_batches`)."""
    return (epochs * len(make_loader(cfg, "train"))
            + cli_eval_batches(cfg, make_loader, epochs))


def check_run_artifacts(cfg, epochs=2):
    """A training run's files (see the module docstring, phase 8) after
    ``epochs`` epochs; returns its per-epoch ``Time/`` scalars from the
    summary."""
    import os
    from egotap_tpu_torch.train import state as state_lib
    exp = cfg.experiment_dir
    for name in ("train_opt.txt", os.path.join("summary", "metrics.jsonl"),
                 "test_result.txt"):
        if not os.path.isfile(os.path.join(exp, name)):
            raise AssertionError(f"{cfg.experiment_name}: no {name}")
    if not (state_lib.checkpoint_exists(exp, "best")
            and state_lib.checkpoint_exists(exp, epochs)
            and not state_lib.checkpoint_exists(exp, epochs - 1)):
        raise AssertionError(f"{cfg.experiment_name}: checkpoints "
                             f"{sorted(os.listdir(exp))}")
    result = open(os.path.join(exp, "test_result.txt")).read()
    for cat in ("001_jumping", "002_falling_down"):
        if f"category: {cat}\n" not in result:
            raise AssertionError(f"{cfg.experiment_name}: test_result.txt "
                                 f"has no line for {cat}")
    epochs = {}
    for line in open(os.path.join(exp, "summary", "metrics.jsonl")):
        rec = json.loads(line)
        if rec["tag"].startswith("Time/"):
            epochs.setdefault(rec["step"], {})[rec["tag"][5:]] = rec["value"]
    return epochs


def cli_common(tmp, image_size=64):
    """The flags every CLI run of phases 8 and 9 passes: the synthetic
    dataset and the log and result directories under ``tmp``, two
    epochs."""
    import os
    return ["--data_dir", os.path.join(tmp, "data"), "--default_data_path",
            "./SyntheticData", "--load_size_heatmap", str(image_size),
            str(image_size), "--niter", "1", "--niter_decay", "1",
            "--log_dir", os.path.join(tmp, "log"),
            "--result_dir", os.path.join(tmp, "results"),
            # a NaN at epoch 1 ends the run (the artifact checks then
            # fail) instead of restarting it without end
            "--auto_terminate", "true"]


def phase_cli(torch, card, tmp, device=None, image_size=64,
              frames=CLI_FRAMES):
    """The train and test CLIs end to end on a synthetic dataset written
    under ``tmp`` (see the module docstring, phase 8). ``device`` is
    passed on to the CLIs when given (a rehearsal on the CPU); the card
    is their default."""
    import os

    import numpy as np
    from egotap_tpu_torch.cli import test as cli_test
    from egotap_tpu_torch.cli import train as cli_train
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.data.pipeline import make_loader
    from egotap_tpu_torch.data.synthetic import generate_dataset
    from egotap_tpu_torch.train import loop
    from egotap_tpu_torch.train import state as state_lib
    from egotap_tpu_torch.train.tasks import create_task

    kw = {} if device is None else {"device": device}
    dev = device or "cuda"
    launches = {}
    data = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    generate_dataset(data, "UnrealEgo", num_sequences=2,
                     frames_per_seq=frames, image_size=image_size)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(data) for f in fs)
    print(f"  synthetic dataset: 3 splits of 2 x {frames} frames, "
          f"{4 * image_size} x {4 * image_size} RGB, {size / 1e6:.1f} MB, "
          f"written in {time.perf_counter() - t0:.2f} s")
    common = cli_common(tmp, image_size)
    best = {}
    for preset in CLI_PRESETS:
        argv = ["--preset", preset] + common
        cfg = Config.from_args(argv)
        if preset == CLI_PRESETS[2]:
            warm_start_check(torch, cfg, best, loop, create_task, kw)
        states = []
        wall, counts, _ = run_cli(
            torch, cli_train.main, argv,
            epoch_callback=lambda r: states.append(r["state"]), **kw)
        launches[preset] = counts
        units = cli_units(cfg, make_loader, 2)
        print(f"  {preset}: returned after {wall:.2f} s; launches "
              f"{counts} over {units} training steps and eval batches "
              f"(batch {cfg.batch_size})")
        expect_counts(counts, PER_UNIT[cfg.model], units, preset, device,
                      PER_STEP_BACKWARD[cfg.model],
                      2 * len(make_loader(cfg, "train")),
                      PER_EVAL_BATCH[cfg.model],
                      cli_eval_batches(cfg, make_loader, 2))
        epochs = check_run_artifacts(cfg)
        for e, t in sorted(epochs.items()):
            print(f"    epoch {e}: {t['epoch_s']:.3f} s = step loop "
                  f"{t['loop_s']:.3f} s (waiting on the loader "
                  f"{t['loader_wait_s']:.3f} s, share of the loop "
                  f"{t['loader_wait_s'] / t['loop_s']:.3f}, of the "
                  f"epoch {t['loader_wait_s'] / t['epoch_s']:.3f}) + "
                  f"validation {t['val_s']:.3f} s + checkpoint writes "
                  f"{t['ckpt_s']:.3f} s + the rest [{card}]")
        final = states[-1]
        off = [k for k, t in state_tensors(final).items()
               if t.device.type != torch.device(dev).type]
        if off:
            raise AssertionError(f"{preset}: {len(off)} tensors not on "
                                 f"{dev}, e.g. {off[:3]}")
        size = os.path.getsize(os.path.join(
            cfg.experiment_dir, "ckpt_best", state_lib.CKPT_FILE))
        print(f"    all {len(state_tensors(final))} tensors of the "
              f"final state on {dev}; checkpoints "
              f"{sorted(os.listdir(cfg.experiment_dir))}, "
              f"{size / 1e6:.1f} MB each")
        if cfg.model == "heatmap_shared":
            best[preset] = state_lib.read_checkpoint(os.path.join(
                cfg.experiment_dir, "ckpt_best"))["net"]
        else:
            frozen_params_check(final, best)
        del states, final
        empty_cache(torch)

    argv = ["--preset", CLI_PRESETS[2]] + common
    wall, counts, (_, pps) = run_cli(torch, cli_test.main, argv, **kw)
    launches["cli.test"] = counts
    cfg = Config.from_args(argv)
    units = cli_units(cfg, make_loader, 0)
    n_test = len(make_loader(cfg, "test"))
    timed = (f"timed over the {n_test - 1} test batch(es) after the "
             f"first" if n_test > 1 else "its one test batch timed")
    print(f"  cli.test: returned after {wall:.2f} s; launches {counts} "
          f"over {units} eval batches; evaluate {pps:.1f} pairs/s "
          f"(f32, batch {cfg.batch_size}, {timed}) [{card}]")
    expect_counts(counts, PER_UNIT[cfg.model], units, "cli.test", device,
                  per_eval=PER_EVAL_BATCH[cfg.model], evals=units)
    res = cfg.results_dir
    n = 2 * frames
    detail = open(os.path.join(res, "detail_result.txt")).read()
    cats = open(os.path.join(res, "categorical_result.txt")).read()
    pred = np.load(os.path.join(res, "pred_pose.npy"))
    if len(detail.splitlines()) != n + 1 or pred.shape != (n, 16, 3) \
            or not np.isfinite(pred).all() or len(cats.splitlines()) != 4:
        raise AssertionError(f"cli.test: detail {len(detail.splitlines())}"
                             f" lines, pose {pred.shape}, categorical "
                             f"{cats!r}")
    print(f"    detail_result.txt {n} rows, categorical_result.txt "
          f"{len(cats.splitlines())} lines, pred_pose.npy {pred.shape}")
    reload_check(torch, cfg, pred, kw)
    return launches


def expect_counts(counts, per_unit, units, label, device, per_step=None,
                  steps=0, per_eval=None, evals=0):
    """Each kernel of the path launched once per unit where its count
    says, plus ``per_step`` once per training step and ``per_eval`` once
    per eval batch of the ``units``, none other (the CPU rehearsal
    launches nothing)."""
    per_step, per_eval = per_step or {}, per_eval or {}
    want = {k: per_unit.get(k, 0) * units + per_step.get(k, 0) * steps
            + per_eval.get(k, 0) * evals for k in counts}
    if device != "cpu" and counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")


def warm_start_check(torch, cfg, best, loop, create_task, kw):
    """The stage-2 state right after `_init_task_state` holds the two
    stage-1 ckpt_best nets bit for bit; a copy with one element changed
    must be told apart."""
    init = loop._init_task_state(cfg, create_task(cfg, **kw), 1)
    pairs = (("heatmap", CLI_PRESETS[0]), ("rot_heatmap", CLI_PRESETS[1]))
    for key, preset in pairs:
        bad = differing(init.frozen[key].state_dict(), best[preset])
        if bad:
            raise AssertionError(f"warm start: {key} differs from "
                                 f"{preset}'s ckpt_best in {bad[:3]}")
    faulty = {k: v.clone() for k, v in best[CLI_PRESETS[0]].items()}
    name = next(k for k in faulty if k.endswith("conv1.weight"))
    faulty[name].view(-1)[0] += 1e-3
    caught = differing(init.frozen["heatmap"].state_dict(), faulty)
    if caught != [name]:
        raise AssertionError(f"warm start control not caught: {caught}")
    print(f"  stage-2 init: frozen nets equal both stage-1 ckpt_best bit "
          f"for bit ({len(best[CLI_PRESETS[0]])} + "
          f"{len(best[CLI_PRESETS[1]])} tensors); control ({name} + 1e-3 in "
          f"one element) caught")
    del init
    empty_cache(torch)


def frozen_params_check(final, best):
    """After stage-2 training the frozen nets' parameters are still the
    stage-1 ckpt_best ones (their running statistics move)."""
    for key, preset in (("heatmap", CLI_PRESETS[0]),
                        ("rot_heatmap", CLI_PRESETS[1])):
        params = dict(final.frozen[key].named_parameters())
        bad = differing(params, {k: best[preset][k] for k in params})
        stats = [k for k, v in final.frozen[key].state_dict().items()
                 if k.endswith("running_mean")
                 and differing({k: v}, {k: best[preset][k]})]
        if bad or not stats:
            raise AssertionError(f"frozen {key}: parameters differ {bad[:3]}"
                                 f", {len(stats)} running means moved")
        print(f"    frozen {key}: {len(params)} parameters still the stage-1"
              f" ckpt_best's bit for bit, {len(stats)} running means moved")


def reload_check(torch, cfg, pred, kw):
    """ckpt_best loaded into a fresh f32 template gives pred_pose.npy's
    first rows on the test split's first batch; one tensor perturbed
    after the load must fail the same check."""
    import dataclasses

    import numpy as np
    from egotap_tpu_torch.data.pipeline import (make_device_preprocess,
                                                make_loader)
    from egotap_tpu_torch.eval.evaluate import to_device
    from egotap_tpu_torch.train import loop
    from egotap_tpu_torch.train import state as state_lib
    from egotap_tpu_torch.train.tasks import create_task

    cfg = dataclasses.replace(cfg, use_amp=False)    # as cli.test runs
    task = create_task(cfg, **kw)
    template = loop._init_task_state(cfg, task, 1)
    state = state_lib.load_checkpoint(cfg.experiment_dir, "best", template,
                                      restore_opt_state=False)
    batch = next(iter(make_loader(cfg, "test")))
    feed = make_device_preprocess(cfg)(to_device(batch, task.device))
    n = int(batch["mask"].sum())
    want = pred[:n]
    scale = float(np.abs(want).max())
    errs = {}
    for label in ("reload", "control"):
        if label == "control":
            with torch.no_grad():
                dict(state.net.named_parameters())[CONTROL_PARAM].add_(1.0)
        pose = task.eval_step(state, feed)["pred_pose"].cpu().numpy()[:n]
        errs[label] = float(abs(pose - want).max()) / scale
    print(f"  ckpt_best in a fresh f32 template, first test batch of {n}: "
          f"max_abs_err {errs['reload']:.3e} of max|pose| {scale:.3f} (tol "
          f"{RELOAD_TOL:.0e}); control ({CONTROL_PARAM} + 1) "
          f"{errs['control']:.3e}")
    if errs["reload"] > RELOAD_TOL:
        raise AssertionError("ckpt_best reloaded does not give pred_pose.npy")
    if not errs["control"] > RELOAD_TOL:
        raise AssertionError("the reload check did not reject a perturbed "
                             "tensor")


# the lifter's other skeleton layers and the learned-LR optimizers at full
# width (phase 9): the lifter alone for these configurations beside the
# serving one (skel_layer "LSTM", the Config default, serves through a
# Predictor)
VARIANTS = {
    "LSTM": dict(skel_layer="LSTM"),
    "LSTMSplit": dict(skel_layer="LSTMSplit"),
    "LSTMNoRel": dict(skel_layer="LSTMNoRel"),
    "None": dict(skel_layer="None"),
    "NoneNoRel": dict(skel_layer="NoneNoRel"),
    "PU tree": dict(skel_layer="PU", pu_semantics="tree"),
    "PU 3 layers": dict(skel_layer="PU", n_skel_layers=3),
}
# launches without kernel C (it covers only the 2-layer PU chain): per
# Predictor forward, per lifter forward, per training step or eval batch
PER_FORWARD_NO_C = {**PER_FORWARD, "pu_chain": 0}
PER_LIFTER = {**{n: 0 for n in PER_FORWARD}, "attention": 3}
PER_LSTM_STEP = {**PER_TRAIN_STEP, "pu_chain": 0, "pu_chain_backward": 0}
# f32 pose of batch 2, card vs CPU, relative to max|cpu| (phase 3's limit
# for the whole forward)
VARIANT_CPU_TOL = 1e-4
VARIANT_REQUESTS = 5               # timed lifter forwards (after one)
LEARNED_LR = ("DAdam", "Prodigy", "DSGD", "DAdaGrad")
# an epoch of 4 steps: the warm-up of the preset's cos_anneal_warmup
# (lr 0 at step 0, which is DAdam's zero-denominator step) ends at step 4,
# so most of the 12 steps run near the peak of the schedule
VARIANT_ITERS_PER_EPOCH = 4
D0 = 1e-6                          # every learned-LR estimate's start
PARAM_TOL = 1e-5                   # f32 parameters after the update
CLI_VARIANT = ["--preset", "egotap_unrealego", "--skel_layer", "LSTM",
               "--optimizer_type", "DAdam", "--experiment_name",
               "egotap_unrealego_lstm_dadam"]
CLI_VARIANT_EPOCHS = 1     # one epoch: phase 10's runs take the time


def variant_lifter(torch, fields, seed):
    """The f32 lifter of the serving configuration with ``fields``, with
    seeded weights (`serving.init_weights`), in eval mode on the CPU."""
    from egotap_tpu_torch.serving import build_nets, init_weights
    from egotap_tpu_torch.serving import serving_config
    lifter = build_nets(serving_config(**fields))[2]
    init_weights(lifter, torch.Generator().manual_seed(seed))
    return lifter.eval()


def variant_forwards(torch, card, hm):
    """Phase 9 (a) after the Predictor: each variant's lifter alone on the
    bf16 heatmap stack ``hm`` (timed, launches counted), its f32 pose of
    batch 2 card vs CPU, and the LSTM walked as a chain rejected."""
    import copy
    from egotap_tpu_torch.serving import cast_matmul_weights
    hm2 = hm[:2].float()
    out = {}
    for i, (name, fields) in enumerate(VARIANTS.items()):
        card32 = variant_lifter(torch, fields, seed=10 + i)
        ref = card32(hm2.cpu())                 # the CPU's pose, then moved
        card32.cuda()
        bf16 = copy.deepcopy(card32)
        cast_matmul_weights(bf16, torch.bfloat16)
        reset_counts()
        ms = time_ms(torch, lambda: bf16(hm), iters=VARIANT_REQUESTS,
                     warmup=1)
        counts = read_counts()
        calls = VARIANT_REQUESTS + 1
        want = {n: c * calls for n, c in PER_LIFTER.items()}
        if counts != want:
            raise AssertionError(f"lifter {name}: launches {counts}, "
                                 f"expected {want}")
        got = card32(hm2).cpu()
        scale = float(ref.abs().max())
        err = float((got - ref).abs().max()) / scale
        if not torch.isfinite(got).all() or err > VARIANT_CPU_TOL:
            raise AssertionError(f"lifter {name}: f32 card vs CPU {err:.3e}")
        line = (f"  lifter {name}: bf16 forward median {ms:.3f} ms at batch "
                f"{hm.shape[0]}, launches {counts} over {calls} forwards; "
                f"f32 card vs CPU, batch 2: {err:.3e} of max|pose| "
                f"{scale:.3f} (tol {VARIANT_CPU_TOL:.0e})")
        if name == "LSTM":
            walk = card32.skel_sequential_layer["lstm"]
            walk.parents = tuple(range(len(walk.parents)))
            chain = float((card32(hm2).cpu() - ref).abs().max()) / scale
            line += f"; control (walked as a chain) {chain:.3e}"
            if not chain > VARIANT_CPU_TOL:
                raise AssertionError("the LSTM walked as a chain was not "
                                     "rejected")
        print(line + f" [{card}]")
        out[name] = ms
        del card32, bf16
        torch.cuda.empty_cache()
    return out


def variant_train(torch, card):
    """Phase 9 (b): the LSTM lifter's training step under each learned-LR
    optimizer, then one f32 Prodigy step card vs CPU. Returns the launch
    counts of one optimizer's steps."""
    import dataclasses

    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.train.tasks import LifterTask
    gen = torch.Generator(device="cuda").manual_seed(30)
    batch = train_inputs(torch, gen, 32)            # the same batch each step
    name_hh = "skel_sequential_layer.lstm.weight_hh_l1"
    base = Config.from_preset("egotap_unrealego", skel_layer="LSTM")
    state0 = LifterTask(base, device="cuda").init_state(
        seed=0, iters_per_epoch=VARIANT_ITERS_PER_EPOCH)
    counts = None
    for opt_name in LEARNED_LR:
        cfg = dataclasses.replace(base, optimizer_type=opt_name)
        task = LifterTask(cfg, device="cuda")
        state = with_optimizer(torch, state0, cfg, "cuda")
        hh0 = dict(state.net.named_parameters())[name_hh].detach().clone()
        reset_counts()
        times, losses, estimates = [], [], []
        for _ in range(TRAIN_STEPS):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            state, loss = task.train_step(state, batch)
            e.record()
            times.append((s, e))
            losses.append(loss)
            estimates.append((state.opt.estimate.clone(),
                              state.opt.d_hat.clone()))
        torch.cuda.synchronize()
        counts = read_counts()
        want = {n: TRAIN_STEPS * c for n, c in PER_LSTM_STEP.items()}
        if counts != want:
            raise AssertionError(f"{opt_name}: launches {counts}, "
                                 f"expected {want}")
        values = [v for loss in losses for v in
                  (float(x) for x in loss.values())]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{opt_name}: a loss is not finite")
        moved = not torch.equal(dict(state.net.named_parameters())[name_hh],
                                hh0)
        ms = statistics.median(s.elapsed_time(e)
                               for s, e in times[-TIMED_STEPS:])
        est = [float(d) for d, _ in estimates]
        d_hat = [float(x) for _, x in estimates]
        print(f"  LSTM training step, {opt_name}: median {ms:.3f} ms over "
              f"the last {TIMED_STEPS} of {TRAIN_STEPS} steps of batch "
              f"{cfg.batch_size} = {1e3 * cfg.batch_size / ms:.2f} pairs/s; "
              f"losses {values[:2]} -> {values[-2:]}; d by step "
              f"{[f'{x:.3e}' for x in est]}; the step's own estimate d_hat "
              f"{[f'{x:.3e}' for x in d_hat]}; {name_hh} moved: {moved} "
              f"[{card}]")
        if not moved or not all(math.isfinite(x) for x in est + d_hat):
            raise AssertionError(f"{opt_name}: {name_hh} moved {moved}, "
                                 f"estimates {est}, {d_hat}")
        # d grows past its start, or the step's own estimate rises over
        # the run toward it (from the third step, the first with two
        # gradients behind it): DAdam's and Prodigy's, whose eps (1e-4)
        # outweighs most of the lifter's per-weight gradients, need more
        # than 12 steps to pass 1e-6
        if not (est[-1] > D0 or d_hat[-1] > d_hat[2] > 0):
            raise AssertionError(f"{opt_name}: the d-estimate did not grow")
        del state, task
        torch.cuda.empty_cache()
    del state0
    prodigy_card_vs_cpu(torch)
    return counts


def with_optimizer(torch, state, cfg, device):
    """A copy of ``state``'s nets on ``device`` with a fresh optimizer of
    ``cfg`` (the four optimizers start from one seeded `init_state`)."""
    import copy
    from egotap_tpu_torch.train.optim import make_optimizer
    from egotap_tpu_torch.train.state import TrainState
    return TrainState.create(
        copy.deepcopy(state.net),
        {k: copy.deepcopy(n) for k, n in state.frozen.items()},
        make_optimizer(cfg, VARIANT_ITERS_PER_EPOCH), torch.device(device))


def prodigy_card_vs_cpu(torch):
    """One f32 Prodigy step of the LSTM lifter at batch 2, card vs CPU,
    under a 'lambda' schedule (lr 1 x d at step 0, so the step moves the
    parameters): losses, the lifter's gradient, the parameters after the
    update."""
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.train.tasks import LifterTask
    cfg = Config.from_preset("egotap_unrealego", skel_layer="LSTM",
                             optimizer_type="Prodigy", use_amp=False,
                             batch_size=2, lr_policy="lambda")
    batch = train_inputs(torch, torch.Generator(device="cuda").manual_seed(31),
                         2)
    readings = {}
    cpu_state = LifterTask(cfg, device="cpu").init_state(
        seed=1, iters_per_epoch=VARIANT_ITERS_PER_EPOCH)
    for dev in ("cuda", "cpu"):
        task = LifterTask(cfg, device=dev)
        st = (with_optimizer(torch, cpu_state, cfg, dev) if dev == "cuda"
              else cpu_state)
        before = {n: p.detach().cpu().clone()
                  for n, p in st.net.named_parameters()}
        loss, grads = task.gradients(st, {k: v.to(dev)
                                          for k, v in batch.items()})
        st.opt.step(dict(st.net.named_parameters()), grads)
        after = {n: p.detach().cpu() for n, p in st.net.named_parameters()}
        readings[dev] = (loss, grads, before, after)
        del task, st
    (loss, grads, _, after), (ref_loss, ref_grads, before, ref_after) = \
        readings["cuda"], readings["cpu"]
    gap = max(loss_gap(k, float(loss[k]), float(ref_loss[k]))
              for k in ref_loss)
    ref = flat_grad(torch, ref_grads, ref_grads)
    rel = float((flat_grad(torch, grads, ref_grads) - ref).norm()
                / ref.norm())
    scale = max(float(p.abs().max()) for p in ref_after.values())
    err = max(float((after[n] - p).abs().max()) for n, p in ref_after.items())
    step = max(float((p - before[n]).abs().max())
               for n, p in ref_after.items())
    print(f"  f32 Prodigy step, card vs CPU, batch 2: loss gap {gap:.3e} "
          f"(rtol {TRAIN_LOSS_RTOL:.0e}); gradient rel-L2 {rel:.3e} (tol "
          f"{TRAIN_GRAD_TOL:.0e}); parameters after the update "
          f"{err:.3e} of their max {scale:.3f} (tol {PARAM_TOL:.0e}; the "
          f"update's largest move {step:.3e})")
    if gap > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_TOL or \
            err > PARAM_TOL * scale or not step > 0:
        raise AssertionError("the f32 Prodigy step on the card and the CPU "
                             "disagree")
    torch.cuda.empty_cache()


def variant_cli(torch, card, tmp):
    """Phase 9 (c): `cli.train` with the LSTM lifter under DAdam on phase
    8's dataset, warm-started from phase 8's stage-1 ckpt_best, then
    `cli.test`; the reload of its ckpt_best. Returns the launch counts
    of both runs."""
    import os

    import numpy as np
    from egotap_tpu_torch.cli import test as cli_test
    from egotap_tpu_torch.cli import train as cli_train
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.data.pipeline import make_loader
    from egotap_tpu_torch.train import state as state_lib
    argv = CLI_VARIANT + cli_common(tmp) + [
        "--niter_decay", str(CLI_VARIANT_EPOCHS - 1)]
    cfg = Config.from_args(argv)
    per_unit = {**PER_UNIT["egotap_autoencoder"], "pu_chain": 0}
    reports = []
    wall, counts, _ = run_cli(torch, cli_train.main, argv, epoch_callback=(
        lambda r: reports.append((r["bad_loss"], r["train_losses"]))))
    units = cli_units(cfg, make_loader, CLI_VARIANT_EPOCHS)
    losses = [v for _, d in reports for v in d.values()]
    print(f"  cli.train {' '.join(CLI_VARIANT[:6])}: returned after "
          f"{wall:.2f} s; launches {counts} over {units} training steps and "
          f"eval batches; epoch losses {[r[1] for r in reports]}")
    expect_counts(counts, per_unit, units, "cli.train (LSTM, DAdam)", None,
                  per_eval=PER_EVAL_BATCH[cfg.model],
                  evals=cli_eval_batches(cfg, make_loader,
                                         CLI_VARIANT_EPOCHS))
    if len(reports) != CLI_VARIANT_EPOCHS or any(
            bad for bad, _ in reports) or not losses \
            or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"cli.train (LSTM, DAdam): reports {reports}")
    check_run_artifacts(cfg, CLI_VARIANT_EPOCHS)
    saved = state_lib.read_checkpoint(os.path.join(cfg.experiment_dir,
                                                   "ckpt_best"))
    opt = saved["opt"]
    fields = ("count", "exp_avg", "exp_avg_sq", "grad_sum", "estim_lr",
              "numerator_weighted")
    if sorted(opt) != sorted(fields) or not opt["count"] > 0 or \
            not math.isfinite(float(opt["estim_lr"])) or \
            "skel_sequential_layer.lstm.weight_hh_l1" not in opt["exp_avg"] \
            or not set(opt["exp_avg"]) <= set(saved["net"]):
        raise AssertionError(f"ckpt_best's optimizer state: {sorted(opt)}")
    print(f"    ckpt_best holds DAdam's state: count {opt['count']}, "
          f"estim_lr {float(opt['estim_lr']):.3e}, numerator_weighted "
          f"{float(opt['numerator_weighted']):.3e}, {len(opt['exp_avg'])} "
          f"tensors a tree")
    wall, test_counts, (_, pps) = run_cli(torch, cli_test.main, argv)
    units = cli_units(cfg, make_loader, 0)
    print(f"  cli.test: returned after {wall:.2f} s; launches {test_counts} "
          f"over {units} eval batches; evaluate {pps:.1f} pairs/s [{card}]")
    expect_counts(test_counts, per_unit, units, "cli.test (LSTM)", None,
                  per_eval=PER_EVAL_BATCH[cfg.model], evals=units)
    pred = np.load(os.path.join(cfg.results_dir, "pred_pose.npy"))
    if pred.shape != (2 * CLI_FRAMES, 16, 3) or not np.isfinite(pred).all():
        raise AssertionError(f"cli.test (LSTM): pose {pred.shape}")
    reload_check(torch, cfg, pred, {})
    return {"cli.train": counts, "cli.test": test_counts}


def phase_variants(torch, card, tmp):
    """Phase 9 (see the module docstring): (a) the LSTM Predictor and the
    lifter variants, (b) the LSTM training step under the learned-LR
    optimizers, (c) the CLIs with the LSTM lifter under DAdam."""
    from egotap_tpu_torch.serving import Predictor, serving_config
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(1)
    rgb_dev = torch.randn(32, 2, 256, 256, 3, generator=g).cuda()
    pred = Predictor(serving_config(skel_layer="LSTM"), bf16=True,
                     device="cuda", seed=0)
    serve(torch, pred, rgb_dev, "LSTM Predictor bf16", card,
          per_forward=PER_FORWARD_NO_C)
    hm = pred._heatmap_stack(rgb_dev)
    del pred, rgb_dev
    forwards = variant_forwards(torch, card, hm)
    del hm
    torch.cuda.empty_cache()
    print(f"  (a) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.enable_grad():
        train_counts = variant_train(torch, card)
    print(f"  (b) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cli = variant_cli(torch, card, tmp)
    print(f"  (c) took {time.perf_counter() - t0:.1f} s")
    return {"forward_ms": forwards, "train_counts": train_counts, "cli": cli}


# bridges for a trained model and parallelism at full width (phase 10):
# the egotap_unrealego preset; one H100 holds every rank and shard, so
# these runs show that the code launches and computes the right thing on
# the card, not a speed for several cards
BRIDGE_STEPS = 2
# a sharded Predictor over 2 data x 2 model shards: each replica's two
# heatmap nets (A, 3 a net) and PU chain (C), and its Grid-ViT's 3 blocks
# on each model shard (B at 4 heads)
TP_DATA, TP_MODEL = 2, 2
VIT_BLOCKS = 3
PER_TP_FORWARD = {"upsample": 6 * TP_DATA,
                  "attention": VIT_BLOCKS * TP_MODEL * TP_DATA,
                  "pu_chain": TP_DATA, "attention_unpacked": 0,
                  "fused_layer1": 0, "pu_chain_backward": 0,
                  "bn_act": PER_FORWARD["bn_act"] * TP_DATA, "int8_pack": 0,
                  "int8_epilogue": 0}


def per_tp_int8_forward():
    """Launches per sharded int8 forward. Kernel F in a replica: the
    unsharded forward's, but a split Grid-ViT block packs each
    row-parallel product's input on every model shard and runs an
    epilogue for each column part (`parallel/tp.py`): 2 packs and 4
    epilogues a block more for each model shard past the first."""
    f = f_per_int8_forward()
    more = VIT_BLOCKS * (TP_MODEL - 1)
    return {**PER_TP_FORWARD, "bn_act": 2 * E_PER_INT8_NET * TP_DATA,
            "int8_pack": (f["int8_pack"] + 2 * more) * TP_DATA,
            "int8_epilogue": (f["int8_epilogue"] + 4 * more) * TP_DATA}
# sharded against unsharded pose, relative to max: f32 (row-parallel
# partial sums in another order), then phase 3's bf16 and int8 budgets
SHARD_TOL = {"f32": 1e-5, "bf16": BF16_POSE_TOL, "int8": INT8_POSE_TOL}
STATE_ATOL = 1e-4         # parameters after a step (PARITY_TABLE backward)
DP_WAIT = 420             # seconds, each 2-rank run
CLI_RTOL = 1e-6           # 2-rank test means against 1 rank's


def check_equal(label, got, want):
    """Two poses (numpy) bit for bit."""
    import numpy as np
    if got.shape != want.shape or not np.array_equal(got, want):
        err, _ = max_dev(got, want)
        raise AssertionError(f"{label}: not bit for bit equal "
                             f"(max_abs_err {err:.3e})")
    print(f"  {label}: bit for bit equal, pose {got.shape}")


def reference_optimizer_check(torch, cfg, net, grads, tmp, card):
    """Phase 10 (a) 3: a reference-style torch AdamW over a copy of the
    lifter, stepped twice with ``grads`` under a LambdaLR of the port's
    schedule, saved as .pth and resumed by the port; then one more f32
    step of each; then the control with the moments one position late."""
    import copy
    import os
    from egotap_tpu_torch.compat import reference
    from egotap_tpu_torch.train.optim import make_optimizer, make_schedule
    sched = make_schedule(cfg, TRAIN_ITERS_PER_EPOCH)
    t_net = copy.deepcopy(net)
    params = dict(t_net.named_parameters())
    topt = torch.optim.AdamW(t_net.parameters(), lr=cfg.lr,
                             eps=cfg.opt_eps, weight_decay=cfg.weight_decay)
    tsched = torch.optim.lr_scheduler.LambdaLR(
        topt, lambda s: sched(s) / cfg.lr)

    def torch_step():
        for n, p in params.items():
            p.grad = grads[n]
        topt.step()
        tsched.step()
    for _ in range(BRIDGE_STEPS):
        torch_step()
    paths = [os.path.join(tmp, f"best_{k}.pth") for k in ("optim_0", "sched")]
    torch.save(topt.state_dict(), paths[0])
    torch.save(tsched.state_dict(), paths[1])

    def resume(shift=0):
        p_net = copy.deepcopy(t_net)
        opt = make_optimizer(cfg, TRAIN_ITERS_PER_EPOCH)
        opt.init(dict(p_net.named_parameters()))
        osd = torch.load(paths[0], map_location="cuda", weights_only=True)
        order = osd["param_groups"][0]["params"]
        osd["param_groups"][0]["params"] = order[-shift:] + order[:-shift] \
            if shift else order
        got = reference.load_reference_optimizer(
            opt, p_net, osd, torch.load(paths[1], weights_only=True),
            cfg.lr_policy, TRAIN_ITERS_PER_EPOCH)
        return p_net, opt, got

    def moments_differ(opt):
        bad = []
        for n, p in params.items():
            st = topt.state.get(p)
            for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
                want = st[key] if st else torch.zeros_like(p)
                if not torch.equal(opt.trees[field][n], want):
                    bad.append(f"{field} {n}")
        return bad
    p_net, opt, (count, step) = resume()
    bad = moments_differ(opt)
    unused = sum(1 for p in params.values() if p not in topt.state)
    print(f"  reference optimizer: torch AdamW x {BRIDGE_STEPS} steps over "
          f"{len(params)} parameters ({unused} never stepped), resumed at "
          f"count {count}, training step {step}; moments differing from "
          f"torch's: {len(bad)}")
    if bad or count != BRIDGE_STEPS or step != BRIDGE_STEPS:
        raise AssertionError(f"reference optimizer resume: {bad[:3]}")
    try:
        _, shifted, _ = resume(shift=1)
        caught = bool(moments_differ(shifted))
        how = "moments differ"
    except ValueError as e:
        caught, how = "shape" in str(e), str(e)[:60]
    print(f"    control, moments one position late: "
          f"{'rejected' if caught else 'NOT rejected  FAIL'} ({how})")
    if not caught:
        raise AssertionError("the shifted-moments control was not rejected")
    torch_step()
    opt.step(dict(p_net.named_parameters()), grads)
    dev = max(float((p - params[n]).detach().abs().max())
              for n, p in p_net.named_parameters())
    print(f"  one more f32 step, port vs torch.optim: max |param dev| "
          f"{dev:.3e} (tol {STATE_ATOL:.0e}) [{card}]")
    if dev > STATE_ATOL:
        raise AssertionError("the resumed step does not track torch.optim")


def phase_bridges(torch, card, tmp):
    """Phase 10 (a): a stage-2 state trained BRIDGE_STEPS steps at batch
    32 in bf16 and saved; `Predictor.from_checkpoint`, the reference .pth
    export and `from_reference_checkpoints`, the reference optimizer and
    `load_partial_weights`."""
    import os
    from egotap_tpu_torch.compat import reference
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.serving import Predictor, build_nets
    from egotap_tpu_torch.train import state as state_lib
    from egotap_tpu_torch.train.tasks import LifterTask

    cfg = Config.from_preset("egotap_unrealego")
    task = LifterTask(cfg, device="cuda")
    state = task.init_state(seed=0, iters_per_epoch=TRAIN_ITERS_PER_EPOCH)
    gen = torch.Generator(device="cuda").manual_seed(30)
    for _ in range(BRIDGE_STEPS):
        state, _ = task.train_step(state, train_inputs(torch, gen, 32))
    exp = os.path.join(tmp, "bridges")
    t0 = time.perf_counter()
    state_lib.save_checkpoint(exp, "best", state)
    print(f"  {BRIDGE_STEPS} bf16 steps trained, ckpt_best written in "
          f"{time.perf_counter() - t0:.2f} s")
    batch = train_inputs(torch, gen, 32)
    want = task.eval_step(state, batch)["pred_pose"].cpu().numpy()
    pred = Predictor.from_checkpoint(cfg, exp, bf16=True)
    reset_counts()
    got = pred(batch["input_rgb"])
    if read_counts() != PER_FORWARD:
        raise AssertionError(f"from_checkpoint: launches {read_counts()}")
    check_equal("Predictor.from_checkpoint vs LifterTask.eval_step (bf16)",
                got, want)
    del pred
    t0 = time.perf_counter()
    paths = reference.export_reference_checkpoints(state,
                                                   os.path.join(tmp, "pth"))
    export_s = time.perf_counter() - t0
    size = sum(os.path.getsize(p) for p in paths)
    print(f"  export: {[os.path.basename(p) for p in paths]}, "
          f"{size / 1e6:.1f} MB in {export_s:.2f} s = "
          f"{size / 1e6 / export_s:.0f} MB/s [{card}]")
    by_name = {os.path.basename(p)[len("best_net_"):-4]: p for p in paths}
    pred = Predictor.from_reference_checkpoints(
        by_name["HeatMap"], by_name["RotHeatMap"], by_name["AutoEncoder"],
        preset="UnrealEgo", bf16=True)
    check_equal("from_reference_checkpoints of the export vs "
                "from_checkpoint", pred(batch["input_rgb"]), got)
    del pred
    _, grads = task.gradients(state, batch)
    reference_optimizer_check(torch, cfg, state.net, grads, tmp, card)
    del grads
    fresh = build_nets(cfg)[2].cuda()
    before = {k: v.clone() for k, v in fresh.state_dict().items()}
    keys = reference.load_partial_weights(
        fresh, os.path.join(exp, "ckpt_best"), ["pos_heatmap_encoder"])
    saved = state_lib.read_checkpoint(os.path.join(exp, "ckpt_best"))["net"]
    saved = {k: v.cuda() for k, v in saved.items()}
    want_keys = [k for k in saved if "pos_heatmap_encoder" in k]
    wrong = [k for k, v in fresh.state_dict().items()
             if not torch.equal(v, saved[k] if k in keys else before[k])]
    print(f"  load_partial_weights(parts=['pos_heatmap_encoder']): "
          f"{len(keys)} of {len(saved)} keys loaded, {len(wrong)} wrong")
    if keys != want_keys or wrong:
        raise AssertionError(f"partial weights: {wrong[:3]}")
    del state, task, fresh
    empty_cache(torch)


def snapshot(torch, state):
    """CPU copies of a state's nets, by a flat name."""
    out = {f"net.{k}": v.cpu() for k, v in state.net.state_dict().items()}
    for key, net in state.frozen.items():
        out.update({f"{key}.{k}": v.cpu()
                    for k, v in net.state_dict().items()})
    return out


def nccl_world_one(torch, card, tmp):
    """Phase 10 (b) 1: the stage-2 step (phase 5's configuration, bf16,
    batch 32) through one NCCL rank against the single-process step from
    the same state, bit for bit; then 5 more of each, timed. Returns the
    rank's launches of one step and kernel B's by head count."""
    import os
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.parallel import mesh
    from egotap_tpu_torch.train.tasks import LifterTask

    cfg = Config.from_preset("egotap_unrealego")
    gen = torch.Generator(device="cuda").manual_seed(31)
    batches = [train_inputs(torch, gen, 32) for _ in range(6)]
    store = torch.distributed.FileStore(os.path.join(tmp, "nccl1"), 1)
    dp = mesh.init("cuda:0", rank=0, world_size=1, store=store,
                   backend="nccl")
    try:
        runs = {}
        for label, ranks in (("single", None), ("nccl", dp)):
            task = LifterTask(cfg, device="cuda", dp=ranks)
            state = task.init_state(seed=0,
                                    iters_per_epoch=TRAIN_ITERS_PER_EPOCH)
            reset_counts()
            state, loss = task.train_step(state, batches[0])
            torch.cuda.synchronize()
            runs[label] = (task, state, read_counts(),
                           {k: float(v) for k, v in loss.items()},
                           snapshot(torch, state), read_head_counts())
        diff = differing(runs["nccl"][4], runs["single"][4])
        same_loss = runs["nccl"][3] == runs["single"][3]
        print(f"  one NCCL rank vs one process, one bf16 step of batch 32: "
              f"losses {'equal' if same_loss else 'DIFFER'} "
              f"{runs['nccl'][3]}, {len(diff)} of {len(runs['nccl'][4])} "
              f"state tensors differ; launches {runs['nccl'][2]}")
        if diff or not same_loss:
            raise AssertionError(f"NCCL world 1 step: {diff[:3]}")
        for label in ("single", "nccl"):
            if runs[label][2] != PER_TRAIN_STEP:
                raise AssertionError(f"{label} step: launches {runs[label][2]}"
                                     f", expected {PER_TRAIN_STEP}")
        times = {"single": [], "nccl": []}
        for b in batches[1:]:
            for label in ("single", "nccl"):
                task, state = runs[label][:2]
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                task.train_step(state, b)
                e.record()
                times[label].append((s, e))
        torch.cuda.synchronize()
        ms = {k: statistics.median(s.elapsed_time(e) for s, e in v)
              for k, v in times.items()}
        print(f"  step median over 5, interleaved: one process "
              f"{ms['single']:.3f} ms, one NCCL rank {ms['nccl']:.3f} ms "
              f"({100 * (ms['nccl'] / ms['single'] - 1):+.2f}%) [{card}]")
        return {"launches": runs["nccl"][2], "heads": runs["nccl"][5]}
    finally:
        mesh.shutdown()
        empty_cache(torch)


def dp_job(torch, tmp, name, cfg_fields, task_cls, feed, seed):
    """Write a job for the 2-rank step (its initial state and batch) and
    take the single-process step of it here: (dryrun arguments, losses,
    flat gradient, state after, running-statistics names)."""
    import os

    import numpy as np
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.train import state as state_lib
    cfg = Config(**cfg_fields).derive()
    task = task_cls(cfg, device="cuda")
    state = task.init_state(seed=seed, iters_per_epoch=1)
    state_lib.save_checkpoint(os.path.join(tmp, name), "best", state)
    path = os.path.join(tmp, f"{name}.npz")
    np.savez(path, **{k: v.cpu().numpy() for k, v in feed.items()})
    losses, grads = task.step_gradients(state, feed)
    state.opt.step(dict(state.net.named_parameters()), grads)
    flat = flat_grad(torch, grads, grads)
    names = {k: g is not None for k, g in grads.items()}
    after = snapshot(torch, state)
    del task, state, grads
    empty_cache(torch)
    args = ["--config", json.dumps({k: list(v) if isinstance(v, tuple)
                                    else v for k, v in cfg_fields.items()}),
            "--init", os.path.join(tmp, name, "ckpt_best"), "--batch", path]
    return dict(args=args, losses={k: float(v) for k, v in losses.items()},
                flat=flat, names=names, after=after,
                rows=len(feed["input_rgb"]))


def saved_state(saved):
    """A rank's saved nets (`parallel.dryrun`), named as `snapshot`."""
    out = {f"net.{k}": v for k, v in saved["net"].items()}
    for key, sd in saved["frozen"].items():
        out.update({f"{key}.{k}": v for k, v in sd.items()})
    return out


def run_dryrun(args, wait=DP_WAIT):
    """``python -m egotap_tpu_torch.parallel.dryrun`` with two ranks on
    cuda:0 over gloo; its wall time."""
    import os
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "egotap_tpu_torch.parallel.dryrun",
         "--nproc", "2", "--device", "cuda:0", "--backend", "gloo",
         "--timeout", str(wait)] + args,
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
        text=True, timeout=wait + 60)
    if run.returncode:
        print(run.stdout[-4000:], run.stderr[-6000:])
        raise AssertionError(f"2-rank run failed ({run.returncode})")
    return time.perf_counter() - t0


def phase_data_parallel(torch, card, tmp, cli_tmp):
    """Phase 10 (b): one NCCL rank; two gloo ranks sharing cuda:0 for a
    stage-2 and a stage-1 f32 step against one process at the global
    batch, with the per-rank-statistics controls; a 2-rank cli.train +
    cli.test on phase 8's dataset against a 1-rank cli.test. Returns the
    launches of one step, kernel B's by head count beside them: the NCCL
    rank's bf16 step and rank 0's f32 stage-2 step, by dtype."""
    import os

    import numpy as np
    from egotap_tpu_torch.cli import test as cli_test
    from egotap_tpu_torch.core.config import PRESETS, Config
    from egotap_tpu_torch.data.pipeline import make_loader
    from egotap_tpu_torch.train.tasks import HeatmapTask, LifterTask
    counts = {torch.bfloat16: nccl_world_one(torch, card, tmp)}

    out = os.path.join(tmp, "dp2")
    gen = torch.Generator(device="cuda").manual_seed(32)
    jobs = {}
    stage2 = dict(PRESETS["egotap_unrealego"], use_amp=False,
                  data_parallel=2, path_to_trained_heatmap=None)
    jobs["stage 2"] = dp_job(torch, out, "stage2", stage2, LifterTask,
                             train_inputs(torch, gen, 32), 1)
    stage1 = dict(PRESETS["unrealego_heatmap_joint"], use_amp=False,
                  data_parallel=2)
    feed1 = {"input_rgb": torch.randn(16, 2, 256, 256, 3, generator=gen,
                                      device="cuda"),
             **{f"gt_heatmap_{s}": torch.rand(16, 64, 64, 15, generator=gen,
                                              device="cuda")
                for s in ("left", "right")}}
    jobs["stage 1"] = dp_job(torch, out, "stage1", stage1, HeatmapTask,
                             feed1, 2)
    # the CLIs over two ranks on phase 8's dataset, one epoch, in the same
    # ranks after the steps
    argv = (["--preset", "egotap_unrealego"] + cli_common(cli_tmp)
            + ["--niter_decay", "0", "--experiment_name", "dp2"])
    wall = run_dryrun(["--out", out, "--mode", "step", "cli", "--control"]
                      + [a for job in jobs.values() for a in job["args"]]
                      + ["--", *argv, "--data_parallel", "2"])
    print(f"  2 gloo ranks on cuda:0: both steps and their controls, then "
          f"cli.train + cli.test, in {wall:.1f} s wall (processes "
          f"included)")
    for j, (label, job) in enumerate(jobs.items()):
        after = job["after"]
        ranks = [torch.load(os.path.join(out, f"rank{r}_{j}.pt"),
                            weights_only=True) for r in range(2)]
        controls = [torch.load(os.path.join(out, f"control{r}_{j}.pt"),
                               weights_only=True) for r in range(2)]
        got = ranks[0]
        if label == "stage 2":
            counts[torch.float32] = {"launches": got["launches"],
                                     "heads": got["heads"]}
        gap = max(loss_gap(k, got["losses"][k], v)
                  for k, v in job["losses"].items())
        mine = torch.cat([got["grads"][k].float().flatten()
                          for k, has in job["names"].items() if has])
        rel = float((mine - job["flat"]).norm() / job["flat"].norm())
        rank0 = saved_state(got)
        apart = differing(saved_state(ranks[1]), rank0)

        def stats_dev(tensors):
            return max(float((tensors[k].float() - v.float()).abs().max())
                       for k, v in after.items()
                       if k.endswith(("running_mean", "running_var")))
        dev = stats_dev(rank0)
        cdev = stats_dev(saved_state(controls[0]))
        pdev = max(float((rank0[k].float() - v.float()).abs().max())
                   for k, v in after.items() if v.is_floating_point())
        print(f"  {label} f32, 2 ranks x {job['rows'] // 2} rows vs one "
              f"process: loss gap {gap:.3e} (rtol {TRAIN_LOSS_RTOL:.0e}), "
              f"gradient rel-L2 {rel:.3e} (tol {TRAIN_GRAD_TOL:.0e}), "
              f"state max dev {pdev:.3e}, running stats {dev:.3e} (tol "
              f"{STATE_ATOL:.0e}); ranks apart in {len(apart)} tensors; "
              f"rank 0's step {got['seconds']:.3f} s (a fresh process's "
              f"first), the control's after it {controls[0]['seconds']:.3f}"
              f" s; launches "
              f"{got['launches']} [{card}; one card shared by two ranks, "
              f"no multi-GPU result]")
        if gap > TRAIN_LOSS_RTOL or rel > TRAIN_GRAD_TOL or apart \
                or dev > STATE_ATOL:
            raise AssertionError(f"2-rank {label} step disagrees")
        print(f"    control, BatchNorm statistics per rank: running stats "
              f"{cdev:.3e} -> "
              f"{'rejected' if cdev > STATE_ATOL else 'NOT rejected  FAIL'}")
        if not cdev > STATE_ATOL:
            raise AssertionError(f"{label}: the per-rank control passed")
    del jobs
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt"),
                        weights_only=True) for r in range(2)]
    cfg = Config.from_args(argv)
    exp = cfg.experiment_dir
    check_run_artifacts(cfg, epochs=1)
    lines = [json.loads(x) for x in
             open(os.path.join(exp, "summary", "metrics.jsonl"))]
    entries = [(x["tag"], x["step"]) for x in lines]
    files = sorted(os.listdir(exp))
    pred = np.load(os.path.join(cfg.results_dir, "pred_pose.npy"))
    print(f"  2-rank cli.train + cli.test: files "
          f"{files}, {len(entries)} summary entries, pred_pose.npy "
          f"{pred.shape}; test means {ranks[0]['metrics']}, "
          f"{ranks[0]['pairs_per_s']:.1f} pairs/s over both ranks; "
          f"launches on rank 0 {ranks[0]['launches']} [{card}; one card "
          f"shared by two ranks]")
    if (len(entries) != len(set(entries))
            or ranks[0]["metrics"] != ranks[1]["metrics"]
            or pred.shape != (2 * CLI_FRAMES, 16, 3)):
        raise AssertionError("2-rank CLI run: files or metrics")
    shard = functools.partial(make_loader, rank=0, world=2)
    expect_counts(ranks[0]["launches"], PER_UNIT[cfg.model],
                  cli_units(cfg, shard, 1) + cli_units(cfg, shard, 0),
                  "2-rank cli.train + cli.test, rank 0", None,
                  PER_STEP_BACKWARD[cfg.model], len(shard(cfg, "train")),
                  PER_EVAL_BATCH[cfg.model],
                  cli_eval_batches(cfg, shard, 1)
                  + cli_eval_batches(cfg, shard, 0))
    one, _ = cli_test.main(argv)
    worst = max(abs(ranks[0]["metrics"][k] - v) / abs(v)
                for k, v in one.items())
    print(f"  1-rank cli.test on the same ckpt_best: {one}; largest "
          f"relative gap {worst:.3e} (tol {CLI_RTOL:.0e})")
    if worst > CLI_RTOL:
        raise AssertionError("2-rank and 1-rank test means disagree")
    empty_cache(torch)
    return counts


def attention_tp_rows(torch, F, card):
    """Kernel B at a tensor-parallel shard's shape, (16, 576, 512) with 4
    heads (a data shard's 16 rows, half the heads), within ``TOL`` of its
    plain version, timed, in both dtypes."""
    from egotap_tpu_torch.ops.attention import (TOL, attention_packed_plain,
                                                multihead_attention_packed)
    g = torch.Generator(device="cuda").manual_seed(33)
    b, s, heads, hd = 16, 576, 4, 128
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(b, s, heads * hd, generator=g,
                               device="cuda").to(dt) for _ in range(3))
        reads = reading(f"attention {dt} {(b, s, heads * hd)}, {heads} heads",
                        multihead_attention_packed(q, k, v, heads),
                        attention_packed_plain(q, k, v, heads), TOL[dt])
        split = [x.view(b, s, heads, hd).transpose(1, 2) for x in (q, k, v)]
        ms = time_ms(torch, lambda: multihead_attention_packed(q, k, v, heads))
        pms = time_ms(torch, lambda: attention_packed_plain(q, k, v, heads))
        lms = time_ms(torch, lambda: F.scaled_dot_product_attention(*split))
        bound, by = attention_bound(torch, q)
        print(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, SDPA {lms:.4f} "
              f"ms, bound {bound:.4f} ms [{card}]")
        rows[("attention_tp", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
            bound_by=by, **reads)
    return rows


def forward_ms(pred, rgb, calls=5):
    """Median wall time of ``calls`` requests after one warm-up, ms."""
    pred(rgb)
    t = []
    for _ in range(calls):
        t0 = time.perf_counter()
        pred(rgb)
        t.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(t)


def phase_sharded_serving(torch, F, card):
    """Phase 10 (c): kernel B at the shard's shape, then for f32, bf16
    and calibrated int8 one `Predictor` served unsharded, then after
    `shard(2, num_model=2, devices=[cuda:0] * 4)`, at batch 32 and a
    ragged 31, with the sharded forward's launches; the bf16 forward's
    time unsharded, over 2 x 2 and over 1 x 2 shards."""
    from egotap_tpu_torch.serving import Predictor
    rows = attention_tp_rows(torch, F, card)
    g = torch.Generator(device="cuda").manual_seed(34)
    rgb = torch.randn(32, 2, 256, 256, 3, generator=g, device="cuda")
    calib = [rgb + 0.1 * torch.randn(rgb.shape, generator=g, device="cuda")
             for _ in range(2)]
    devices = [torch.device("cuda", 0)] * (TP_DATA * TP_MODEL)
    counts, heads = {}, {}
    for label in ("f32", "bf16", "int8"):
        pred = Predictor(bf16=label != "f32", int8=label == "int8", seed=0)
        if label == "int8":
            pred.calibrate(calib)
        want, want31 = pred(rgb), pred(rgb[:31])
        times = {"unsharded": forward_ms(pred, rgb)}
        pred.shard(TP_DATA, num_model=TP_MODEL, devices=devices)
        pred(rgb)                                     # warm-up
        torch.cuda.synchronize()
        reset_counts()
        got = pred(rgb)
        counts[label], heads[label] = read_counts(), read_head_counts()
        want_heads = {8 // TP_MODEL: PER_TP_FORWARD["attention"]}
        per_forward = (per_tp_int8_forward() if label == "int8"
                       else PER_TP_FORWARD)
        if counts[label] != per_forward or heads[label] != want_heads:
            raise AssertionError(
                f"sharded {label}: launches {counts[label]}, kernel B by "
                f"heads {heads[label]}, expected {per_forward}, "
                f"{want_heads}")
        ragged = pred(rgb[:31])
        err, scale = max_dev(got, want)
        err31, scale31 = max_dev(ragged, want31)
        times["2 x 2"] = forward_ms(pred, rgb)
        print(f"  {label}: sharded 2 data x 2 model vs unsharded: batch 32 "
              f"max_abs_err {err:.3e}, ragged 31 {err31:.3e} (tol "
              f"{SHARD_TOL[label]:.0e} x max {scale:.3e}); launches a "
              f"forward {counts[label]}, kernel B by heads {heads[label]}; "
              f"forward median "
              f"{times['unsharded']:.3f} ms unsharded, {times['2 x 2']:.3f} "
              f"ms sharded [{card}; 4 shards on one card, no multi-GPU "
              f"result]")
        if err > SHARD_TOL[label] * scale or \
                err31 > SHARD_TOL[label] * scale31 or ragged.shape[0] != 31:
            raise AssertionError(f"sharded {label} disagrees")
        if label == "bf16":
            ms = forward_ms(pred.shard(1, num_model=TP_MODEL,
                                       devices=devices[:TP_MODEL]), rgb)
            print(f"    bf16 tensor-parallel 1 data x 2 model shards: "
                  f"{ms:.3f} ms, {100 * (ms / times['unsharded'] - 1):+.1f}% "
                  f"over unsharded [{card}]")
        del pred
        empty_cache(torch)
    return rows, {"launches": counts, "heads": heads}


def phase_parallel(torch, F, card, tmp):
    """Phase 10 (see the module docstring): (a) bridges, (b) data
    parallelism, (c) sharded serving, each part timed."""
    import os
    parts = {}
    t0 = time.perf_counter()
    phase_bridges(torch, card, os.path.join(tmp, "p10"))
    parts["bridges"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dp_counts = phase_data_parallel(torch, card, os.path.join(tmp, "p10"),
                                    tmp)
    parts["data parallel"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, tp_counts = phase_sharded_serving(torch, F, card)
    parts["sharded serving"] = time.perf_counter() - t0
    print("  phase 10 parts: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()))
    return {"rows": rows, "dp_counts": dp_counts, "tp_counts": tp_counts}


# the Bottleneck nets and the fused net at full width (phase 11): resnet50
# and resnet101 heatmap nets behind the serving configuration's lifter
# (UnrealEgo, Grid-ViT 1024 x 3 x 8 heads, PU hidden 512), seeded weights
BOTTLENECK_BATCH = 32
# f32 heatmap stacks of the resnet50 nets, card vs CPU at batch 1 on 128 x
# 128 images (the full-size CPU forward of ~830M parameters is too slow
# for the script), relative to max|cpu|: phase 3's limit
HEATMAP_CPU_TOL = 1e-4
# the fused net against the two separate nets, f32: the JAX package's own
# bound (tests/test_fused_heatmap.py:60), absolute; bf16 the heatmap
# net's bf16 budget (tests/test_torch_heatmap_net.py), relative to max
FUSED_ATOL_F32, FUSED_TOL_BF16 = 2e-4, 2e-2
# launches per fused forward: kernel A's three decoder calls (one grouped
# decoder for both nets)
# kernel E a forward of the Bottleneck nets (both trunks: the stem's and
# three a bottleneck, in int8 too)
E_PER_BOTTLENECK_FORWARD = {"resnet50": 2 * 49, "resnet101": 2 * 100}
PER_FUSED_FORWARD = {"upsample": 3, "attention": 0, "pu_chain": 0,
                     "attention_unpacked": 0, "fused_layer1": 0,
                     "pu_chain_backward": 0, "bn_act": E_PER_NET,
                     "int8_pack": 0, "int8_epilogue": 0}
# the legacy encoder / decoder and the S2D-stem encoder, f32 card vs CPU,
# relative to max|cpu| (phase 3's limit); the S2D stem vs the plain stem
# of the same weight on the card (the same products, summed in another
# order)
LEGACY_CPU_TOL, S2D_TOL = 1e-4, 1e-5


def rel_dev(got, ref):
    """max|got - ref| / max|ref| of two tensors or arrays, on the host."""
    import numpy as np
    got, ref = (np.asarray(t.float().cpu() if hasattr(t, "cpu") else t,
                           np.float64) for t in (got, ref))
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def bottleneck_serving(torch, card):
    """Phase 11 (a): resnet50 `Predictor`s in bf16, f32 and calibrated
    int8 serve 3 requests each (launches A 6, B 3, C 1, D 0 a forward),
    held to one another and, in f32 at batch 1 on 128 x 128 images, to
    the same nets on the CPU; then a resnet101 bf16 `Predictor`."""
    import copy
    from egotap_tpu_torch.serving import Predictor, heatmap_stack
    g = torch.Generator().manual_seed(41)
    rgb = torch.randn(BOTTLENECK_BATCH, 2, 256, 256, 3, generator=g)
    rgb_dev = rgb.cuda()
    small = torch.randn(1, 2, 128, 128, 3, generator=g)
    gc = torch.Generator(device="cuda").manual_seed(42)
    calib = [rgb_dev + 0.1 * torch.randn(rgb_dev.shape, generator=gc,
                                         device="cuda") for _ in range(2)]
    launches, outputs = {}, {}
    for label, name, precision in (("bf16", "resnet50", "bf16"),
                                   ("f32", "resnet50", "f32"),
                                   ("int8", "resnet50", "int8"),
                                   ("resnet101 bf16", "resnet101", "bf16")):
        t0 = time.perf_counter()
        pred = Predictor(bf16=precision != "f32", int8=precision == "int8",
                         device="cuda", seed=0, model_name=name)
        if label == "int8":
            pred.calibrate(calib)
        torch.cuda.synchronize()
        params = sum(p.numel() for n in pred.nets[:2]
                     for p in n.parameters())
        print(f"  {name} {precision}: Predictor built in "
              f"{time.perf_counter() - t0:.2f} s, heatmap nets "
              f"{params / 1e6:.1f}M parameters")
        launches[label], outputs[label] = serve(
            torch, pred, rgb_dev, f"{name} {precision}", card,
            per_forward=dict(PER_FORWARD,
                             bn_act=E_PER_BOTTLENECK_FORWARD[name],
                             **(f_per_int8_forward(name) if label == "int8"
                                else {})))
        if label == "f32":
            got = pred.heatmaps(small.cuda())
            cpu_nets = [copy.deepcopy(n).cpu() for n in pred.nets[:2]]
            t0 = time.perf_counter()
            want = heatmap_stack(*cpu_nets, small, torch.float32)
            err = rel_dev(got, want)
            print(f"  f32 heatmap stack card vs CPU, batch 1 at 128 x 128: "
                  f"{tuple(want.shape)}, max err {err:.3e} of max|cpu| "
                  f"(tol {HEATMAP_CPU_TOL:.0e}; CPU forward "
                  f"{time.perf_counter() - t0:.2f} s)")
            if not err <= HEATMAP_CPU_TOL:
                raise AssertionError("resnet50 heatmaps: card and CPU "
                                     "disagree")
            del cpu_nets
        del pred
        empty_cache(torch)
    for label, ref, tol in (("bf16", "f32", BF16_POSE_TOL),
                            ("int8", "bf16", INT8_POSE_TOL)):
        err = rel_dev(outputs[label], outputs[ref])
        print(f"  resnet50 {label} vs {ref} pose: {err:.3e} of max "
              f"(tol {tol:.0e})")
        if not err <= tol:
            raise AssertionError(f"resnet50 {label} and {ref} disagree")
    return launches


def bottleneck_train1(torch, card):
    """Phase 11 (b): `HeatmapTask.train_step` with the joint preset and a
    resnet50 net (bf16 amp, batch 16, 12 steps on a fixed batch; A 3 a
    step and 3 backward recomputes), then one f32 step of batch 2 on 128
    x 128 images card vs CPU with its control."""
    state, feed, run = train1_run(torch, STAGE1_PRESETS[0], card,
                                  model_name="resnet50")
    del state, feed
    empty_cache(torch)
    # the decoder's gradient: the trunk's is not a continuous function of
    # rounding at these weights (the same step in f64 on the card and on
    # the CPU reads 1.1e-2 apart, f32 card vs CPU 1.5e-2)
    train1_card_vs_cpu(torch, card, held="after_backbone.",
                       model_name="resnet50", load_size_heatmap=(32, 32))
    empty_cache(torch)
    return run


def fused_net(torch, card):
    """Phase 11 (c): `FusedHeatmapUNet` built by `fuse_heatmap_variables`
    from the two resnet18 nets of phase 3's `Predictor`, at (32, 2, 256,
    256, 3) in f32 and bf16, against the separate nets; launches; the
    fused and separate forwards timed."""
    from egotap_tpu_torch.models.heatmap_net import (FusedHeatmapUNet,
                                                     fuse_heatmap_variables)
    from egotap_tpu_torch.serving import (Predictor, cast_matmul_weights,
                                          heatmap_stack)
    g = torch.Generator(device="cuda").manual_seed(43)
    rgb = torch.randn(BOTTLENECK_BATCH, 2, 256, 256, 3, generator=g,
                      device="cuda")
    counts = {}
    for label, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pred = Predictor(bf16=dt == torch.bfloat16, device="cuda", seed=0)
        pos, rot = pred.nets[:2]
        cfg = pred.cfg
        fused = FusedHeatmapUNet((cfg.num_heatmap,
                                  cfg.num_rot_heatmap * cfg.limb_dim),
                                 cfg.model_name, cfg.views)
        fused.load_state_dict(fuse_heatmap_variables(
            [pos.state_dict(), rot.state_dict()]), strict=True)
        fused.eval().cuda()
        cast_matmul_weights(fused, dt)
        x = rgb.to(dt)
        want = heatmap_stack(pos, rot, rgb, dt)
        fused(x)
        torch.cuda.synchronize()
        reset_counts()
        got = fused(x)
        counts[label] = read_counts()
        if counts[label] != PER_FUSED_FORWARD:
            raise AssertionError(f"fused {label}: launches {counts[label]}")
        if dt == torch.float32:
            err = float((got - want).abs().max())
            ok, tol = err <= FUSED_ATOL_F32, f"{FUSED_ATOL_F32:.0e} absolute"
        else:
            err = rel_dev(got, want)
            ok, tol = err <= FUSED_TOL_BF16, f"{FUSED_TOL_BF16:.0e} of max"
        fms = time_ms(torch, lambda: fused(x), iters=5)
        sms = time_ms(torch, lambda: heatmap_stack(pos, rot, rgb, dt),
                      iters=5)
        print(f"  fused {label} {tuple(got.shape)} vs the separate nets: "
              f"max dev {err:.3e} (tol {tol}); launches {counts[label]}; "
              f"forward fused {fms:.3f} ms, separate {sms:.3f} ms [{card}]")
        if not ok:
            raise AssertionError(f"fused {label} and the separate nets "
                                 "disagree")
        del pred, fused, pos, rot
        empty_cache(torch)
    return counts


def legacy_and_s2d(torch, card):
    """Phase 11 (e): `ConvHeatmapEncoder` on the serving heatmap stack's
    shape, `HeatmapDecoder`, and the S2D-stem resnet18 encoder, f32 card
    vs CPU; the S2D stem vs the plain stem on the card."""
    import copy
    import torch.nn.functional as F
    from egotap_tpu_torch.models.encoders import (ConvHeatmapEncoder,
                                                  HeatmapDecoder)
    from egotap_tpu_torch.models.resnet import ResNetEncoder
    from egotap_tpu_torch.serving import init_weights
    gen = torch.Generator().manual_seed(44)
    cases = [("ConvHeatmapEncoder", ConvHeatmapEncoder(90),
              torch.randn(BOTTLENECK_BATCH, 64, 64, 90, generator=gen)),
             ("HeatmapDecoder", HeatmapDecoder(128, 15),
              torch.randn(BOTTLENECK_BATCH, 128, generator=gen)),
             ("resnet18 encoder, S2D stem",
              ResNetEncoder("resnet18", stem_s2d=True),
              torch.randn(4, 256, 256, 3, generator=gen))]
    for name, module, x in cases:
        init_weights(module, gen)
        module.eval()
        want = module(x)
        card_module = copy.deepcopy(module).cuda()
        got = card_module(x.cuda())
        if isinstance(want, list):
            got, want = got[-1], want[-1]
        err = rel_dev(got, want)
        print(f"  {name}: {tuple(got.shape)}, card vs CPU {err:.3e} of "
              f"max (tol {LEGACY_CPU_TOL:.0e})")
        if not err <= LEGACY_CPU_TOL:
            raise AssertionError(f"{name}: card and CPU disagree")
    stem = card_module.conv1
    x = torch.randn(64, 256, 256, 3, generator=gen).cuda()
    plain = F.conv2d(x.permute(0, 3, 1, 2), stem.weight, None, 2, 3
                     ).permute(0, 2, 3, 1)
    err = rel_dev(stem(x), plain)
    s2d_ms = time_ms(torch, lambda: stem(x), iters=5)
    plain_ms = time_ms(torch, lambda: F.conv2d(
        x.permute(0, 3, 1, 2), stem.weight, None, 2, 3), iters=5)
    print(f"  S2D stem vs the plain stem on (64, 256, 256, 3): {err:.3e} of "
          f"max (tol {S2D_TOL:.0e}); {s2d_ms:.3f} ms against {plain_ms:.3f} "
          f"ms [{card}]")
    if not err <= S2D_TOL:
        raise AssertionError("the S2D stem and the plain stem disagree")


def upsample_rows_fresh(torch, card):
    """Phase 11 (d) in a process of its own (the kernels already built):
    after phase 10 the profiler of this process showed 0 and 2 of 20
    launches of kernel A on an H100, so the device time of a launch is
    read where nothing ran before. Its output is printed here; returns
    the rows of `upsample_rows`."""
    import os
    code = ("import json, sys, torch, torch.nn.functional as F\n"
            "import chip_smoke as c\n"
            "torch.set_grad_enabled(False)\n"
            "g = torch.Generator(device='cuda').manual_seed(45)\n"
            "rows = c.upsample_rows(torch, F, sys.argv[1], 'upsample_r50',\n"
            "                       c.RESNET50_SHAPES, g)\n"
            "print(json.dumps([[str(dt), r] for (_, dt), r in rows.items()]))"
            "\n")
    out = subprocess.run([sys.executable, "-c", code, card], text=True,
                         capture_output=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = out.stdout.strip().splitlines()
    print("\n".join(lines[:-1]))
    if out.returncode != 0:
        raise AssertionError(f"kernel A at resnet50 widths: exit "
                             f"{out.returncode}\n{out.stderr[-4000:]}")
    dtypes = {str(dt): dt for dt in (torch.float32, torch.bfloat16)}
    return {("upsample_r50", dtypes[dt]): r
            for dt, r in json.loads(lines[-1])}


def phase_bottleneck(torch, card):
    """Phase 11 (see the module docstring), each part timed."""
    parts = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        parts[name] = time.perf_counter() - t0
        return result
    rows = timed("kernel A", upsample_rows_fresh, torch, card)
    serving = timed("serving", bottleneck_serving, torch, card)
    with torch.enable_grad():
        stage1 = timed("stage 1", bottleneck_train1, torch, card)
    fused = timed("fused", fused_net, torch, card)
    timed("legacy and S2D", legacy_and_s2d, torch, card)
    print("  phase 11 parts: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()))
    return {"serving": serving, "stage1": stage1, "fused": fused,
            "rows": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from egotap_tpu_torch.ops import _build
    torch.set_grad_enabled(False)              # inference only

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    card = smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    print("phase 1: build")
    t0 = time.perf_counter()
    logs = _build.build_all()
    for name in _build.SIGNATURES:
        _build.library(name)
    print(f"  built {list(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    print("phase 2: kernels beside their plain versions on the card: "
          "times, bounds, readings")
    rows = phase_kernels(torch, F, card)

    print("phase 3: full serving path, batch 32, bf16, f32 and int8")
    served = phase_full_path(torch, card)

    print("phase 4: entry points off the Predictor's path")
    fused, unpacked = phase_entry_points(torch, card)

    print("phase 5: stage-2 training step, full width, batch 32, bf16; "
          "f32 card vs CPU at batch 2")
    train = phase_train(torch, card)

    print("phase 6: eval step with pose metrics, int8 serving "
          "configuration, batch 32")
    evaluation = phase_eval(torch, card)

    print("phase 7: stage-1 training step, full width, batch 16, bf16, "
          "both presets; targets, eval and an f32 step card vs CPU")
    with torch.enable_grad():
        stage1 = phase_train1(torch, card)

    with tempfile.TemporaryDirectory() as tmp:
        print("phase 8: the train and test CLIs end to end, full width: "
              "stage 1 (joint, limb), stage 2 warm-started from both, test")
        cli = phase_cli(torch, card, tmp)

        print("phase 9: the lifter's other skeleton layers and the "
              "learned-LR optimizers, full width: serving, training, CLIs")
        variants = phase_variants(torch, card, tmp)

        print("phase 10: bridges for a trained model and parallelism, full "
              "width: checkpoint, export, optimizer resume, partial "
              "weights; one NCCL rank, two gloo ranks on cuda:0; sharded "
              "serving")
        t10 = time.perf_counter()
        parallel = phase_parallel(torch, F, card, tmp)
        print(f"  phase 10 in {time.perf_counter() - t10:.1f} s")

    print("phase 11: the Bottleneck nets (resnet50, resnet101) and the "
          "fused net, full width: serving, stage 1, kernel A at resnet50 "
          "widths, the legacy encoder and decoder, the S2D stem")
    t11 = time.perf_counter()
    bottleneck = phase_bottleneck(torch, card)
    print(f"  phase 11 in {time.perf_counter() - t11:.1f} s")
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    # launches of each row: the int8 forward's (bf16 compute) for the bf16
    # rows, the f32 forward's for the f32 attention and PU chain rows, and
    # the entry points' own calls for kernel D and the unpacked wrapper
    launches = {(n, torch.bfloat16): c for n, c in served["int8"].items()
                if n != "pu_chain_backward"}     # in C's rows (phase 5)
    for n in ("attention", "pu_chain", "bn_act"):
        launches[(n, torch.float32)] = served["f32"][n]
    # kernel E: the bf16 forward's (the int8 one runs the stems' alone)
    launches[("bn_act", torch.bfloat16)] = served["bf16"]["bn_act"]
    launches[("fused_layer1", torch.bfloat16)] = fused
    for dt, c in unpacked.items():
        launches[("attention_unpacked", dt)] = c
    # phase 10's measured launches by dtype: one data-parallel step (bf16:
    # the NCCL rank's; f32: gloo rank 0's stage-2 step) and one sharded
    # forward (bf16: the bf16 one; f32: the f32 one), kernel B's split by
    # head count: 8 for the model's own rows, 8 / TP_MODEL for a
    # tensor-parallel shard's
    rows.update(parallel["rows"])
    dp = parallel["dp_counts"]
    tp = {dt: {k: v[label] for k, v in parallel["tp_counts"].items()}
          for dt, label in ((torch.bfloat16, "bf16"),
                            (torch.float32, "f32"))}

    def launched(run, key):
        heads = {"attention": 8, "attention_tp": 8 // TP_MODEL}
        if key in heads:
            return run["heads"].get(heads[key], 0)
        return run["launches"][key]
    for dt in (torch.float32, torch.bfloat16):
        launches[("attention_tp", dt)] = launched(tp[dt], "attention_tp")

    meta = {
        "upsample": ("upsample2x_align_corners", "cuda",
                     "egotap_tpu_torch/csrc/upsample.cu",
                     "egotap_tpu/ops/upsample.py:98"),
        "attention": ("attention_packed", "cuda",
                      "egotap_tpu_torch/csrc/attention.cu",
                      "egotap_tpu/ops/attention.py:122"),
        "pu_chain": ("pu_chain", "cuda", "egotap_tpu_torch/csrc/pu_chain.cu",
                     "egotap_tpu/ops/pu_kernel.py:74"),
        "attention_unpacked": ("attention_unpacked", "cuda",
                               "egotap_tpu_torch/csrc/attention.cu",
                               "egotap_tpu/ops/attention.py:43"),
        "attention_tp": ("attention_packed_4heads", "cuda",
                         "egotap_tpu_torch/csrc/attention.cu",
                         "egotap_tpu/ops/attention.py:122"),
        "fused_layer1": ("fused_layer1_int8", "cuda",
                         "egotap_tpu_torch/csrc/fused_layer1.cu",
                         "egotap_tpu/ops/fused_layer1.py:121"),
        "bn_act": ("bn_act", "cuda", "egotap_tpu_torch/csrc/bn_act.cu",
                   "none (XLA fuses the eval BatchNorm, add and ReLU)"),
        "int8_pack": ("int8_pack", "cuda",
                      "egotap_tpu_torch/csrc/int8_pack.cu",
                      "none (XLA fuses the quantise and im2col)"),
        "int8_epilogue": ("int8_epilogue", "cuda",
                          "egotap_tpu_torch/csrc/int8_pack.cu",
                          "none (XLA fuses the dequantise)"),
    }
    kernels = []
    for (key, dt), count in launches.items():
        name, route, source, replaces = meta[key]
        r = rows[(key, dt)]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": count,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": str(dt).removeprefix("torch.")})
        for extra in ("max_rel_err", "rms_rel_err", "unfused_ms",
                      "device_ms", "latency_floor_ms"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        if key == "bn_act":
            label = "bf16" if dt == torch.bfloat16 else "f32"
            if dt == torch.bfloat16:
                kernels[-1]["int8_serve_launches"] = served["int8"][key]
            kernels[-1]["resnet50_serve_launches"] = \
                bottleneck["serving"][label][key]
        # the training step (bf16) and the eval step run the bf16 kernels
        # (B at 8 heads)
        if dt == torch.bfloat16 and key != "attention_tp":
            kernels[-1]["train_step_launches"] = \
                train["counts"][key] / TRAIN_STEPS
            kernels[-1]["eval_step_launches"] = evaluation[key]
        if key == "attention" and (key, dt) in train["backward"]:
            kernels[-1]["backward_ms"] = train["backward"][(key, dt)]
        if key == "pu_chain":             # C's backward kernel, phase 5
            kernels[-1].update({f"backward_{k}": v for k, v in
                                train["backward"][(key, dt)].items()})
            kernels[-1]["train_step_backward_launches"] = \
                train["counts"]["pu_chain_backward"] / TRAIN_STEPS
            kernels[-1]["dp_train_step_backward_launches"] = \
                dp[dt]["launches"]["pu_chain_backward"]
        # the CLI runs of phase 8 (training in bf16, cli.test in f32)
        if dt == torch.bfloat16 and (
                key in PER_UNIT["egotap_autoencoder"]
                or key in PER_EVAL_BATCH["egotap_autoencoder"]):
            kernels[-1]["cli_launches"] = {run: c[key]
                                           for run, c in cli.items()}
        # phase 9: the LSTM lifter's training step (bf16) and its CLI runs
        if dt == torch.bfloat16 and key != "attention_tp":
            kernels[-1]["lstm_train_step_launches"] = \
                variants["train_counts"][key] / TRAIN_STEPS
            kernels[-1]["lstm_cli_launches"] = {
                run: c[key] for run, c in variants["cli"].items()}
        # phase 10: a data-parallel step and a sharded forward over 2 data
        # x 2 model shards, in the row's dtype
        kernels[-1]["dp_train_step_launches"] = launched(dp[dt], key)
        kernels[-1]["tp_serve_launches"] = launched(tp[dt], key)
        # stage 1 trains in bf16: A's launches a step and its backward
        if (key, dt) == ("upsample", torch.bfloat16):
            kernels[-1]["train1_step_launches"] = \
                stage1["counts"][key] / TRAIN_STEPS
            kernels[-1]["backward_ms"] = stage1["backward"]
    # phase 11: kernel A at the resnet50 decoder's widths, launched by the
    # resnet50 forwards (bf16 row: the int8 serving forward's, as above;
    # f32: the f32 forward's) and the resnet50 stage-1 steps
    served = bottleneck["serving"]
    for dt, label in ((torch.float32, "f32"), (torch.bfloat16, "int8")):
        r = bottleneck["rows"][("upsample_r50", dt)]
        kernels.append({
            "name": "upsample2x_align_corners_resnet50", "route": "cuda",
            "source": "egotap_tpu_torch/csrc/upsample.cu",
            "replaces": "egotap_tpu/ops/upsample.py:98",
            "launches": served[label]["upsample"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": str(dt).removeprefix("torch."),
            "device_ms": r["device_ms"], "max_rel_err": r["max_rel_err"],
            "rms_rel_err": r["rms_rel_err"]})
        if dt == torch.bfloat16:
            kernels[-1]["resnet101_serve_launches"] = \
                served["resnet101 bf16"]["upsample"]
            kernels[-1]["train1_step_launches"] = \
                bottleneck["stage1"]["counts"]["upsample"] / TRAIN_STEPS
            kernels[-1]["fused_serve_launches"] = \
                bottleneck["fused"]["bf16"]["upsample"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
