#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check its kernels.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout (it imports
``egotap_tpu_torch``; it imports nothing of JAX or ``egotap_tpu``).
Exits non-zero, printing no result, when there is no card. Phases:

1. Print the card's name and power limit; build every kernel from
   ``egotap_tpu_torch/csrc`` (one ``nvcc`` per source, all at once).
2. Kernel vs plain version on the card, at the serving forward's shapes,
   in f32 and bf16: max and rms error relative to the plain output,
   each within the kernel module's ``TOL``; faulty variants of the plain
   version (a bf16 rounding skipped or added, f32 operands rounded to
   TF32, the last key chunk or a term dropped, one int8 scale for the
   whole batch or for each block's run of pixels instead of the image)
   must fall outside those limits; median CUDA-event times of the
   kernel, its plain version and a one-call PyTorch yardstick where one
   exists (never used by the port); before each kernel's timings, its
   registers, spill bytes and shared memory (``ptxas -v``) and the
   blocks of it one SM holds (for A its grid at each shape, for C its
   blocks and units a block, for D its cluster size and
   ``cudaOccupancyMaxActiveClusters``); for A, C and D the device time of
   a launch alone (torch.profiler), for C also of its walk with its grid
   barriers alone, its latency floor. Kernels:
   A upsample, B packed attention and B on the unpacked layout, C PU
   chain, D fused int8 layer1 (also timed against the unfused int8
   layer1 it replaces).
3. Full path: a full-width `Predictor` (UnrealEgo, resnet18, Grid-ViT
   width 1024 x 3 layers, PU hidden 512) with seeded random weights
   serves 3 requests of (32, 2, 256, 256, 3) in bf16, in f32 and in the
   int8 serving configuration (bf16 compute, int8 heatmap nets and
   lifter, static scales calibrated on 2 batches of rgb + 0.1 noise);
   the launch counters must rise by exactly 6 (upsample), 3 (attention)
   and 1 (PU chain) per forward; batch-2 f32 requests are cross-checked
   against the same port on the CPU (the int8 one under the card's
   static scales, free-running and with the card's int8 codes held
   against the CPU's and replaced by them, `CodeTape`), the bf16 poses
   against the f32 ones and the int8 poses against the bf16 ones.
4. Entry points off the Predictor's path: the int8 ResNet encoder with
   the fused layer1 (kernel D once per forward) on (64, 256, 256, 3)
   bf16 against the unfused int8 encoder, and one call of the unpacked
   attention wrapper at the Grid-ViT's (32, 8, 576, 128) in bf16 and
   in f32.
5. Stage-2 training at full width (`bench.py` train: the egotap_unrealego
   preset, UnrealEgo, resnet18 frozen nets, Grid-ViT 1024 x 3 layers x 8
   heads over 576 tokens, PU hidden 512, bf16 amp, AdamW under
   cos_anneal_warmup, batch 32): `LifterTask.train_step` 12 times from a
   seeded `init_state` on N(0, 1) rgb and poses; the median CUDA-event
   time of the last 10 and pairs/s; losses finite, lifter parameters
   moved (the ViT's query weights and the PU chain's top cell, reachable
   only through the backward of B and C), the frozen nets' parameters
   unchanged bit for bit and their running statistics moved, launches
   per step A 6, B 3, C 1, D 0; the backward recompute of B and C timed
   by events and inside one profiled step. Then one f32 step of batch 2
   on the card against the same step on the CPU (losses, and the
   lifter's flattened gradient by relative L2), and the same check
   rejecting a faulty control (B's output detached from the graph).
6. The eval step of the serving configuration (bf16, int8 heatmap nets
   and lifter calibrated by `prepare_inference` on 2 batches of rgb + 0.1
   noise, batch 32): launches as a forward, its pose equal bit for bit
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
   (mse_heatmap); kernel A's backward recompute a launch by events; one
   f32 step of batch 2 on the card against the CPU (losses, the UNet's
   gradient by relative L2) and the same check rejecting A's output
   detached from the graph.
8. One JSON line with every kernel's numbers (with each bf16 kernel's
   launches per training and eval step, A's per stage-1 step, and the
   backward recompute time a launch of A (stage 1), B and C), then the
   result line.
"""

import json
import math
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
INT8_TENSOR_OPS = 1979e12          # dense int8 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
TF32_TENSOR_FLOPS = 494.7e12       # dense TF32 tensor-core peak
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


def device_ms(torch, fn, kernel, iters=ITERS):
    """Median device time of one launch of the kernel whose name holds
    ``kernel``, one launch a call of ``fn``, under torch.profiler: the
    kernel alone, without its wrapper's host time and small allocations
    (a short kernel's CUDA-event time is its host time when the host is
    the slower side)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [evt.device_time_total / 1e3 for evt in prof.events()
             if evt.device_type == torch.autograd.DeviceType.CUDA
             and kernel in evt.name]
    # the trace may drop a few events (an H100 once showed 18 of 20
    # launches); more than asked for means another kernel matched
    if not iters // 2 <= len(times) <= iters:
        raise AssertionError(f"the profiler saw {len(times)} launches of "
                             f"{kernel}, not {iters}")
    return statistics.median(times)


def check(name, got, ref, tol, failures):
    """Hold a kernel's output against its plain version: max and rms
    error relative to the plain output, each within its limit."""
    from egotap_tpu_torch.ops import kernel_errors
    max_abs, max_rel, rms_rel = kernel_errors(got, ref)
    ok = max_rel <= tol[0] and rms_rel <= tol[1]
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(tol {tol[0]:.0e}) rms_rel_err={rms_rel:.3e} (tol {tol[1]:.0e})"
          f"{'' if ok else '  FAIL'}")
    if not ok:                             # also when not finite
        failures.append(name)
    return max_abs


def control(name, faulty, ref, tol, failures):
    """A deliberately faulty variant of the plain version: the limits that
    hold the kernel must reject it, or they could not catch that fault."""
    from egotap_tpu_torch.ops import kernel_errors
    _, max_rel, rms_rel = kernel_errors(faulty, ref)
    caught = max_rel > tol[0] or rms_rel > tol[1]
    print(f"    control, {name}: max_rel_err={max_rel:.3e} "
          f"rms_rel_err={rms_rel:.3e} -> "
          f"{'rejected' if caught else 'NOT rejected  FAIL'}")
    if not caught:
        failures.append(f"control {name}")


def tf32(torch, x):
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def attention_variant(torch, q, k, v, heads, rnd=None, keys=None):
    """The plain f32 attention formula on (B, S, H*Dh) with ``rnd``
    applied to both products' operands, over the first ``keys`` keys:
    the faulty f32 variants the kernel's limits must reject."""
    b, s, d = q.shape
    hd = d // heads
    rnd = rnd or (lambda x: x)

    def split(x):
        return x.reshape(b, -1, heads, hd).transpose(1, 2)
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32, device=q.device)
    scores = (rnd(split(q)) @ rnd(split(k[:, :keys])).transpose(-1, -2)) * scale
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    out = rnd(p) @ rnd(split(v[:, :keys]))
    return out.transpose(1, 2).reshape(b, s, d)


def attention_controls(torch, q, k, v, heads, ref, failures):
    """Kernel B's f32 controls: one TF32 rounding of the operands (what a
    3xTF32 product that lost its small parts computes), and the last key
    chunk (64 keys) left out of the softmax and of p v."""
    from egotap_tpu_torch.ops import attention
    tol = attention.TOL[torch.float32]
    control("operands rounded to TF32 once", attention_variant(
        torch, q, k, v, heads, rnd=lambda x: tf32(torch, x)), ref, tol,
        failures)
    last = (q.shape[1] - 1) // 64 * 64
    control("last key chunk dropped from the softmax", attention_variant(
        torch, q, k, v, heads, keys=last), ref, tol, failures)


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


def attention_bound(torch, q):
    """(bound ms, bound_by) of one kernel B launch on (B, S, H*Dh): bytes
    against operations at the dtype's peak; f32 runs 3xTF32, three TF32
    products for each (its bound on the CUDA cores is printed beside)."""
    flops = 4 * q.shape[0] * q.shape[1] ** 2 * q.shape[2]
    t_bytes = 4 * q.numel() * q.element_size() / HBM_BYTES_PER_S
    if q.dtype == torch.bfloat16:
        t_ops = flops / BF16_TENSOR_FLOPS
    else:
        t_ops = 3 * flops / TF32_TENSOR_FLOPS
        print(f"    f32 bounds: 3xTF32 {1e3 * t_ops:.4f} ms, CUDA cores "
              f"{1e3 * flops / F32_FLOPS:.4f} ms, bytes "
              f"{1e3 * t_bytes:.4f} ms")
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(torch, F, card):
    from egotap_tpu_torch.models.layers import BN_EPS
    from egotap_tpu_torch.models.resnet import BasicBlock
    from egotap_tpu_torch.ops import (attention, fused_layer1, pu_kernel,
                                      upsample)
    from egotap_tpu_torch.ops.attention import (attention_packed_plain,
                                                multihead_attention,
                                                multihead_attention_packed)
    from egotap_tpu_torch.ops.fused_layer1 import (fused_layer1_int8,
                                                   fused_layer1_plain,
                                                   pack_blocks)
    from egotap_tpu_torch.ops.quant import (Calibrated, f32_scalar, im2col,
                                            install_scales, int8_matmul,
                                            prequantize, quantized_conv,
                                            set_calibrating)
    from egotap_tpu_torch.serving import init_weights
    from egotap_tpu_torch.ops.pu_kernel import pu_chain_fused, pu_chain_plain
    from egotap_tpu_torch.ops.upsample import (upsample2x_align_corners,
                                               upsample2x_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows, failures = {}, []

    # ---- A: upsample at the decoder's three grids (one net's calls)
    shapes = [(32, 8, 8, 1024), (32, 16, 16, 1024), (32, 32, 32, 512)]
    for dt in (torch.float32, torch.bfloat16):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "bound_ms": 0.0, "device_ms": 0.0, "max_abs_err": 0.0}
        for shp in shapes:
            geo = upsample.launch_geometry(*shp, dt)
            res = upsample.kernel_resources(dt, geo["smem"])
            print(f"  upsample {dt} kernel at {shp}: grid {geo['grid']}, "
                  f"{geo['band']} output rows x {geo['cv']} vectors a block, "
                  f"{geo['staged']} input rows staged; ptxas "
                  f"{res['registers']} registers, {res['spill_store_bytes']} "
                  f"+ {res['spill_load_bytes']} bytes spill stores + loads; "
                  f"{res['smem_bytes']} bytes of shared memory a block of "
                  f"{res['threads']} threads, {res['blocks_per_sm']} blocks "
                  f"fit one SM")
            if (res["blocks_per_sm"] < 1
                    or res["registers"] != res["runtime_registers"]):
                raise AssertionError(f"{dt} upsample kernel resources: {res}")
            x = torch.randn(shp, generator=g, device=dev).to(dt)
            ref = upsample2x_plain(x)
            err = check(f"upsample {dt} {shp}", upsample2x_align_corners(x),
                        ref, upsample.TOL[dt], failures)
            if dt == torch.bfloat16:
                d = x.dim()
                rows_bf16 = upsample._lerp(x.float(), d - 3, shp[1]).to(dt)
                control("rows rounded to bf16 before the column pass",
                        upsample._lerp(rows_bf16.float(), d - 2, shp[2]
                                       ).to(dt), ref, upsample.TOL[dt],
                        failures)
            nchw = x.permute(0, 3, 1, 2)
            ms = time_ms(torch, lambda: upsample2x_align_corners(x))
            dms = device_ms(torch, lambda: upsample2x_align_corners(x),
                            "upsample2x_kernel")
            pms = time_ms(torch, lambda: upsample2x_plain(x))
            lms = time_ms(torch, lambda: F.interpolate(
                nchw, scale_factor=2, mode="bilinear", align_corners=True))
            nbytes = x.numel() * x.element_size() * 5     # read 1, write 4
            flops = 6 * 4 * x.numel()                     # 3 lerps / output
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
            print(f"    {shp}: kernel {ms:.4f} ms (its launch alone on the "
                  f"device {dms:.4f} ms), plain {pms:.4f} ms, F.interpolate "
                  f"{lms:.4f} ms, bound {bound:.4f} ms [{card}]")
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", bound), ("device_ms", dms)):
                tot[k] += v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        rows[("upsample", dt)] = dict(tot, bound_by="bytes")

    # ---- B: packed attention at the Grid-ViT's shape
    for dt in (torch.float32, torch.bfloat16):
        res = attention.kernel_resources(dt)
        print(f"  attention {dt} kernel: ptxas {res['registers']} registers, "
              f"{res['spill_store_bytes']} + {res['spill_load_bytes']} bytes "
              f"spill stores + loads, {res['static_smem_bytes']} bytes static "
              f"shared memory; a block of {res['threads']} threads takes "
              f"{res['smem_bytes']} bytes of shared memory and "
              f"{res['blocks_per_sm']} blocks fit one SM "
              f"({res['blocks_per_sm'] * res['threads'] // 32} of 64 warps)")
        if (res["blocks_per_sm"] < 1
                or res["registers"] != res["runtime_registers"]):
            raise AssertionError(f"{dt} attention kernel resources: {res}")
    b, s, heads, hd = 32, 576, 8, 128
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(b, s, heads * hd, generator=g,
                               device=dev).to(dt) for _ in range(3))
        ref = attention_packed_plain(q, k, v, heads)
        err = check(f"attention {dt} {(b, s, heads * hd)}",
                    multihead_attention_packed(q, k, v, heads), ref,
                    attention.TOL[dt], failures)
        if dt == torch.bfloat16:
            control("p left in f32 (not rounded to bf16 before p v)",
                    attention_packed_plain(q.float(), k.float(), v.float(),
                                           heads).to(dt),
                    ref, attention.TOL[dt], failures)
        else:
            attention_controls(torch, q, k, v, heads, ref, failures)
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
            max_abs_err=err, bound_by=by)

    # ---- C: PU chain at the lifter's shape
    b, J, H = 32, 15, 512
    for dt in (torch.float32, torch.bfloat16):
        res = pu_kernel.kernel_resources(dt, b, H)
        print(f"  pu_chain {dt} kernel: ptxas {res['registers']} registers, "
              f"{res['spill_store_bytes']} + {res['spill_load_bytes']} bytes "
              f"spill stores + loads; {res['blocks']} blocks of "
              f"{res['units']} units and {res['threads']} threads, "
              f"{res['smem_bytes']} bytes of shared memory a block "
              f"(k-chunk {res['kc']}, {res['ks']} k-splits), "
              f"{res['blocks_per_sm']} blocks fit one SM of {res['sms']}")
        if (res["blocks_per_sm"] < 1 or res["blocks"] > res["sms"]
                or res["registers"] != res["runtime_registers"]):
            raise AssertionError(f"{dt} PU chain kernel resources: {res}")

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
        ref = pu_chain_plain(fh, gp, w0, cell1)
        err = check(f"pu_chain {dt} B={b} J={J} H={H}",
                    pu_chain_fused(fh, gp, w0, cell1), ref,
                    pu_kernel.TOL[dt], failures)
        if dt == torch.bfloat16:
            f32_cell1 = {n: {"kernel": c["kernel"].float(), "bias": c["bias"]}
                         for n, c in cell1.items()}
            control("matrix operands left in f32 (not rounded to bf16)",
                    pu_chain_plain(fh, gp, w0.float(), f32_cell1), ref,
                    pu_kernel.TOL[dt], failures)
            no_rec = dict(cell1, h2h={"kernel": torch.zeros_like(
                cell1["h2h"]["kernel"]), "bias": cell1["h2h"]["bias"]})
            control("layer-1 recurrent product dropped",
                    pu_chain_plain(fh, gp, w0, no_rec), ref,
                    pu_kernel.TOL[dt], failures)
        ms = time_ms(torch, lambda: pu_chain_fused(fh, gp, w0, cell1))
        pms = time_ms(torch, lambda: pu_chain_plain(fh, gp, w0, cell1))
        dms = device_ms(torch, lambda: pu_chain_fused(fh, gp, w0, cell1),
                        "pu_chain_kernel")
        floor = device_ms(torch, lambda: pu_kernel.barrier_walk(b, J, H, dt,
                                                                dev),
                          "pu_chain_kernel")
        flops = 2 * b * H * 13 * H * J
        wbytes = (w0.numel() + sum(c["kernel"].numel() for c in cell1.values())
                  ) * w0.element_size()
        nbytes = wbytes + 4 * (fh.numel() + gp.numel() + fh.numel()
                               + sum(c["bias"].numel() for c in cell1.values()))
        peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        bound = 1e3 * max(t_ops, t_bytes)
        print(f"    kernel {ms:.4f} ms (its launch alone on the device "
              f"{dms:.4f} ms), plain {pms:.4f} ms, bound {bound:.4f} ms, "
              f"latency floor (the walk's {J + 1} grid barriers alone, on "
              f"the device) {floor:.4f} ms [{card}]")
        rows[("pu_chain", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=None, bound_ms=bound,
            max_abs_err=err, device_ms=dms, latency_floor_ms=floor,
            bound_by="operations" if t_ops >= t_bytes else "bytes")

    # ---- B on the unpacked (B, H, S, Dh) layout (`multihead_attention`)
    b, heads, s, hd = 32, 8, 576, 128
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(b, heads, s, hd, generator=g,
                               device=dev).to(dt) for _ in range(3))

        def plain_unpacked(q, k, v):
            flat = [x.reshape(b * heads, s, hd) for x in (q, k, v)]
            return attention_packed_plain(*flat, heads=1).reshape(q.shape)
        ref = plain_unpacked(q, k, v)
        err = check(f"attention unpacked {dt} {(b, heads, s, hd)}",
                    multihead_attention(q, k, v), ref, attention.TOL[dt],
                    failures)
        if dt == torch.bfloat16:
            control("p left in f32 (not rounded to bf16 before p v)",
                    plain_unpacked(q.float(), k.float(), v.float()).to(dt),
                    ref, attention.TOL[dt], failures)
        else:
            flat = [x.reshape(b * heads, s, hd) for x in (q, k, v)]
            attention_controls(torch, *flat, 1, ref.reshape(b * heads, s, hd),
                               failures)
        ms = time_ms(torch, lambda: multihead_attention(q, k, v))
        pms = time_ms(torch, lambda: plain_unpacked(q, k, v))
        lms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v))
        bound, by = attention_bound(torch, q.reshape(b * heads, s, hd))
        print(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, SDPA {lms:.4f} ms, "
              f"bound {bound:.4f} ms [{card}]")
        rows[("attention_unpacked", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
            max_abs_err=err, bound_by=by)

    # ---- D: fused int8 layer1 at one net's shape (batch 32 x 2 views);
    # image i scaled by 1 + i/8, so that the per-image scales differ
    blocks = torch.nn.Sequential(BasicBlock(64, 64, quant=True),
                                 BasicBlock(64, 64, quant=True))
    init_weights(blocks, torch.Generator().manual_seed(2))
    blocks.to(dev).eval()
    wq, ws, bias = pack_blocks(blocks, BN_EPS)
    n, hw, c = 64, 64, 64
    ramp = 1 + torch.arange(n, device=dev)[:, None, None, None] / 8

    def one_scale_per_batch(x):
        """The stage with one dynamic int8 scale per conv for the whole
        batch (the generic `quantized_conv`), instead of one per image."""
        act = res = x.float()
        for i in range(wq.shape[0]):
            w = wq[i].reshape(3, 3, c, c).permute(3, 2, 0, 1)
            out = quantized_conv(act, w, ws[i], 1, 1, bias[i])
            act = torch.relu(out if i % 2 == 0 else out + res)
            res = act if i % 2 else res
        return act.to(x.dtype)

    geo = fused_layer1.cluster_geometry(hw, hw)
    pb = geo["pixels"]

    def one_scale_per_band(x):
        """The stage with one scale per block's run of pixels (its rows)
        instead of one per image: the fault a cluster design can make."""
        act = res = x.float()
        for i in range(wq.shape[0]):
            band = act.reshape(n, -1, pb * c).abs().amax(dim=2)  # (n, cl)
            a_scale = (torch.clamp_min(band, 1e-12) / f32_scalar(act, 127.0)
                       ).repeat_interleave(pb, dim=1).reshape(n, hw, hw, 1)
            codes = torch.round(act / a_scale).clamp_(-127, 127).to(
                torch.int8)
            cols, _ = im2col(codes, 3, 1, 1)
            acc = int8_matmul(cols, wq[i].t()).reshape(n, hw, hw, c)
            out = acc.float() * (a_scale * ws[i]) + bias[i]
            act = torch.relu(out if i % 2 == 0 else out + res)
            res = act if i % 2 else res
        return act.to(x.dtype)

    for dt in (torch.float32, torch.bfloat16):
        res = fused_layer1.kernel_resources(dt, hw, hw)
        print(f"  fused_layer1 {dt} kernel: ptxas {res['registers']} "
              f"registers, {res['spill_store_bytes']} + "
              f"{res['spill_load_bytes']} bytes spill stores + loads; "
              f"clusters of {res['cluster']} blocks of {res['pixels']} "
              f"pixels and {res['threads']} threads, {res['smem_bytes']} "
              f"bytes of shared memory a block, {res['blocks_per_sm']} "
              f"blocks fit one SM of {res['sms']}; "
              f"cudaOccupancyMaxActiveClusters {res['max_active_clusters']}")
        if (res["max_active_clusters"] < 1
                or res["registers"] != res["runtime_registers"]):
            raise AssertionError(f"{dt} fused layer1 kernel resources: {res}")
        x = (torch.randn(n, hw, hw, c, generator=g, device=dev) * ramp).to(dt)
        ref = fused_layer1_plain(x, wq, ws, bias)
        err = check(f"fused_layer1 {dt} {tuple(x.shape)}",
                    fused_layer1_int8(x, wq, ws, bias), ref,
                    fused_layer1.TOL[dt], failures)
        control("one activation scale for the whole batch",
                one_scale_per_batch(x), ref, fused_layer1.TOL[dt], failures)
        control(f"one activation scale per block ({pb} pixels) instead of "
                f"per image", one_scale_per_band(x), ref,
                fused_layer1.TOL[dt], failures)
        xf = x.float()
        block1 = fused_layer1_plain(xf, wq[:2], ws[:2], bias[:2])
        conv3 = fused_layer1_plain(block1, wq[2:3], ws[2:3], bias[2:3])
        control("residual dropped from the second block",
                fused_layer1_plain(conv3, wq[3:], ws[3:], bias[3:]).to(dt),
                ref, fused_layer1.TOL[dt], failures)
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
        ops = 2 * n * hw * hw * 9 * c * c * wq.shape[0]
        nbytes = 2 * x.numel() * x.element_size() + wq.numel() \
            + 4 * (ws.numel() + bias.numel())
        t_ops, t_bytes = ops / INT8_TENSOR_OPS, nbytes / HBM_BYTES_PER_S
        bound = 1e3 * max(t_ops, t_bytes)
        print(f"    kernel {ms:.4f} ms (its launch alone on the device "
              f"{dms:.4f} ms), plain {pms:.4f} ms, unfused int8 layer1 "
              f"{ums:.4f} ms, bound {bound:.4f} ms [{card}]")
        rows[("fused_layer1", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=None, unfused_ms=ums,
            device_ms=dms,
            bound_ms=bound, max_abs_err=err,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return rows


def wrappers():
    """Every kernel wrapper, by the name the JSON line gives it."""
    from egotap_tpu_torch.ops.attention import (multihead_attention,
                                                multihead_attention_packed)
    from egotap_tpu_torch.ops.fused_layer1 import fused_layer1_int8
    from egotap_tpu_torch.ops.pu_kernel import pu_chain_fused
    from egotap_tpu_torch.ops.upsample import upsample2x_align_corners
    return {"upsample": upsample2x_align_corners,
            "attention": multihead_attention_packed,
            "pu_chain": pu_chain_fused,
            "attention_unpacked": multihead_attention,
            "fused_layer1": fused_layer1_int8}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def read_counts():
    return {n: w.launches for n, w in wrappers().items()}


# launches per Predictor forward, in every precision
PER_FORWARD = {"upsample": 6, "attention": 3, "pu_chain": 1,
               "attention_unpacked": 0, "fused_layer1": 0}


def serve(torch, pred, rgb_dev, label, card, requests=3):
    """Warm up, then serve ``requests`` batches with the launch counters
    zeroed just before; checks the counts and the output. Returns (counts,
    last output)."""
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
        if c != requests * PER_FORWARD[n]:
            raise AssertionError(f"{label}: {n} launched {c} times, "
                                 f"expected {requests * PER_FORWARD[n]}")
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
    code flipped by float sums in another order cannot cascade."""

    def __init__(self):
        from egotap_tpu_torch.ops import quant
        self.quant, self.real = quant, quant.quantize_activation
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

    def run(self, mode, fn, *args):
        self.quant.quantize_activation = getattr(self, mode)
        try:
            return fn(*args)
        finally:
            self.quant.quantize_activation = self.real


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
    launches["int8"], outputs["int8"] = serve(torch, pred, rgb_dev, "int8",
                                              card)
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


def phase_entry_points(torch, card):
    """The encoder with the fused int8 layer1, and the unpacked attention
    wrapper, each through its own entry point."""
    from egotap_tpu_torch.models.resnet import ResNetEncoder
    from egotap_tpu_torch.ops import attention
    from egotap_tpu_torch.ops.attention import (attention_packed_plain,
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
                      pu_chain=0):
        raise AssertionError("the fused encoder must launch kernel D once "
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
                          attention_unpacked=1):
            raise AssertionError("the unpacked wrapper must launch kernel B "
                                 "once")
        flat = [x.reshape(256, 576, 128) for x in (q, k, v)]
        failures = []
        check(f"unpacked attention output {dt}", got, attention_packed_plain(
            *flat, heads=1).reshape(got.shape), attention.TOL[dt], failures)
        if failures:
            raise AssertionError("the unpacked wrapper's output is wrong")
        unpacked[dt] = counts["attention_unpacked"]
    return enc_counts["fused_layer1"], unpacked


# stage-2 training (bench.py:200-210): the egotap_unrealego preset
TRAIN_ITERS_PER_EPOCH = 1000
TRAIN_STEPS = 12                   # the last TIMED_STEPS are timed
TIMED_STEPS = 10
# launches per training step: the frozen nets' decoders (A, 3 a net, no
# gradient), the Grid-ViT's 3 blocks (B) and the PU chain (C), forward
# only; the backward of B and C recomputes their plain versions
PER_TRAIN_STEP = {"upsample": 6, "attention": 3, "pu_chain": 1,
                  "attention_unpacked": 0, "fused_layer1": 0}
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


def recompute_ms(torch, card):
    """CUDA-event times of the backward recompute of kernels B and C at
    the training step's shapes (`ops.plain_vjp` over the plain version),
    per launch, in bf16 and f32."""
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
        out[("pu_chain", dt)] = time_ms(torch, lambda: plain_vjp(
            pu_kernel._plain_flat, saved, (True,) * 9, ct,
            pu_kernel.BACKWARD_LABEL), iters=5)
        b_ms, c_ms = out[("attention", dt)], out[("pu_chain", dt)]
        print(f"  backward recompute {dt}: kernel B {b_ms:.3f} ms a launch, "
              f"kernel C {c_ms:.3f} ms a launch [{card}]")
    return out


def profile_train_step(torch, task, state, batch, card):
    """Device time of the kernels of one training step under
    torch.profiler, and of those of the backward recompute of B and C
    within it (their profiler ranges; a range's own span on the device is
    not a kernel and is printed apart)."""
    from torch.profiler import ProfilerActivity, profile
    from egotap_tpu_torch.breakdown import range_kernels_ms
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
          f"device {spans['attention']:.3f} ms) and of C "
          f"{ranges['pu_chain']:.3f} ms (span {spans['pu_chain']:.3f} ms) "
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
    if counts != PER_FORWARD:
        raise AssertionError("the eval step must launch A, B and C as the "
                             "serving forward does")
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
                   "attention_unpacked": 0, "fused_layer1": 0}
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
    from egotap_tpu_torch.breakdown import range_kernels_ms
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


def train1_run(torch, preset, card):
    """TRAIN_STEPS bf16 stage-1 steps at full width on one fixed batch
    rendered on the card; returns the state and what was counted."""
    from egotap_tpu_torch.breakdown import raw_stage1_batch
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.data.pipeline import make_device_preprocess
    from egotap_tpu_torch.train.tasks import HeatmapTask
    cfg = Config.from_preset(preset)
    raw = raw_stage1_batch(cfg.batch_size, seed=30)
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
          f"{counts['upsample']}, mse_heatmap mean {float(got.mean()):.6f}, "
          f"card vs CPU {gap:.3e} relative (tol {EVAL_MSE_RTOL:.0e})")
    if counts["upsample"] != 3 or not gap <= EVAL_MSE_RTOL:
        raise AssertionError("stage-1 eval step: card and CPU disagree")


def train1_card_vs_cpu(torch, card):
    """One f32 stage-1 step of batch 2 (joint preset, full width) on the
    card against the CPU, and the same check rejecting kernel A's output
    detached from the graph. The weights come from `serving.init_weights`
    (biases and BatchNorm affine non-zero): with the reference init's zero
    biases many ReLU inputs sit exactly on the kink."""
    from egotap_tpu_torch.breakdown import raw_stage1_batch
    from egotap_tpu_torch.core.config import Config
    from egotap_tpu_torch.data.pipeline import make_device_preprocess
    from egotap_tpu_torch.models import heatmap_net
    from egotap_tpu_torch.serving import init_weights
    from egotap_tpu_torch.train.tasks import HeatmapTask
    cfg = Config.from_preset(STAGE1_PRESETS[0], use_amp=False, batch_size=2)
    start = HeatmapTask(cfg, device="cpu").init_state(1, 1).net
    init_weights(start, torch.Generator().manual_seed(2))
    weights = start.state_dict()
    raw = raw_stage1_batch(2, seed=31, device="cpu")
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
    ref = flat_grad(torch, ref_grad, ref_grad)
    gaps = {}
    for label in ("cuda", "control"):
        loss, grad = readings[label]
        gap = max(abs(float(loss[k]) - float(ref_loss[k]))
                  / abs(float(ref_loss[k])) for k in ref_loss)
        rel = float((flat_grad(torch, grad, ref_grad) - ref).norm()
                    / ref.norm())
        gaps[label] = rel
        print(f"  f32 {label} vs CPU: loss gap {gap:.3e} (rtol "
              f"{TRAIN_LOSS_RTOL:.0e}); UNet gradient rel-L2 {rel:.3e} (tol "
              f"{TRAIN_GRAD_TOL:.0e})")
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

    print("phase 2: kernels vs plain versions on the card")
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
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    # launches of each row: the int8 forward's (bf16 compute) for the bf16
    # rows, the f32 forward's for the f32 attention and PU chain rows, and
    # the entry points' own calls for kernel D and the unpacked wrapper
    launches = {(n, torch.bfloat16): c for n, c in served["int8"].items()}
    for n in ("attention", "pu_chain"):
        launches[(n, torch.float32)] = served["f32"][n]
    launches[("fused_layer1", torch.bfloat16)] = fused
    for dt, c in unpacked.items():
        launches[("attention_unpacked", dt)] = c

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
        "fused_layer1": ("fused_layer1_int8", "cuda",
                         "egotap_tpu_torch/csrc/fused_layer1.cu",
                         "egotap_tpu/ops/fused_layer1.py:121"),
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
        for extra in ("unfused_ms", "device_ms", "latency_floor_ms"):
            if extra in r:
                kernels[-1][extra] = r[extra]
        # the training step (bf16) and the eval step run the bf16 kernels
        if dt == torch.bfloat16:
            kernels[-1]["train_step_launches"] = \
                train["counts"][key] / TRAIN_STEPS
            kernels[-1]["eval_step_launches"] = evaluation[key]
        if (key, dt) in train["backward"]:
            kernels[-1]["backward_ms"] = train["backward"][(key, dt)]
        # stage 1 trains in bf16: A's launches a step and its backward
        if (key, dt) == ("upsample", torch.bfloat16):
            kernels[-1]["train1_step_launches"] = \
                stage1["counts"][key] / TRAIN_STEPS
            kernels[-1]["backward_ms"] = stage1["backward"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
