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
   each within the kernel module's ``TOL``; in bf16, faulty variants of
   the plain version (a bf16 rounding skipped or added, a term dropped)
   must fall outside those limits; median CUDA-event times of the
   kernel, its plain version and a one-call PyTorch yardstick where one
   exists (never used by the port).
3. Full path: a full-width `Predictor` (UnrealEgo, resnet18, Grid-ViT
   width 1024 x 3 layers, PU hidden 512) with seeded random weights
   serves 3 requests of (32, 2, 256, 256, 3) in bf16 and in f32; the
   launch counters must rise by exactly 6 (upsample), 3 (attention) and
   1 (PU chain) per forward; one batch-2 f32 request is cross-checked
   against the same port on the CPU, and the bf16 poses against the
   f32 ones.
4. One JSON line with every kernel's numbers, then the result line.
"""

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
BF16_TENSOR_FLOPS = 989e12         # dense bf16 tensor-core peak
F32_FLOPS = 67e12                  # f32 outside the tensor cores
ITERS = 20
BF16_POSE_TOL = 5e-2               # bf16 vs f32 pose, relative to max|f32|


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


def phase_kernels(torch, F, card):
    from egotap_tpu_torch.ops import attention, pu_kernel, upsample
    from egotap_tpu_torch.ops.attention import (attention_packed_plain,
                                                multihead_attention_packed)
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
               "bound_ms": 0.0, "max_abs_err": 0.0}
        for shp in shapes:
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
            pms = time_ms(torch, lambda: upsample2x_plain(x))
            lms = time_ms(torch, lambda: F.interpolate(
                nchw, scale_factor=2, mode="bilinear", align_corners=True))
            nbytes = x.numel() * x.element_size() * 5     # read 1, write 4
            flops = 6 * 4 * x.numel()                     # 3 lerps / output
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)
            print(f"    {shp}: kernel {ms:.4f} ms, plain {pms:.4f} ms, "
                  f"F.interpolate {lms:.4f} ms, bound {bound:.4f} ms [{card}]")
            for k, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                         ("bound_ms", bound)):
                tot[k] += v
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
        rows[("upsample", dt)] = dict(tot, bound_by="bytes")

    # ---- B: packed attention at the Grid-ViT's shape
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
        split = [x.view(b, s, heads, hd).transpose(1, 2) for x in (q, k, v)]
        ms = time_ms(torch, lambda: multihead_attention_packed(q, k, v, heads))
        pms = time_ms(torch, lambda: attention_packed_plain(q, k, v, heads))
        lms = time_ms(torch, lambda: F.scaled_dot_product_attention(*split))
        flops = 4 * b * heads * s * s * hd
        nbytes = 4 * q.numel() * q.element_size()
        peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        bound = 1e3 * max(t_ops, t_bytes)
        print(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, SDPA {lms:.4f} ms, "
              f"bound {bound:.4f} ms [{card}]")
        rows[("attention", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=lms, bound_ms=bound,
            max_abs_err=err,
            bound_by="operations" if t_ops >= t_bytes else "bytes")

    # ---- C: PU chain at the lifter's shape
    b, J, H = 32, 15, 512
    for dt in (torch.float32, torch.bfloat16):
        def u(*shape, bound=H ** -0.5):
            return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound
        fh = torch.sigmoid(torch.randn(b, J, H, generator=g, device=dev))
        gp = 0.5 * torch.randn(b, J, 4 * H, generator=g, device=dev)
        w0 = u(H, 4 * H).to(dt)
        cell1 = {"x2f": {"kernel": u(H, H).to(dt), "bias": u(H)},
                 "x2h": {"kernel": u(H, 4 * H).to(dt), "bias": u(4 * H)},
                 "h2h": {"kernel": u(H, 4 * H).to(dt), "bias": u(4 * H)}}
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
        flops = 2 * b * H * 13 * H * J
        wbytes = (w0.numel() + sum(c["kernel"].numel() for c in cell1.values())
                  ) * w0.element_size()
        nbytes = wbytes + 4 * (fh.numel() + gp.numel() + fh.numel()
                               + sum(c["bias"].numel() for c in cell1.values()))
        peak = BF16_TENSOR_FLOPS if dt == torch.bfloat16 else F32_FLOPS
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        bound = 1e3 * max(t_ops, t_bytes)
        print(f"    kernel {ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{bound:.4f} ms [{card}]")
        rows[("pu_chain", dt)] = dict(
            ms=ms, plain_ms=pms, library_ms=None, bound_ms=bound,
            max_abs_err=err,
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    if failures:
        raise AssertionError(f"kernel checks failed: {failures}")
    return rows


def phase_full_path(torch, card):
    import numpy as np
    from egotap_tpu_torch.ops.attention import multihead_attention_packed
    from egotap_tpu_torch.ops.pu_kernel import pu_chain_fused
    from egotap_tpu_torch.ops.upsample import upsample2x_align_corners
    from egotap_tpu_torch.serving import Predictor

    wrappers = {"upsample": upsample2x_align_corners,
                "attention": multihead_attention_packed,
                "pu_chain": pu_chain_fused}
    per_forward = {"upsample": 6, "attention": 3, "pu_chain": 1}
    requests = 3
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
        pred._forward(rgb_dev)                      # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        times = []
        for _ in range(requests):
            t0 = time.perf_counter()
            out = pred(rgb_dev)
            times.append(time.perf_counter() - t0)
        counts = {n: w.launches for n, w in wrappers.items()}
        print(f"  {label}: launches over {requests} forwards: {counts}")
        for n, c in counts.items():
            if c != requests * per_forward[n]:
                raise AssertionError(
                    f"{label}: {n} launched {c} times, expected "
                    f"{requests * per_forward[n]}")
        if out.shape != (32, 16, 3) or not np.isfinite(out).all():
            raise AssertionError(f"{label}: bad output {out.shape}")
        med = statistics.median(times)
        print(f"  {label}: forward median {1e3 * med:.3f} ms over {requests} "
              f"requests of batch 32 = {32 / med:.2f} pairs/s [{card}]")
        launches[label] = counts
        outputs[label] = out
        if not bf16:
            cpu = Predictor(bf16=False, device="cpu", seed=0)
            got = pred(rgb_dev[:2])
            ref = cpu(rgb[:2])
            err = float(np.abs(got - ref).max())
            scale = float(np.abs(ref).max())
            # f32 on both sides (TF32 off): only summation order differs
            print(f"  f32 card vs CPU, batch 2: max_abs_err={err:.3e} "
                  f"(tol 1e-4, max|cpu|={scale:.3e})")
            if err > 1e-4:
                raise AssertionError("card and CPU forwards disagree")
        del pred
        torch.cuda.empty_cache()
    dev = float(np.abs(outputs["bf16"] - outputs["f32"]).max())
    scale = float(np.abs(outputs["f32"]).max())
    # bf16 rounds every conv and matrix operand: the gap is a few bf16
    # ulps of the pose, not a kernel's flip of one rounding
    print(f"  bf16 vs f32 pose on the card: max_abs_dev={dev:.3e} "
          f"(tol {BF16_POSE_TOL:.0e} x max|f32|={scale:.3e})")
    if dev > BF16_POSE_TOL * scale:
        raise AssertionError("bf16 and f32 forwards disagree")
    return launches["bf16"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from egotap_tpu_torch.ops import _build

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

    print("phase 3: full serving path, batch 32, bf16 and f32")
    launches = phase_full_path(torch, card)

    meta = {
        "upsample": ("upsample2x_align_corners", "cuda",
                     "egotap_tpu_torch/csrc/upsample.cu",
                     "egotap_tpu/ops/upsample.py:98"),
        "attention": ("attention_packed", "cuda",
                      "egotap_tpu_torch/csrc/attention.cu",
                      "egotap_tpu/ops/attention.py:122"),
        "pu_chain": ("pu_chain", "cuda", "egotap_tpu_torch/csrc/pu_chain.cu",
                     "egotap_tpu/ops/pu_kernel.py:74"),
    }
    kernels = []
    for key, (name, route, source, replaces) in meta.items():
        r = rows[(key, torch.bfloat16)]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "dtype": "bfloat16"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
