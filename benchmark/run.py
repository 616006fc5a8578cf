"""The benchmark of egotap_tpu_torch: one run of one cell, on one card.

    python3 benchmark/run.py --workload r18.serve-b32 --seed 7 \
        --seconds 10 --trace 0

Loads the cell named in `BENCHMARK.json`, sets it up (imports, the
kernels' build or cache, inputs and weights drawn from ``--seed``, the
warm-up), measures for ``--seconds``, checks what the timed path produced
against the plain float32 reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics,
read from a profiled window after the measured one), ``device``, with
``--trace 1`` ``breakdown``, ``readings`` (every number the check
computed) and last ``checks`` (each number compared, with its limit). The set-up's phases go to standard error before the
window; the compared numbers are the last lines of standard error.

Exits 2 without a CUDA card (or with fewer than the cell asks for), and 3
when ``jax``, ``jaxlib``, ``flax`` or ``egotap_tpu`` was imported; then
it prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # the program's kernel libraries build into egotap_tpu_torch/build/;
    # any other build cache stays inside the checkout too
    cache = os.path.join(HERE, ".cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    # one process, few threads: no idle host thread pool beside the
    # thread that drives the card
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, ROOT)
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    t = time.perf_counter()
    import torch
    torch.set_num_threads(1)
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        log(f"benchmark: needs {cell.chips} CUDA device(s), found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    harness.driver_for(cell)      # the driver, and the program it drives
    phases = {"imports": time.perf_counter() - t}
    log(f"card: {torch.cuda.get_device_name(0)}; peaks: "
        f"{harness.peaks_for(torch.cuda.get_device_name(0))}; "
        f"power limit: {harness.power_limit()}")
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START, phases,
                              log=log)
    found = harness.forbidden_modules()
    if found:
        log(f"benchmark: forbidden modules imported: {found}")
        return 3
    for name, c in result["checks"].items():
        value = "missing" if c["value"] is None else f"{c['value']:.6e}"
        log(f"check {name}: {value} (limit {c['limit']:.6e})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
