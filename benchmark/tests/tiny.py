"""A cell of `BENCHMARK.json` cut to a size the CPU runs in seconds: 64 x
64 frames (16 x 16 heatmaps, 36 ViT tokens), batches of 2, a pool of 3.
Every width stays as published."""

import time

from benchmark import harness


def tiny_cell(name: str, root: str = harness.ROOT):
    cell = harness.load_cell(name, root)
    c = cell.config
    c["load_size_heatmap"] = [16, 16]
    c["image_size"] = 64
    c["widths"]["vit_tokens"] = 36
    small = dict(batch=min(cell.traffic["batch"], 2), pool=3, warmup=1,
                 trace_units=2, check_slots=2)
    cell.traffic.update((k, v) for k, v in small.items() if k in cell.traffic)
    return cell


def run(cell, seed: int = 2 ** 31 + 17, trace: bool = False,
        seconds: float = 0.5, program=None):
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), {}, program=program,
                            log=lambda m: None)
