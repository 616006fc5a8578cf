"""mfu.train: the model FLOPs of the window's steps (the frozen forward,
the lifter's forward and backward; counted on the plain reference at the
cell's shapes, `flops.py`) over the window's length, as a share of the
card's dense bf16 peak."""


def read(run):
    if not run.peaks:
        return None
    flops = run.flops_per_unit * run.units
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops_per_s"]
