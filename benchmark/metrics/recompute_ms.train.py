"""recompute_ms.train: device ms a step of the kernels launched inside the
benchmark's (the program's own) kernel A, B and C backward-recompute
ranges, from the traced window."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.range_s(*run.recompute)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.traced_units
