"""stage2_ms.serve: device ms a batch of the kernels launched inside the
benchmark's lifter forward ranges, from the traced window."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.range_s(*run.stage2)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.traced_units
