"""optimizer_ms.train: device ms a step of the kernels launched inside the
benchmark's optimizer-step ranges, from the traced window."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.range_s(run.optimizer)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.traced_units
