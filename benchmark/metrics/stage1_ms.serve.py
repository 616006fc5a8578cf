"""stage1_ms.serve: device ms a batch of the kernels launched inside the
benchmark's pos_net and rot_net forward ranges, from the traced window."""


def read(run):
    if run.trace is None:
        return None
    seconds = run.trace.range_s(*run.stage1)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.traced_units
