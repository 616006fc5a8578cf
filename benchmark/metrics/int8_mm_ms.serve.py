"""int8_mm_ms.serve: device ms a request of the kernels launched inside the
program's ``int8.matmul`` spans (the integer products, ranges
``egotap.int8.matmul``), from the traced window."""


def read(run):
    ranges = getattr(run, "int8_matmul", None)
    if run.trace is None or not ranges:
        return None
    seconds = run.trace.range_s(*ranges)
    if seconds <= 0:
        return None
    return 1e3 * seconds / run.traced_units
