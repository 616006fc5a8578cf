"""int8_passes_ms.serve: device ms a request of the kernels launched inside
the program's ``int8.conv`` and ``int8.dense`` spans but not inside its
``int8.matmul`` ones: the quantise, im2col, operand-layout and dequantise
passes around the integer products, from the traced window."""


def read(run):
    calls = getattr(run, "int8_calls", None)
    if run.trace is None or not calls:
        return None
    seconds = run.trace.range_s(*calls)
    if seconds <= 0:
        return None
    seconds -= run.trace.range_s(*run.int8_matmul)
    return 1e3 * seconds / run.traced_units
