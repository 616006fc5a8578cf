"""int8_mm_roofline.serve: the summed bound of the int8 products of the
traced forwards (`bounds_int8.py`, shapes from the plain int8 reference)
over the device time of the kernels launched inside the program's
``int8.matmul`` spans, in %. Read only where the card's peaks are known."""


def read(run):
    bound = getattr(run, "int8_bound_per_unit", None)
    if run.trace is None or not bound or not run.peaks:
        return None
    seconds = run.trace.range_s(*run.int8_matmul)
    if seconds <= 0:
        return None
    return 100.0 * bound * run.traced_units / seconds
