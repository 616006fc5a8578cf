"""kernels_roofline.serve: the summed bound of kernels A, B and C over
their summed device time in the traced window, in %. A kernel's bound is
that of the work the forwards asked of it (`bounds.forward_bounds`, per
forward, times the traced forwards); a kernel with no launch in the
trace is left out of both sums."""


def read(run):
    if run.trace is None or not getattr(run, "bounds_per_unit", None):
        return None
    bound = spent = 0.0
    for kernel, pattern in run.kernel_names.items():
        seconds, launches = run.trace.kernel_s(pattern)
        if launches:
            bound += run.bounds_per_unit[kernel] * run.traced_units
            spent += seconds
    if spent <= 0:
        return None
    return 100.0 * bound / spent
