"""setup_s: seconds from the harness's start to the measured window
(imports, the kernels' build or cache, inputs, weights, warm-up)."""


def read(run):
    return run.setup_s
