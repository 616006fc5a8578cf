"""dispatch_ms.serve: host ms a request in the program's ``stage1`` and
``stage2`` spans (the enqueue of the heatmap nets and of the lifter),
from the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.per_root_ms(run, "serve.request", "stage1",
                                     "stage2")
