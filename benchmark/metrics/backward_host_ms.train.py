"""backward_host_ms.train: host ms a step in the program's
``train.backward`` span (the main thread blocked while autograd runs the
backward), from the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.per_root_ms(run, "train.step", "train.backward")
