"""optimizer_host_ms.train: host ms a step in the program's
``train.optimizer`` span (AdamW's dispatch), from the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.per_root_ms(run, "train.step", "train.optimizer")
