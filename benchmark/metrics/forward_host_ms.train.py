"""forward_host_ms.train: host ms a step in the program's
``train.frozen_forward`` and ``train.net_forward`` spans (the frozen nets'
forward, the lifter's forward and losses), from the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.per_root_ms(run, "train.step",
                                     "train.frozen_forward",
                                     "train.net_forward")
