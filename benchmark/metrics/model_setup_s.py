"""model_setup_s: seconds in the program's outermost ``setup.model`` spans
(building the nets, their weights, placement, casts, prequantisation),
part of the run's set-up."""

from benchmark import program_spans


def read(run):
    return program_spans.total_s("setup.model")
