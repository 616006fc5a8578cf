"""h2d_ms.serve: host ms a request in the program's ``serve.h2d`` span (the
pageable copy of the request's frames to the card), from the traced
window."""

from benchmark import program_spans


def read(run):
    return program_spans.per_root_ms(run, "serve.request", "serve.h2d")
