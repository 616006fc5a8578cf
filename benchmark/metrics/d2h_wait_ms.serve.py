"""d2h_wait_ms.serve: host ms a request in the program's ``serve.d2h`` span
(waiting for the card to finish the forward, then the pose's copy back),
from the traced window."""

from benchmark import program_spans


def read(run):
    return program_spans.per_root_ms(run, "serve.request", "serve.d2h")
