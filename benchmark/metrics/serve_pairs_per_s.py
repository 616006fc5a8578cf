"""serve_pairs_per_s: stereo pairs whose pose came back in the window,
over the window's length (its first request sent to its last returned)."""


def read(run):
    return run.pairs / run.window_s
