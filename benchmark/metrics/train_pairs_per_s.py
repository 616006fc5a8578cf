"""train_pairs_per_s: pairs of every training step of the window, over
the window's length (it ends in torch.cuda.synchronize())."""


def read(run):
    return run.pairs / run.window_s
