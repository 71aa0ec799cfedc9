"""device.kernels_per_round: the device kernels of the traced window over
the rounds that the program's stats report for it (extraction and
pruning included)."""


def read(run):
    tr = run.trace
    if tr is None or tr.rounds <= 0 or tr.n_kernels == 0:
        return None
    return tr.n_kernels / tr.rounds
