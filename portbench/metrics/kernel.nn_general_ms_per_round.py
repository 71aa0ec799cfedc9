"""kernel.nn_general_ms_per_round: the summed device time of kernel C
(``nn_general_kernel``, the nearest node under a per-node S) in the traced
window, in ms, over its rounds."""

NAME = "nn_general_kernel"


def read(run):
    tr = run.trace
    if tr is None or tr.rounds <= 0:
        return None
    secs = sum(s for name, (_, s) in tr.kernels.items() if NAME in name)
    return 1e3 * secs / tr.rounds if secs > 0 else None
