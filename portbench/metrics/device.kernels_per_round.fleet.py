"""device.kernels_per_round.fleet: ``device.kernels_per_round`` on the
fleet's cells (the traced cycle's device kernels over its rounds, seeding
and extraction included), where fewer launches fit more rounds into a
cycle and move ``goal_rate``."""


def read(run):
    tr = run.trace
    if run.system != "fleet" or tr is None or tr.rounds <= 0 \
            or tr.n_kernels == 0:
        return None
    return tr.n_kernels / tr.rounds
