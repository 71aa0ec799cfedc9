"""device.idle_share.fleet: ``device.idle_share`` on the fleet's cells (1
minus the union of the device's busy intervals over the traced cycle),
where fewer idle gaps fit more rounds into a cycle and move
``goal_rate``."""


def read(run):
    tr = run.trace
    if run.system != "fleet" or tr is None or tr.window_s <= 0 \
            or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
