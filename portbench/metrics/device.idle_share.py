"""device.idle_share: 1 minus the union of the device's busy intervals
(kernels, copies, fills) over the traced window."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
