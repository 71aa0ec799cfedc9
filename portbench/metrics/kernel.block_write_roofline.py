"""kernel.block_write_roofline: kernel B's (``block_write_kernel``, the
commit's edge writes) share of its bound, in %.  The bound is the bytes a
launch must move over the HBM rate: each commit writes the (H, n, B)
states and the (H, m, B) controls, each read once and written once, so a
pair of launches moves 2 H (n + m) B 4 bytes.  The time is the launches'
summed device time."""
from portbench import peaks as pk

NAME = "block_write_kernel"


def read(run):
    tr = run.trace
    if tr is None or run.system != "planner":
        return None
    hits = [(c, s) for name, (c, s) in tr.kernels.items() if NAME in name]
    count = sum(c for c, _ in hits)
    secs = sum(s for _, s in hits)
    if count == 0 or secs <= 0:
        return None
    cfg = run.cfg
    H = round(cfg["horizon"] / cfg["dt"])
    pair = pk.block_write_bytes(H, cfg["nstates"] + cfg["ncontrols"],
                                cfg["planner"]["batch_size"])
    return 100.0 * (count / 2) * pair / (pk.HBM_BYTES_PER_S * secs)
