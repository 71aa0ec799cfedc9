"""kernel.nn_general_roofline: kernel C's (``nn_general_kernel``) share of
its operation bound, in %.  Each launch of the restart chunk matches the
batch's B candidates with every live row of the tree, whose rows before
each round of a restart cycle are known (``peaks.restart_tree_sizes``), at
``counts.nn_general_pair_flops`` fp32 flops a pair; the launches' summed
flops over their summed device time, against 67 TFLOP/s fp32.  The
chunk's rounds run whole restart cycles, so the launches cover each
round of a cycle alike."""
from portbench import counts
from portbench import peaks as pk

NAME = "nn_general_kernel"


def read(run):
    tr = run.trace
    if tr is None or run.system != "planner":
        return None
    cfg, pc = run.cfg, run.cfg["planner"]
    if pc["refine_mode"] != "restart":
        return None
    hits = [(c, s) for name, (c, s) in tr.kernels.items() if NAME in name]
    count = sum(c for c, _ in hits)
    secs = sum(s for _, s in hits)
    if count == 0 or secs <= 0:
        return None
    sizes = pk.restart_tree_sizes(pc["batch_size"], pc["capacity"])
    pair = counts.nn_general_pair_flops(cfg["nstates"],
                                        bool(cfg["wrap_dims"]))
    flops = count * pc["batch_size"] * pair * sum(sizes) / len(sizes)
    return 100.0 * flops / (pk.PEAK_FLOPS["fp32"] * secs)
