"""step_mfu: the traced rounds' share of the card's fp32 peak, in %: the
floating-point work the planner's restart chunk makes the device do in
them, over the traced window.  The work is counted from shapes: each round
steers every candidate of the batch through all H steps (the steer is a
loop over H on every row; the configuration's ``step_flops`` is one step
of one row), and matches each candidate with every row of the tree (which
grows by the batch a round from its root pad, so its rows are known).
The fleet's trees grow by what its commits keep, which nothing exposes:
it reports no share."""
from portbench import peaks as pk


def read(run):
    tr = run.trace
    if tr is None or tr.rounds <= 0 or run.system != "planner":
        return None
    cfg, pc = run.cfg, run.cfg["planner"]
    if pc["refine_mode"] != "restart":
        return None
    B, H = pc["batch_size"], round(cfg["horizon"] / cfg["dt"])
    sizes = pk.restart_tree_sizes(B, pc["capacity"])
    pair = pk.nn_const_pair_flops(cfg["nstates"], bool(cfg["wrap_dims"]))
    per_round = B * (H * cfg["step_flops"] + pair * sum(sizes) / len(sizes))
    return 100.0 * per_round * tr.rounds / tr.window_s / pk.PEAK_FLOPS["fp32"]
