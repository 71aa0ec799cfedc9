"""step_mfu.car: the traced replan's share of the card's fp32 peak, in %,
on a planner whose lqr is re-linearised at every node: the floating-point
work of its rounds over the traced window, counted low from shapes and
the program's counter:
- the steer: every candidate of the batch through all H steps (the
  configuration's ``step_flops`` a step of a row), B H step_flops a round;
- kernel C: each candidate against every live row of the tree, whose
  rows before each round of a restart cycle are known
  (``peaks.restart_tree_sizes``), ``counts.nn_general_pair_flops`` a pair;
- the batched CARE: ``counts.care_row_flops`` a row, times the rows the
  per-node LQR solved in the traced replan (the program's tally
  ``lqr.rows``: the rounds' endpoints and the seeds).
None where the program keeps no ``lqr.rows`` tally (a constant lqr, or a
program without it)."""
from portbench import counts
from portbench import peaks as pk


def read(run):
    tr = run.trace
    if tr is None or tr.rounds <= 0 or run.system != "planner" \
            or not run.traced:
        return None
    cfg, pc = run.cfg, run.cfg["planner"]
    if pc["refine_mode"] != "restart":
        return None
    rows = run.traced[0]["stats"].get("tallies", {}).get("lqr.rows")
    if not rows:
        return None
    n, m = cfg["nstates"], cfg["ncontrols"]
    B, H = pc["batch_size"], round(cfg["horizon"] / cfg["dt"])
    sizes = pk.restart_tree_sizes(B, pc["capacity"])
    pair = counts.nn_general_pair_flops(n, bool(cfg["wrap_dims"]))
    per_round = B * (H * cfg["step_flops"] + pair * sum(sizes) / len(sizes))
    flops = per_round * tr.rounds + counts.care_row_flops(n, m) * rows
    return 100.0 * flops / tr.window_s / pk.PEAK_FLOPS["fp32"]
