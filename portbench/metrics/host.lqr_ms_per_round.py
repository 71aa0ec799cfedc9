"""host.lqr_ms_per_round: the host's ms a round in the per-node LQR, the
spans ``lqr.linearize`` (``x_map`` and the batched Jacobians) and
``lqr.care`` (the batched CARE) that ``ops/riccati.py``
``make_relinearized_lqr`` records wherever the planner calls it (the
rounds' ``round.endpoint``, the seeds): the window's summed spans over its
summed rounds.  None where the program keeps no such spans (a constant
lqr, or a program without them)."""

NAMES = ("lqr.linearize", "lqr.care")


def read(run):
    if run.system != "planner" or not run.replans:
        return None
    spans = [r["stats"].get("spans") for r in run.replans]
    if any(s is None or any(n not in s for n in NAMES) for s in spans):
        return None
    rounds = sum(r["stats"]["rounds"] for r in run.replans)
    if rounds <= 0:
        return None
    return 1e3 * sum(s[n]["total_s"] for s in spans for n in NAMES) / rounds
