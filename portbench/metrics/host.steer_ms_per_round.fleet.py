"""host.steer_ms_per_round.fleet: ``host.steer_ms_per_round`` on the
fleet's cells: the window's cycles' summed ``round.steer`` span (the
steer over the fleet's S x B rows) over their summed rounds, in ms.  None
where the program keeps no spans."""


def read(run):
    if run.system != "fleet" or not run.replans:
        return None
    spans = [r["stats"].get("spans") for r in run.replans]
    if any(s is None or "round.steer" not in s for s in spans):
        return None
    rounds = sum(r["stats"]["rounds"] for r in run.replans)
    if rounds <= 0:
        return None
    return 1e3 * sum(s["round.steer"]["total_s"] for s in spans) / rounds
