"""fleet.extract_s: the mean wall time of ``FleetPlanner.extract_plans``
in a cycle of the window (host clock)."""


def read(run):
    if run.system != "fleet" or not run.replans:
        return None
    return sum(r["extract_s"] for r in run.replans) / len(run.replans)
