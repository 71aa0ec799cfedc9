"""planner.stats_wait_s: the mean, over the window's replans, of the span
``planner.stats_wait`` (``stats["spans"]``): the host's waits for a
chunk's stats to land (``Planner._fetched``), where the card, not the
host, sets the pace.  None where the program keeps no spans."""


def read(run):
    if run.system != "planner" or not run.replans:
        return None
    spans = [r["stats"].get("spans") for r in run.replans]
    if any(s is None or "planner.stats_wait" not in s for s in spans):
        return None
    return (sum(s["planner.stats_wait"]["total_s"] for s in spans)
            / len(spans))
