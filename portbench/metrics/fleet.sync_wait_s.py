"""fleet.sync_wait_s: the mean, over the window's cycles, of the span
``fleet.chunk_sync`` (the ``stats["spans"]`` that ``FleetPlanner.plan``
returns): the host's waits on the fetch that ends each chunk, and on the
final sizes' fetch, where the card sets the pace.  None where the program
keeps no spans."""


def read(run):
    if run.system != "fleet" or not run.replans:
        return None
    spans = [r["stats"].get("spans") for r in run.replans]
    if any(s is None or "fleet.chunk_sync" not in s for s in spans):
        return None
    return (sum(s["fleet.chunk_sync"]["total_s"] for s in spans)
            / len(spans))
