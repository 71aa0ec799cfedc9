"""planner.dispatch_s: the mean, over the window's replans, of the span
``planner.chunk`` (``stats["spans"]``): the host's time in
``Planner._run_restart_loop``'s and ``_run_host_loop``'s chunk calls,
which enqueue a chunk's rounds on the card.  None where the program keeps
no spans."""


def read(run):
    if run.system != "planner" or not run.replans:
        return None
    spans = [r["stats"].get("spans") for r in run.replans]
    if any(s is None or "planner.chunk" not in s for s in spans):
        return None
    return sum(s["planner.chunk"]["total_s"] for s in spans) / len(spans)
