"""host.steer_ms_per_round: the host's ms a round in the span
``round.steer`` (``core/rounds.py`` ``make_extend``: the steer's Python
loop over H steps, which enqueues its ops): the window's summed
``round.steer`` over its summed rounds.  None where the program keeps no
spans."""


def read(run):
    if run.system != "planner" or not run.replans:
        return None
    spans = [r["stats"].get("spans") for r in run.replans]
    if any(s is None or "round.steer" not in s for s in spans):
        return None
    rounds = sum(r["stats"]["rounds"] for r in run.replans)
    if rounds <= 0:
        return None
    return 1e3 * sum(s["round.steer"]["total_s"] for s in spans) / rounds
