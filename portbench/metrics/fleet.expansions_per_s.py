"""fleet.expansions_per_s: the fleet's aggregate expansions that the
window's cycles completed (``stats["expansions"]``: rounds x batch x
scenarios) over the window's seconds.  ``expansions_per_s``'s arithmetic,
reported per layer on the fleet's cells: its runs there spread by more
than any end-to-end bound allows, since the host sets the rounds that fit
a cycle's budget, and ``goal_rate`` carries the gain end to end."""


def read(run):
    if run.system != "fleet" or not run.replans:
        return None
    return sum(r["stats"]["expansions"] for r in run.replans) / run.window_s
