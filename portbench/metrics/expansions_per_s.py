"""expansions_per_s: the expansions that the window's replans completed
(``stats["expansions"]``: rounds x batch, every scenario's for the fleet)
over the window's seconds."""


def read(run):
    if not run.replans:
        return None
    return sum(r["stats"]["expansions"] for r in run.replans) / run.window_s
