"""planner.post_s: the mean of ``stats["overhead_total_s"]`` over the
window's replans: the time ``Planner._commit_plan`` takes to extract,
prune and commit the plan, on the program's own clock."""


def read(run):
    if run.system != "planner" or not run.replans:
        return None
    return (sum(r["stats"]["overhead_total_s"] for r in run.replans)
            / len(run.replans))
