"""plan_duration_s: the mean duration (s) of the plans that the window's
replans committed: (states - 1) x dt of each plan as the harness received
it."""


def read(run):
    if run.system != "planner" or not run.replans:
        return None
    dt = run.cfg["dt"]
    plans = [p for r in run.replans for p in r["plans"]]
    return sum((len(p["x"]) - 1) * dt for p in plans) / len(plans)
