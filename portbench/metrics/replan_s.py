"""replan_s: the window's seconds over the replans completed in it.  A
replan runs from the call to the committed plan (``update_plan``, with its
extraction and pruning; for the fleet one ``plan`` and one
``extract_plans``)."""


def read(run):
    if not run.replans:
        return None
    return run.window_s / len(run.replans)
