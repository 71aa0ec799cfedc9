"""setup_s: seconds from the process's start to the first timed replan:
imports, the kernels' build where the checkout has none, the planner's
construction and its warm-up (one replan, or a 1-round fleet plan and one
extraction, on the cell's own shapes)."""


def read(run):
    return run.setup_s
