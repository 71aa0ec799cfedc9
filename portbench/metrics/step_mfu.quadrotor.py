"""step_mfu.quadrotor: the traced replan's share of the card's fp32 peak,
in %, on the quadrotor's per-node-LQR planner: ``step_mfu.car``'s reader
(called through ``portbench.cells.reader``) on this cell's configuration,
so the same count from shapes and the program's ``lqr.rows`` tally: the
steer (B H ``step_flops``, 544 a quadrotor step), kernel C's pairs at
n = 12 and the CARE's ``counts.care_row_flops(12, 4)`` a row.  None where
that reader gives none."""
from portbench import cells


def read(run):
    return cells.reader("step_mfu.car")(run)
