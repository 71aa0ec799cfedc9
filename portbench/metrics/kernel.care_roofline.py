"""kernel.care_roofline: the batched CARE's share of its fp64 bound, in %,
on a planner whose lqr is re-linearised at every node; the per-node lqr
solves its CARE in fp64 (``lqrrt_tpu_torch/ops/riccati.py``
``make_relinearized_lqr``).  Its operations are those of its LU
factorisations and triangular solves alone (``care_lqr``, counted with
``counts._lu`` and ``counts._lu_solve``): in each of the 16 sign
iterations the 2n x 2n Hamiltonian's factor and its solve against 2n
columns, then the solves for G (R against n columns), S (the n x n normal
equations against n columns) and K (R against n columns); a row's count
times the rows the per-node LQR solved in the traced replan (the program's
tally ``lqr.rows``).  Its time is the summed device time of the kernels
that ``kernel.care_ms_per_round.quadrotor`` names (its reader, times the
rounds): ``kernel.care_ms_per_round``'s and, where the 24 x 24 solves take
it, the pivots' unpacking, which the car's 8 x 8 path does not launch.
Against the card's fp64 rate outside the tensor cores.  None where either
is missing."""
from portbench import cells, counts

SIGN_ITERS = 16     # ops/riccati.py _SIGN_ITERS
# NVIDIA's data sheet, one H100 SXM at 700 W: fp64 without the tensor
# cores (peaks.py holds the fp32, tf32 and bf16 rates)
PEAK_FP64 = 34e12


def lu_row_flops(n: int, m: int, iters: int = SIGN_ITERS) -> int:
    """Flops of one row's LU factorisations and solves (see above)."""
    d = 2 * n
    return (iters * (counts._lu(d) + counts._lu_solve(d, d))
            + 2 * (counts._lu(m) + counts._lu_solve(m, n))
            + counts._lu(n) + counts._lu_solve(n, n))


def read(run):
    tr = run.trace
    if tr is None or tr.rounds <= 0 or run.system != "planner" \
            or not run.traced:
        return None
    rows = run.traced[0]["stats"].get("tallies", {}).get("lqr.rows")
    ms = cells.reader("kernel.care_ms_per_round.quadrotor")(run)
    if not rows or ms is None:
        return None
    secs = ms * tr.rounds / 1e3
    flops = lu_row_flops(run.cfg["nstates"], run.cfg["ncontrols"]) * rows
    return 100.0 * flops / (PEAK_FP64 * secs)
