"""kernel.care_ms_per_round: the summed device time, in the traced window,
of the kernels that the batched CARE (``ops/riccati.py`` ``care_lqr``)
launches for its batched LU factorisations and solves
(``torch.linalg.lu_factor_ex``, ``lu_solve``, ``solve_ex``), in ms, over
its rounds.  A traced ``car.replan`` on the H100 (torch 2.11.0+cu128)
names them ``getrf_semiwarp``, ``getrf_pivot``, ``getrf_2x2``,
``laswp_kernel``, ``batch_trsm_left_kernel`` and
``trsm_batch_left_upper_kernel`` / ``_lower_kernel`` (cuBLAS's): a name
that contains one of ``NAMES``.  None where no such kernel ran (a constant
lqr)."""

NAMES = ("getrf", "trsm", "laswp")


def read(run):
    tr = run.trace
    if tr is None or tr.rounds <= 0:
        return None
    secs = sum(s for name, (_, s) in tr.kernels.items()
               if any(k in name.lower() for k in NAMES))
    return 1e3 * secs / tr.rounds if secs > 0 else None
