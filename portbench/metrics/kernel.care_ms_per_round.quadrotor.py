"""kernel.care_ms_per_round.quadrotor: the summed device time, in the
traced window, of the batched CARE's LU kernels where its Hamiltonians are
24 x 24 (the quadrotor's), in ms, over its rounds.  The per-node lqr
solves its CARE in fp64; PyTorch (2.11+cu128 on the H100) factors those
Hamiltonians through MAGMA (``dgetrf_batched_smallsq_noshfl_kernel<24,
32>``) and solves through the unpacked pivots
(``unpack_pivots_cuda_kernel``), a gather of the right side's rows and
cuBLAS's triangular solves (``batch_trsm_left_kernel``), without the
``laswp_kernel`` of the car's 8 x 8 path: the names are
``kernel.care_ms_per_round``'s and ``unpack_pivots``.  The gather
(``_scatter_gather_elementwise_kernel``, ~1.9 ms a round at 8,192 rows)
shares its name with other gathers and is left out, so the reading is
low.  None where no such kernel ran."""

NAMES = ("getrf", "trsm", "laswp", "unpack_pivots")


def read(run):
    tr = run.trace
    if tr is None or tr.rounds <= 0:
        return None
    secs = sum(s for name, (_, s) in tr.kernels.items()
               if any(k in name.lower() for k in NAMES))
    return 1e3 * secs / tr.rounds if secs > 0 else None
