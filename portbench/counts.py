"""Operation counts of the per-node LQR path (kernel C and the batched
CARE), derived by reading the program's sources; nothing here imports the
program.  ``peaks.py`` holds the card's peaks and the constant-metric
path's counts.
"""
from __future__ import annotations


def nn_general_pair_flops(n: int, wrapped: bool) -> int:
    """fp32 flops of one (candidate, row) pair of kernel C
    (``csrc/nn_general.cu`` ``row_costs``, a packed row of x_j and the
    upper triangle U_j of S_j): n subs e = x_j - r; with a wrapped dim its
    turn (a mul, the rint, an FMA: 4, as ``peaks.nn_const_pair_flops``
    counts it); t_i = U_ii e_i (n muls) plus U_ik e_k for k > i
    (n (n - 1) / 2 FMAs); e'Se = e_0 t_0 (a mul) plus n - 1 FMAs.  An FMA
    is two flops: n^2 + 3n - 1, and 4 more wrapped (31 at n = 4)."""
    return n + (4 if wrapped else 0) + n + n * (n - 1) + 1 + 2 * (n - 1)


def _lu(d: int) -> int:
    """Flops of an LU factorisation of a d x d matrix with partial
    pivoting: at step k, d - k divisions and (d - k)^2 FMAs."""
    return sum(j + 2 * j * j for j in range(1, d))


def _lu_solve(d: int, rhs: int) -> int:
    """Flops of the two triangular solves of an LU with ``rhs`` columns:
    the unit lower one d (d - 1), the upper one d (d - 1) and d divisions,
    a column."""
    return rhs * (2 * d * d - d)


def care_row_flops(n: int, m: int, iters: int = 16) -> int:
    """fp32 flops of one row of the program's batched CARE
    (``lqrrt_tpu_torch/ops/riccati.py`` ``care_lqr``), counted low: the
    Jacobians (``linearize``) and every copy, negation and concatenation
    left out.
    - G = B R^-1 B': an LU of R and its solve with n columns, and the
      n x n product over m;
    - the sign iteration on the 2n x 2n Hamiltonian, ``iters`` times
      (``_SIGN_ITERS`` = 16): an LU, its solve against the identity (2n
      columns), log|det| (an abs, a log and an add a diagonal entry), the
      scale (3) and Z <- (cZ + Z^-1 / c) / 2 (4 a entry);
    - S: [W12; W22 + I] and its right side (2n adds), the normal equations'
      two products, an LU and its solve with n columns, the symmetrisation;
    - K = R^-1 B'S: the product over n and R's LU and solve.
    75 + 24,800 + 666 + 83 = 25,624 at n = 4, m = 2."""
    d = 2 * n
    g = _lu(m) + _lu_solve(m, n) + n * n * (2 * m - 1)
    sign = iters * (_lu(d) + _lu_solve(d, d) + 3 * d - 1 + 3 + 4 * d * d)
    s = (2 * n + 2 * n * n * (2 * d - 1) + _lu(n) + _lu_solve(n, n)
         + 2 * n * n)
    k = m * n * (2 * n - 1) + _lu(m) + _lu_solve(m, n)
    return g + sign + s + k
