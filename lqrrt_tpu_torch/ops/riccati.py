"""Linearization, the continuous algebraic Riccati equation (CARE) and the
``lqr(x, u)`` callbacks (port of lqrrt_tpu/ops/riccati.py).

Two CARE solvers and a DARE solver:

* ``solve_care`` / ``care_lqr``: the JAX package's matrix-sign iteration,
  batched over leading axes, in the tensors' dtype, on their device, with
  no host sync.  ``make_relinearized_lqr`` re-solves it at every committed
  node (car, quadrotor), in fp64 where the JAX package solves in fp32.
* ``care_lqr_host``: scipy's float64 CARE on the host, for setup-time
  constant policies (``lqr_setup``, ``make_constant_lqr``; the boat).
* ``solve_dare`` / ``dare_lqr``: the discrete-time Riccati equation by the
  JAX package's structure-preserving doubling, on the tensors' device; no
  model calls it.

The JAX package's Gauss-Jordan inverse (``inv_logdet_gj``) works around a
slow batched LU on the TPU and has no counterpart: the sign iteration takes
its inverse and log|det| from one ``torch.linalg.lu_factor_ex``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Tuple

import numpy as np
import torch

from .._const import Const
from ..utils.timing import NO_SPANS

# quadratic convergence reaches fp32 eps in ~8-12 iterations with
# determinant scaling; 16 keeps margin (the JAX package's count)
_SIGN_ITERS = 16


def _inv_logdet(Z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched (Z^-1, log|det Z|) from one LU factorization.  The ``_ex``
    variant checks no error on the host, so nothing syncs; the 1e-38 floor
    is the JAX package's."""
    LU, piv, _ = torch.linalg.lu_factor_ex(Z)
    eye = torch.eye(Z.shape[-1], dtype=Z.dtype, device=Z.device)
    Zi = torch.linalg.lu_solve(LU, piv, eye.expand_as(Z))
    diag = torch.diagonal(LU, dim1=-2, dim2=-1)
    return Zi, torch.log(diag.abs() + 1e-38).sum(-1)


def _matrix_sign(H: torch.Tensor, iters: int = _SIGN_ITERS) -> torch.Tensor:
    """Matrix sign function by the scaled Newton iteration
    Z <- (cZ + (cZ)^-1) / 2, with determinant scaling c = |det Z|^(-1/dim)
    clamped to e^+-20; a fixed trip count."""
    dim = H.shape[-1]
    Z = H
    for _ in range(iters):
        Zi, logdet = _inv_logdet(Z)
        c = torch.exp(torch.clamp(-logdet / dim, -20.0, 20.0))[..., None, None]
        Z = 0.5 * (c * Z + Zi / c)
    return Z


def _solve(A, B):
    """A^-1 B, batched, without a host-side error check."""
    return torch.linalg.solve_ex(A, B)[0]


def solve_care(A, B, Q, R) -> torch.Tensor:
    """The stabilizing P of A'P + PA - P B R^-1 B' P + Q = 0, batched over
    the leading axes of A (..., n, n), B (..., n, m), Q (..., n, n) and
    R (..., m, m).

    sign(H) of the Hamiltonian H = [[A, -G], [-Q, -A']], G = B R^-1 B',
    acts as -I on the graph of P, so P solves the stacked least-squares
    system [S12; S22 + I] P = -[S11 + I; S21] (normal equations).  R must
    be nonsingular, (A, B) stabilizable and (A, Q) detectable."""
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2], Q.shape[:-2],
                                   R.shape[:-2])
    A = A.expand(batch + A.shape[-2:])
    B = B.expand(batch + B.shape[-2:])
    Q = Q.expand(batch + Q.shape[-2:])
    R = R.expand(batch + R.shape[-2:])
    G = B @ _solve(R, B.mT)
    H = torch.cat([torch.cat([A, -G], -1), torch.cat([-Q, -A.mT], -1)], -2)
    Sg = _matrix_sign(H)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    M = torch.cat([Sg[..., :n, n:], Sg[..., n:, n:] + eye], -2)      # (2n, n)
    rhs = -torch.cat([Sg[..., :n, :n] + eye, Sg[..., n:, :n]], -2)
    P = _solve(M.mT @ M, M.mT @ rhs)
    return 0.5 * (P + P.mT)


def care_lqr(A, B, Q, R) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuous-time LQR, batched: (S, K) with S = solve_care(A, B, Q, R)
    and K = R^-1 B'S."""
    S = solve_care(A, B, Q, R)
    return S, _solve(R, B.mT @ S)


_DOUBLING_ITERS = 30     # the JAX package's count


@contextlib.contextmanager
def _fp32_products():
    """Matrix products in full fp32 (TF32 off) inside the block, as the
    JAX package's ``Precision.HIGHEST`` products."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def solve_dare(A, B, Q, R) -> torch.Tensor:
    """The stabilizing P of A'PA - P - A'PB (R + B'PB)^-1 B'PA + Q = 0,
    batched over leading axes, by the structure-preserving doubling
    algorithm (a fixed 30 iterations):

        A_{k+1} = A_k (I + G_k H_k)^-1 A_k
        G_{k+1} = G_k + A_k (I + G_k H_k)^-1 G_k A_k'
        H_{k+1} = H_k + A_k' H_k (I + G_k H_k)^-1 A_k

    from A_0 = A, G_0 = B R^-1 B', H_0 = Q; H_k -> P quadratically.
    Products in full fp32, inverses by ``torch.linalg.inv`` (the JAX
    package's Gauss-Jordan ``inv_gj``)."""
    batch = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2], Q.shape[:-2],
                                   R.shape[:-2])
    A = A.expand(batch + A.shape[-2:])
    B = B.expand(batch + B.shape[-2:])
    Q = Q.expand(batch + Q.shape[-2:])
    R = R.expand(batch + R.shape[-2:])
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    with _fp32_products():
        G = B @ torch.linalg.inv(R) @ B.mT
        Ak, Hk = A, Q
        for _ in range(_DOUBLING_ITERS):
            W = torch.linalg.inv(eye + G @ Hk)
            AW = Ak @ W
            Ak, G, Hk = (AW @ Ak, G + AW @ G @ Ak.mT,
                         Hk + Ak.mT @ Hk @ W @ Ak)
    return 0.5 * (Hk + Hk.mT)


def dare_lqr(A, B, Q, R) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discrete-time LQR, batched: (S, K) with S = solve_dare(A, B, Q, R)
    and K = (R + B'SB)^-1 B'SA."""
    S = solve_dare(A, B, Q, R)
    with _fp32_products():
        BtS = B.mT @ S
        return S, torch.linalg.inv(R + BtS @ B) @ (BtS @ A)


def care_lqr_host(A, B, Q, R) -> Tuple[np.ndarray, np.ndarray]:
    """Setup-time CARE on the host: (S, K) as float64 numpy, from scipy's
    ``solve_continuous_are``."""
    from scipy.linalg import solve, solve_continuous_are

    A, B, Q, R = (np.asarray(v, np.float64) for v in (A, B, Q, R))
    S = solve_continuous_are(A, B, Q, R)
    S = 0.5 * (S + S.T)
    K = solve(R, B.T @ S)
    return S, K


def linearize(f: Callable, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuous-time Jacobians A = df/dx, B = df/du at (x, u).  Leading
    axes of x (..., n) and u (..., m) are batch axes, taken by
    ``torch.func.vmap`` over ``jacfwd``.  The Jacobians come back in x's
    dtype (``jacfwd`` promotes the tangent of a 0-d tensor times a Python
    float to float64)."""
    jac = torch.func.jacfwd(f, argnums=(0, 1))
    batch = torch.broadcast_shapes(x.shape[:-1], u.shape[:-1])
    n, m = x.shape[-1], u.shape[-1]
    if batch:
        A, B = torch.func.vmap(jac)(x.expand(batch + (n,)).reshape(-1, n),
                                    u.expand(batch + (m,)).reshape(-1, m))
    else:
        A, B = jac(x, u)
    return (A.to(x.dtype).reshape(batch + (n, n)),
            B.to(x.dtype).reshape(batch + (n, m)))


def lqr_setup(f: Callable, x_eq, u_eq, Q, R) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """Linearize f at (x_eq, u_eq) in float64 and solve the CARE on the
    host."""
    x = torch.as_tensor(np.asarray(x_eq, np.float64))
    u = torch.as_tensor(np.asarray(u_eq, np.float64))
    A, B = linearize(f, x, u)
    return care_lqr_host(A.numpy(), B.numpy(), Q, R)


def constant_lqr(S, K) -> Callable:
    """lqr(x, u) serving one (S, K), as float32, broadcast over x's batch
    axes on x's device (the LTI pattern of the reference demos)."""
    S = Const(np.asarray(S, np.float32))
    K = Const(np.asarray(K, np.float32))

    def lqr(x, u):
        del u
        batch = x.shape[:-1]
        Sd, Kd = S.like(x, torch.float32), K.like(x, torch.float32)
        return Sd.expand(batch + Sd.shape), Kd.expand(batch + Kd.shape)

    return lqr


def make_constant_lqr(A, B, Q, R) -> Callable:
    """Solve the CARE once on the host and serve its (S, K) everywhere."""
    return constant_lqr(*care_lqr_host(A, B, Q, R))


def make_relinearized_lqr(f: Callable, Q, R, u_eq=None,
                          x_map: Callable | None = None) -> Callable:
    """lqr(x, u) that re-linearizes f and re-solves the CARE at every
    state, batched over x's leading axes, on x's device.

    ``u_eq`` fixes the control linearization point (e.g. hover thrust).
    ``x_map`` (batch-leading) maps the state to the linearization point and
    is applied outside the differentiation: the Jacobians are of f itself
    at x_map(x), so no coupling is zeroed the way a clamp inside f would.

    The CARE is solved in fp64 and (S, K) returned in x's dtype.  At a node
    far from hover (a tumbling quadrotor, rates of tens of rad/s) the fp32
    sign iteration loses every digit of S, its definiteness too, and a node
    whose S is indefinite is every candidate's nearest under the e'Se
    metric: a tree then grows from it alone.  fp64 holds S there to 1e-6
    (the fp32 Jacobians' rounding).

    ``lqr.spanned(spans)`` (``utils.timing.spanned``) is the same lqr timing
    itself in a ``PhaseTimer``: the span ``lqr.linearize`` (``x_map`` and
    the Jacobians), the span ``lqr.care`` (``care_lqr``) and the tally
    ``lqr.rows``, the states solved, read from the shapes on the host."""
    Qc = Const(np.asarray(Q, np.float32))
    Rc = Const(np.asarray(R, np.float32))
    ueq = None if u_eq is None else Const(np.asarray(u_eq, np.float32))

    def solve(x, u, spans):
        with spans.span("lqr.linearize"):
            xlin = x if x_map is None else x_map(x)
            if ueq is None:
                ulin = u
            else:
                ulin = ueq.like(x)
                ulin = ulin.expand(x.shape[:-1] + ulin.shape)
            A, B = linearize(f, xlin, ulin)
        with spans.span("lqr.care"):
            f64 = torch.float64
            S, K = care_lqr(A.to(f64), B.to(f64), Qc.like(x, f64),
                            Rc.like(x, f64))
            out = S.to(x.dtype), K.to(x.dtype)
        spans.tally("lqr.rows", math.prod(A.shape[:-2]))
        return out

    def lqr(x, u):
        return solve(x, u, NO_SPANS)

    lqr.spanned = lambda spans: lambda x, u: solve(x, u, spans)
    return lqr
