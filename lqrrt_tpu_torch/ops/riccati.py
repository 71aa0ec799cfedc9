"""Setup-time LQR: linearize + CARE + gain (port of ``linearize``,
``care_lqr`` and ``lqr_setup`` from lqrrt_tpu/ops/riccati.py).

This is host work done once per problem, in float64 on the CPU: the
Jacobians come from ``torch.func.jacfwd`` and the Riccati solution from
``scipy.linalg.solve_continuous_are``.  Callers move the resulting
``(S, K)`` to their device as float32.  The JAX package's Gauss-Jordan
inverse and CPU-device plumbing work around TPU-specific problems and have
no counterpart here.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .._const import Const


def linearize(f: Callable, x, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """Continuous-time Jacobians A = df/dx, B = df/du at (x, u)."""
    A = torch.func.jacfwd(f, argnums=0)(x, u)
    B = torch.func.jacfwd(f, argnums=1)(x, u)
    return A, B


def care_lqr(A, B, Q, R) -> Tuple[np.ndarray, np.ndarray]:
    """Continuous-time LQR: (S, K) with A'S + SA - SBR^-1B'S + Q = 0 and
    K = R^-1 B'S, as float64 numpy."""
    from scipy.linalg import solve, solve_continuous_are

    A, B, Q, R = (np.asarray(v, np.float64) for v in (A, B, Q, R))
    S = solve_continuous_are(A, B, Q, R)
    S = 0.5 * (S + S.T)
    K = solve(R, B.T @ S)
    return S, K


def lqr_setup(f: Callable, x_eq, u_eq, Q, R) -> Tuple[np.ndarray,
                                                      np.ndarray]:
    """Linearize f at (x_eq, u_eq) in float64 and solve the CARE."""
    x = torch.as_tensor(np.asarray(x_eq, np.float64))
    u = torch.as_tensor(np.asarray(u_eq, np.float64))
    A, B = linearize(f, x, u)
    return care_lqr(A.numpy(), B.numpy(), Q, R)


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
