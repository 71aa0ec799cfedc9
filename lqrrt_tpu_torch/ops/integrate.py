"""Fixed-step integrators (port of lqrrt_tpu/ops/integrate.py).

``f(x, u) -> xdot`` is batch-leading, so every step broadcasts over the
leading axes of ``x`` and ``u``.
"""
from __future__ import annotations

from typing import Callable


def euler_step(f: Callable, x, u, dt):
    """One explicit-Euler step of ``xdot = f(x, u)``."""
    return x + dt * f(x, u)


def rk4_step(f: Callable, x, u, dt):
    """One classic RK4 step of ``xdot = f(x, u)`` (zero-order-hold u)."""
    k1 = f(x, u)
    k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u)
    k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def discretize(f: Callable, method: str = "rk4") -> Callable:
    """Build ``dynamics(x, u, dt) -> x_next`` from continuous-time f."""
    if method == "euler":
        return lambda x, u, dt: euler_step(f, x, u, dt)
    if method == "rk4":
        return lambda x, u, dt: rk4_step(f, x, u, dt)
    raise ValueError(f"unknown integrator {method!r}")
