"""2-D double-integrator point mass (port of
lqrrt_tpu/models/double_integrator.py).

State  x = [px, py, vx, vy]   (n = 4)
Control u = [fx, fy] / mass    (m = 2)

Linear dynamics, one constant (S, K) from the CARE, circular obstacles and
no angle: the erf is ``torch.subtract``, so on the card the planner takes
kernel A with no wrap dim.  Every callback is batch-leading.

``stacked_problem()`` (no counterpart in the JAX package) plans ``COPIES``
(5) point masses as one state of n = 20: the model at the constant-metric
NN kernel's limit of 20 states.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import collision
from ..ops.integrate import discretize
from ..ops.riccati import make_constant_lqr

NSTATES = 4
NCONTROLS = 2


def f(x, u):
    """Continuous dynamics: unit mass, force control."""
    return torch.cat([x[..., 2:], u], dim=-1)


dynamics = discretize(f, "rk4")

A = np.zeros((4, 4), np.float32)
A[0, 2] = A[1, 3] = 1.0
B = np.zeros((4, 2), np.float32)
B[2, 0] = B[3, 1] = 1.0

erf = torch.subtract

U_MAX = 10.0


def saturate(u):
    return torch.clamp(u, -U_MAX, U_MAX)


def make_lqr(q_pos=1.0, q_vel=0.3, r=0.05):
    Q = np.diag(np.array([q_pos, q_pos, q_vel, q_vel], np.float32))
    R = r * np.eye(2, dtype=np.float32)
    return make_constant_lqr(A, B, Q, R)


def default_problem(obstacles: bool = True):
    """Drive 10 m through a field of five circles."""
    from ..constraints import Constraints

    centers = np.array([[3.0, 1.0], [5.0, -1.5], [6.5, 2.0], [2.0, -2.0],
                        [8.0, 0.0]], np.float32)
    radii = np.array([1.0, 1.2, 0.8, 0.9, 1.0], np.float32)
    preds = [collision.control_limits(-U_MAX * np.ones(2),
                                      U_MAX * np.ones(2))]
    if obstacles:
        preds.append(collision.circles_free(centers, radii, margin=0.1))
    constraints = Constraints(
        nstates=NSTATES, ncontrols=NCONTROLS,
        goal_buffer=np.array([0.5, 0.5, 1.0, 1.0], np.float32),
        search_buffer=np.array([[-2.0, 2.0]] * 2 + [[-3.0, 3.0]] * 2,
                               np.float32),
        is_feasible=collision.all_of(*preds))
    x0 = np.zeros(4, np.float32)
    goal = np.array([10.0, 0.0, 0.0, 0.0], np.float32)
    sample_space = np.array(
        [[-1.0, 11.0], [-4.0, 4.0], [-3.0, 3.0], [-3.0, 3.0]], np.float32)
    return dict(dynamics=dynamics, lqr=make_lqr(), erf=erf,
                constraints=constraints, x0=x0, goal=goal,
                sample_space=sample_space, horizon=2.0, dt=0.05,
                obstacles=(centers, radii), saturate=saturate, wrap_dims=())


COPIES = 5   # stacked_problem's point masses: n = 20


def stacked_problem():
    """``COPIES`` double integrators planned as one: state
    [px, py, vx, vy] of copy i at dims 4i..4i+3, effort [fx, fy] at
    2i..2i+1, each copy from the origin to (10, 0) as in
    ``default_problem``, with its goal box, sample space and effort limits;
    the five circles stand in the way of copy 0 only.  One constant
    (S, K) from the block-diagonal CARE."""
    from ..constraints import Constraints

    base = default_problem(obstacles=False)
    k = COPIES
    n, m = NSTATES * k, NCONTROLS * k

    def f_stacked(x, u):
        xs = x.reshape(x.shape[:-1] + (k, NSTATES))
        us = u.reshape(u.shape[:-1] + (k, NCONTROLS))
        return f(xs, us).reshape(x.shape)

    eye = np.eye(k, dtype=np.float32)
    Q = np.kron(eye, np.diag(np.array([1.0, 1.0, 0.3, 0.3], np.float32)))
    R = np.kron(eye, 0.05 * np.eye(2, dtype=np.float32))
    lqr = make_constant_lqr(np.kron(eye, A), np.kron(eye, B), Q, R)
    centers, radii = default_problem()["obstacles"]
    c = base["constraints"]
    constraints = Constraints(
        nstates=n, ncontrols=m, goal_buffer=np.tile(c.goal_buffer, k),
        search_buffer=np.tile(c.search_buffer, (k, 1)),
        is_feasible=collision.all_of(
            collision.control_limits(-U_MAX * np.ones(m), U_MAX * np.ones(m)),
            collision.circles_free(centers, radii, margin=0.1)))
    return dict(dynamics=discretize(f_stacked, "rk4"), lqr=lqr, erf=erf,
                constraints=constraints, x0=np.tile(base["x0"], k),
                goal=np.tile(base["goal"], k),
                sample_space=np.tile(base["sample_space"], (k, 1)),
                horizon=base["horizon"], dt=base["dt"],
                obstacles=(centers, radii), saturate=saturate, wrap_dims=())
