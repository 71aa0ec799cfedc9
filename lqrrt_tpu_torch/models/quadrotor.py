"""12-state quadrotor (port of lqrrt_tpu/models/quadrotor.py).

State  x = [p(3), rpy(3), v(3), w(3)]  (n = 12)
         world position, roll/pitch/yaw, world velocity, body angular rate
Control u = [dT, tx, ty, tz]            thrust DEVIATION from hover + torques

Same constants, formulas and problem dict as the JAX model; every callback
is batch-leading (see the package docstring).  The thrust channel is
parameterized about hover, so the steering law u = K e is gravity-
compensated at zero error.  The LQR re-linearizes about each node (24 x 24
Hamiltonian sign iterations, batched).
"""
from __future__ import annotations

import numpy as np
import torch

from .._const import Const
from ..ops import collision
from ..ops.angles import make_erf
from ..ops.integrate import discretize
from ..ops.riccati import make_relinearized_lqr

NSTATES = 12
NCONTROLS = 4

MASS = 1.0            # kg
G = 9.81
INERTIA = np.array([0.01, 0.01, 0.02], np.float32)   # diag body inertia
T_MAX = 25.0          # N, total thrust ceiling
TAU_MAX = 0.5         # N m
HOVER_T = MASS * G    # total thrust at hover; u[0] is the deviation from it

_INERTIA = Const(INERTIA)


def _rpy_to_R(rpy):
    """Rotation matrices (..., 3, 3) from roll/pitch/yaw (..., 3)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    rows = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr]]
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def _cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def f(x, u):
    rpy, v, w = x[..., 3:6], x[..., 6:9], x[..., 9:12]
    T = torch.clamp(u[..., 0] + HOVER_T, 0.0, T_MAX)
    tau = torch.clamp(u[..., 1:], -TAU_MAX, TAU_MAX)
    R = _rpy_to_R(rpy)
    # Euler-angle rates from body rates (roll-pitch-yaw convention)
    r, p = rpy[..., 0], rpy[..., 1]
    cr, sr = torch.cos(r), torch.sin(r)
    cp = torch.clamp(torch.cos(p), min=0.2)   # guard gimbal lock
    tp = torch.sin(p) / cp
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    rpy_dot = torch.stack([w0 + sr * tp * w1 + cr * tp * w2,
                           cr * w1 - sr * w2,
                           sr / cp * w1 + cr / cp * w2], dim=-1)
    # R @ [0, 0, T] / MASS - [0, 0, G]
    acc = R[..., 2] * (T / MASS)[..., None]
    acc = torch.stack([acc[..., 0], acc[..., 1], acc[..., 2] - G], dim=-1)
    inertia = _INERTIA.like(x)
    w_dot = (tau - _cross(w, inertia * w)) / inertia
    return torch.cat([v, rpy_dot, acc, w_dot], dim=-1)


dynamics = discretize(f, "rk4")

erf = make_erf(NSTATES, angle_dims=(5,))  # yaw wraps; roll/pitch stay small

U_MIN = np.array([-HOVER_T, -TAU_MAX, -TAU_MAX, -TAU_MAX], np.float32)
U_MAX_VEC = np.array([T_MAX - HOVER_T, TAU_MAX, TAU_MAX, TAU_MAX],
                     np.float32)
_U_MIN, _U_MAX = Const(U_MIN), Const(U_MAX_VEC)


def saturate(u):
    return torch.clamp(u, _U_MIN.like(u), _U_MAX.like(u))


def make_lqr(q=(1.0, 1.0, 1.0, 2.0, 2.0, 1.0, 0.3, 0.3, 0.3, 0.1, 0.1, 0.1),
             r=(0.02, 2.0, 2.0, 2.0)):
    Q = np.diag(np.asarray(q, np.float32))
    R = np.diag(np.asarray(r, np.float32))
    return make_relinearized_lqr(f, Q, R,
                                 u_eq=np.zeros(NCONTROLS, np.float32))


def default_problem(obstacles: bool = True, obstacle_model: str = "circles"):
    """Fly 8 m through a column field at constant-ish altitude.

    obstacle_model: "circles", the boat's keyword; the quadrotor has no
    raster of its columns, so "grid" (or any other model) raises
    ValueError."""
    from ..constraints import Constraints

    if obstacle_model != "circles":
        raise ValueError(f"obstacle_model {obstacle_model!r}: the "
                         "quadrotor's columns are circles only (it has no "
                         "raster)")
    centers = np.array([[3.0, 1.0], [5.0, -1.0], [6.5, 1.5]], np.float32)
    radii = np.array([0.8, 0.9, 0.7], np.float32)
    preds = [collision.control_limits(U_MIN, U_MAX_VEC)]
    if obstacles:
        preds.append(collision.circles_free(centers, radii, pos_dims=(0, 1),
                                            margin=0.3))
    constraints = Constraints(
        nstates=NSTATES, ncontrols=NCONTROLS,
        goal_buffer=np.array([0.5, 0.5, 0.5, 0.4, 0.4, 0.5,
                              1.0, 1.0, 1.0, 1.0, 1.0, 1.0], np.float32),
        search_buffer=np.array([[-1.0, 1.0]] * 3 + [[-0.4, 0.4]] * 3 +
                               [[-1.5, 1.5]] * 3 + [[-1.0, 1.0]] * 3,
                               np.float32),
        is_feasible=collision.all_of(*preds))
    x0 = np.zeros(12, np.float32)
    x0[2] = 2.0
    goal = np.zeros(12, np.float32)
    goal[0] = 8.0
    goal[2] = 2.0
    sample_space = np.array(
        [[-1.0, 9.0], [-3.0, 3.0], [1.0, 3.0],
         [-0.5, 0.5], [-0.5, 0.5], [-np.pi, np.pi],
         [-2.0, 2.0], [-2.0, 2.0], [-1.0, 1.0],
         [-1.5, 1.5], [-1.5, 1.5], [-1.0, 1.0]], np.float32)
    return dict(dynamics=dynamics, lqr=make_lqr(), erf=erf,
                constraints=constraints, x0=x0, goal=goal,
                sample_space=sample_space, horizon=3.0, dt=0.05,
                obstacles=(centers, radii), saturate=saturate, wrap_dims=(5,))
