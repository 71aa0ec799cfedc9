"""Car-like vehicle, kinematic bicycle (port of lqrrt_tpu/models/car.py).

State  x = [px, py, theta, v]  (n = 4)
Control u = [a, delta]          accel + steering angle  (m = 2)

Same constants, formulas and problem dict as the JAX model; every callback
is batch-leading (see the package docstring).  The LQR re-linearizes about
each node: the batched CARE path.
"""
from __future__ import annotations

import numpy as np
import torch

from .._const import Const
from ..ops import collision
from ..ops.angles import make_erf
from ..ops.integrate import discretize
from ..ops.riccati import make_relinearized_lqr

NSTATES = 4
NCONTROLS = 2
WHEELBASE = 2.5       # m
DELTA_MAX = 0.55      # rad
A_MAX = 3.0           # m/s^2


def f(x, u):
    theta, v = x[..., 2], x[..., 3]
    a = torch.clamp(u[..., 0], -A_MAX, A_MAX)
    delta = torch.clamp(u[..., 1], -DELTA_MAX, DELTA_MAX)
    return torch.stack([v * torch.cos(theta),
                        v * torch.sin(theta),
                        v * torch.tan(delta) / WHEELBASE,
                        a], dim=-1)


dynamics = discretize(f, "rk4")

erf = make_erf(NSTATES, angle_dims=(2,))

U_MIN = np.array([-A_MAX, -DELTA_MAX], np.float32)
U_MAX_VEC = np.array([A_MAX, DELTA_MAX], np.float32)
_U_MIN, _U_MAX = Const(U_MIN), Const(U_MAX_VEC)


def saturate(u):
    return torch.clamp(u, _U_MIN.like(u), _U_MAX.like(u))


def x_map(x):
    """The linearization point: |v| floored at 0.8 m/s so the bicycle stays
    stabilizable at rest (the tan/cos Jacobians vanish at v = 0)."""
    v = x[..., 3:4]
    v_safe = torch.where(v.abs() < 0.8, torch.where(v < 0, -0.8, 0.8), v)
    return torch.cat([x[..., :3], v_safe], dim=-1)


def make_lqr(q=(1.0, 1.0, 0.5, 0.3), r=(0.5, 2.0)):
    """Re-linearized LQR: the CARE re-solved at every node, batched."""
    Q = np.diag(np.asarray(q, np.float32))
    R = np.diag(np.asarray(r, np.float32))
    return make_relinearized_lqr(f, Q, R, u_eq=np.zeros(2, np.float32),
                                 x_map=x_map)


def default_problem(obstacles: bool = True, obstacle_model: str = "circles"):
    """Parking-lot style scenario with a slalom of obstacles.

    obstacle_model: "circles", the boat's keyword; the car has no raster of
    its slalom, so "grid" (or any other model) raises ValueError."""
    from ..constraints import Constraints

    if obstacle_model != "circles":
        raise ValueError(f"obstacle_model {obstacle_model!r}: the car's "
                         "slalom is circles only (it has no raster)")
    centers = np.array([[8.0, 1.5], [14.0, -1.5], [20.0, 1.5]], np.float32)
    radii = np.array([2.0, 2.0, 2.0], np.float32)
    preds = [collision.control_limits(U_MIN, U_MAX_VEC)]
    if obstacles:
        preds.append(collision.circles_free(centers, radii, margin=0.5))
    constraints = Constraints(
        nstates=NSTATES, ncontrols=NCONTROLS,
        goal_buffer=np.array([1.0, 1.0, 0.5, 1.0], np.float32),
        search_buffer=np.array([[-3.0, 3.0], [-3.0, 3.0],
                                [-np.pi, np.pi], [-2.0, 2.0]], np.float32),
        is_feasible=collision.all_of(*preds))
    x0 = np.array([0.0, 0.0, 0.0, 0.1], np.float32)
    goal = np.array([26.0, 0.0, 0.0, 0.0], np.float32)
    sample_space = np.array(
        [[-2.0, 30.0], [-6.0, 6.0], [-np.pi, np.pi], [0.0, 6.0]], np.float32)
    return dict(dynamics=dynamics, lqr=make_lqr(), erf=erf,
                constraints=constraints, x0=x0, goal=goal,
                sample_space=sample_space, horizon=4.0, dt=0.05,
                obstacles=(centers, radii), saturate=saturate, wrap_dims=(2,))
