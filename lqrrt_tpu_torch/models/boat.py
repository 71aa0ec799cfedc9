"""WAM-V-style 3-DOF surface vessel (port of lqrrt_tpu/models/boat.py).

State  x = [px, py, psi, vx, vy, w]   (n = 6)
Control u = [Fx, Fy, Mz]              (m = 3)

Same constants, formulas and problem dicts as the JAX model; every callback
is batch-leading (see the package docstring).
"""
from __future__ import annotations

import numpy as np
import torch

from .._const import Const
from ..ops import collision
from ..ops.angles import make_erf
from ..ops.integrate import discretize
from ..ops.riccati import constant_lqr, lqr_setup

NSTATES = 6
NCONTROLS = 3

M_MASS = 350.0
M_SWAY = 400.0
I_YAW = 400.0
D_LIN = np.array([30.0, 60.0, 60.0], np.float32)
D_QUAD = np.array([60.0, 120.0, 120.0], np.float32)
WRENCH_MAX = np.array([600.0, 300.0, 600.0], np.float32)

_Minv = np.array([1.0 / M_MASS, 1.0 / M_SWAY, 1.0 / I_YAW], np.float32)
_D_LIN, _D_QUAD, _MINV = Const(D_LIN), Const(D_QUAD), Const(_Minv)
_WMAX = Const(WRENCH_MAX)


def f(x, u):
    """Continuous 3-DOF vessel dynamics, body-frame velocities."""
    psi = x[..., 2]
    nu = x[..., 3:]
    vx, vy, w = x[..., 3], x[..., 4], x[..., 5]
    c, s = torch.cos(psi), torch.sin(psi)
    pdot = torch.stack([c * vx - s * vy, s * vx + c * vy, w], dim=-1)
    cor = torch.stack([M_SWAY * vy * w,
                       -M_MASS * vx * w,
                       (M_MASS - M_SWAY) * vx * vy], dim=-1)
    drag = _D_LIN.like(x) * nu + _D_QUAD.like(x) * nu * torch.abs(nu)
    nudot = _MINV.like(x) * (u + cor - drag)
    return torch.cat([pdot, nudot], dim=-1)


def saturate(u):
    wmax = _WMAX.like(u)
    return torch.clamp(u, -wmax, wmax)


def f_saturated(x, u):
    return f(x, saturate(u))


dynamics = discretize(f_saturated, "rk4")

erf = make_erf(NSTATES, angle_dims=(2,))  # psi wraps


def make_lqr(q=(1.0, 1.0, 2.0, 0.1, 0.1, 0.2), r=(2e-5, 2e-5, 2e-5)):
    """Constant LQR linearized about rest (CARE solved once on the host)."""
    x_eq = np.zeros(NSTATES, np.float32)
    x_eq[3] = 0.1
    S, K = lqr_setup(f, x_eq, np.zeros(NCONTROLS, np.float32),
                     np.diag(np.asarray(q, np.float32)),
                     np.diag(np.asarray(r, np.float32)))
    return constant_lqr(S, K)


def _problem(goal, sample_space, obstacles, is_feasible):
    from ..constraints import Constraints

    constraints = Constraints(
        nstates=NSTATES, ncontrols=NCONTROLS,
        goal_buffer=np.array([1.5, 1.5, 0.3, 0.8, 0.8, 0.5], np.float32),
        search_buffer=np.array(_SEARCH, np.float32),
        is_feasible=is_feasible)
    return dict(dynamics=dynamics, lqr=make_lqr(), erf=erf,
                constraints=constraints, x0=np.zeros(6, np.float32),
                goal=goal, sample_space=sample_space, horizon=5.0, dt=0.05,
                obstacles=obstacles, saturate=saturate, wrap_dims=(2,))


_SEARCH = [[-5.0, 5.0], [-5.0, 5.0], [-np.pi, np.pi],
           [-1.0, 2.0], [-0.5, 0.5], [-0.5, 0.5]]


def buoy_grid(centers, radii, resolution: float = 0.25):
    """The buoy field rasterised as the JAX model does it: cells of
    ``resolution`` metres over x in [-4, 46), y in [-12, 12), occupied
    where the cell centre lies within radius + 1.0 m of a buoy (96 x 200
    cells at 0.25 m)."""
    origin = np.array([-4.0, -12.0], np.float32)
    W = int(round((46.0 - origin[0]) / resolution))  # noqa: N806
    H = int(round((12.0 - origin[1]) / resolution))  # noqa: N806
    gx = origin[0] + (np.arange(W) + 0.5) * resolution
    gy = origin[1] + (np.arange(H) + 0.5) * resolution
    X, Y = np.meshgrid(gx, gy)                       # noqa: N806 (H, W)
    occ = np.zeros((H, W), bool)
    for c, r in zip(centers, radii):
        occ |= (X - c[0]) ** 2 + (Y - c[1]) ** 2 <= (r + 1.0) ** 2
    return collision.OccupancyGrid(occ, origin, resolution)


def default_problem(obstacles: bool = True, obstacle_model: str = "circles",
                    grid_resolution: float = 0.25):
    """Benchmark scenario: 40 m transit through a buoy field.

    obstacle_model: "circles" (the reference-demo model) or "grid", the
    same field rasterised into an ``OccupancyGrid`` (``buoy_grid``), the
    deployment-grade feasibility the WAM-V ran with."""
    centers = np.array([[12.0, 3.0], [18.0, -4.0], [25.0, 2.0], [30.0, -3.0],
                        [8.0, -6.0], [22.0, 8.0], [34.0, 4.0]], np.float32)
    radii = np.array([2.5, 3.0, 2.0, 2.5, 2.0, 2.5, 2.0], np.float32)
    is_feasible = None
    if obstacles and obstacle_model == "circles":
        is_feasible = collision.circles_free(centers, radii, margin=1.0)
    elif obstacles and obstacle_model == "grid":
        grid = buoy_grid(centers, radii, grid_resolution)
        is_feasible = collision.all_of(grid.feasibility(footprint_radius=0.0))
    elif obstacles:
        raise ValueError(f"unknown obstacle_model {obstacle_model!r}")
    goal = np.array([40.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    sample_space = np.array(
        [[-2.0, 44.0], [-10.0, 10.0], [-np.pi, np.pi],
         [0.0, 3.0], [-0.5, 0.5], [-0.7, 0.7]], np.float32)
    return _problem(goal, sample_space, (centers, radii), is_feasible)


def hard_problem():
    """Anytime-quality scenario: 56 m transit through two offset walls."""
    rows = [[18.0, y] for y in (-12.0, -8.0, -4.0, 0.0, 4.0)]
    rows += [[36.0, y] for y in (-4.0, 0.0, 4.0, 8.0, 12.0)]
    centers = np.asarray(rows, np.float32)
    radii = np.full((len(rows),), 2.2, np.float32)
    goal = np.array([52.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    sample_space = np.array(
        [[-2.0, 56.0], [-15.0, 15.0], [-np.pi, np.pi],
         [0.0, 3.0], [-0.5, 0.5], [-0.7, 0.7]], np.float32)
    return _problem(goal, sample_space, (centers, radii),
                    collision.circles_free(centers, radii, margin=1.0))
