"""Plain PyTorch reference of the quadrotor, a 12-state rigid body, built
from the numbers of its configuration file alone (``dynamics``, ``lqr``,
``buoys``): the dynamics with the thrust and torque clamps inside f, the
control saturation to its two-sided box, the RK4 step, the wrapped state
error, the columns, and the per-node LQR (S, K), re-linearised at each
state and solved here.

The RK4 step, the wrapped error, the circles and the CARE (the scaled
sign iteration with its own Gauss-Jordan inverse, 40 iterations) are the
car reference's (``car.py``), loaded from its file; this file gives the
quadrotor's f, box and Jacobians.  Every function takes tensors of any
floating dtype and computes in it: float64 for the reference, bfloat16 for
the controls of ``portbench/control.py`` and of the per-node LQR check.

State x = [p (3), roll, pitch, yaw, v (3), w (3)]: the world position, the
roll/pitch/yaw angles, the world velocity and the body rates; control
u = [dT, tx, ty, tz]: the thrust's deviation from hover and the body
torques (the standard rigid-body multirotor: Mahony, Kumar & Corke, IEEE
Robotics & Automation Magazine 19(3), 2012).
"""
from __future__ import annotations

import contextlib
import importlib.util
from pathlib import Path

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location(
    "portbench_reference_car_base", Path(__file__).with_name("car.py"))
_car = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_car)


@contextlib.contextmanager
def _no_tf32():
    """Matrix products in full float32 inside the block (TF32 off), the
    process's settings put back after it."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [fl.allow_tf32 for fl in flags]
    for fl in flags:
        fl.allow_tf32 = False
    try:
        yield
    finally:
        for fl, v in zip(flags, saved):
            fl.allow_tf32 = v


class Quadrotor(_car.Car):
    def __init__(self, cfg: dict):
        d = cfg["dynamics"]
        if d["integrator"] != "rk4":
            raise ValueError(f"unknown integrator {d['integrator']!r}")
        self.n, self.m = int(cfg["nstates"]), int(cfg["ncontrols"])
        self.dt = float(cfg["dt"])
        self.wrap_dims = tuple(int(i) for i in cfg["wrap_dims"])
        self.mass, self.g = float(d["mass"]), float(d["gravity"])
        self.inertia = tuple(float(v) for v in d["inertia"])
        self.t_max = float(d["thrust_max"])
        self.tau_max = float(d["torque_max"])
        self.cos_floor = float(d["pitch_cos_floor"])
        self.hover = self.mass * self.g
        tau = self.tau_max
        self.u_min = (-self.hover, -tau, -tau, -tau)
        self.u_max = (self.t_max - self.hover, tau, tau, tau)
        # the judge's box |u| <= wmax takes the larger face of each
        # component: the thrust's upper face and every torque face exactly,
        # the thrust's lower face (-hover) only at -(t_max - hover)
        self.wmax = tuple(max(-lo, hi) for lo, hi in zip(self.u_min,
                                                         self.u_max))
        q = cfg["lqr"]
        self.q, self.r = tuple(q["q"]), tuple(q["r"])
        self.u_eq = tuple(q["u_eq"])
        self.cfg = cfg

    def f(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Continuous dynamics xdot = f(x, u): the total thrust hover + dT
        clamped to [0, t_max] and the torques to +-tau_max inside f; the
        Euler-angle rates from the body rates with cos(pitch) floored."""
        c = lambda v: self._c(v, x)                      # noqa: E731
        roll, pitch, yaw = x[..., 3], x[..., 4], x[..., 5]
        v, w = x[..., 6:9], x[..., 9:12]
        T = torch.clamp(u[..., 0] + c(self.hover), c(0.0), c(self.t_max))
        tau = torch.clamp(u[..., 1:], -c(self.tau_max), c(self.tau_max))
        sr, cr = torch.sin(roll), torch.cos(roll)
        sp, cp = torch.sin(pitch), torch.cos(pitch)
        sy, cy = torch.sin(yaw), torch.cos(yaw)
        # the body z axis in the world (R's third column), times T / mass
        zb = torch.stack([cy * sp * cr + sy * sr, sy * sp * cr - cy * sr,
                          cp * cr], -1)
        acc = zb * (T / c(self.mass))[..., None] - c((0.0, 0.0, self.g))
        cpf = torch.clamp(cp, min=self.cos_floor)
        w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
        rpy_dot = torch.stack([w0 + (sr * w1 + cr * w2) * (sp / cpf),
                               cr * w1 - sr * w2,
                               (sr * w1 + cr * w2) / cpf], -1)
        inertia = c(self.inertia)
        w_dot = (tau - torch.linalg.cross(w, inertia * w)) / inertia
        return torch.cat([v, rpy_dot, acc, w_dot], -1)

    def saturate(self, u: torch.Tensor) -> torch.Tensor:
        """u clamped to its two-sided box [u_min, u_max]."""
        return torch.maximum(torch.minimum(u, self._c(self.u_max, u)),
                             self._c(self.u_min, u))

    def in_box(self, u) -> np.ndarray:
        """(...,) bool: controls u (..., m) inside the two-sided box, in
        float32 (the configuration's precision), both faces exact: the
        check the judge's one-sided |u| <= wmax makes only in part."""
        u = np.asarray(u, np.float32)
        return ((u >= np.asarray(self.u_min, np.float32))
                & (u <= np.asarray(self.u_max, np.float32))).all(-1)

    # ------------------------------------------------------------ the LQR

    def gain(self):
        """None: the quadrotor has no one gain.  Its LQR is re-linearised
        at every node (``lqr``), and the judge's ``gain_med`` takes a
        single constant gain, so its plans are judged without it."""
        return None

    def lqr(self, x: torch.Tensor):
        """The per-node (S, K) at states x (N, n), in x's dtype: the car
        reference's CARE on this model's Jacobians, its products in full
        float32 where x is float32."""
        with _no_tf32():
            return super().lqr(x)

    def x_map(self, x: torch.Tensor) -> torch.Tensor:
        """The linearisation point: the state itself."""
        return x

    def jacobians(self, x: torch.Tensor):
        """(A, B), (N, n, n) and (N, n, m): df/dx and df/du at (x, u_eq)
        for states x (N, n), in x's dtype, a column at a time by
        forward-mode differentiation of this file's f (the clamps pass the
        derivative strictly inside their limits)."""
        u = self._c(self.u_eq, x).repeat(x.shape[0], 1)

        def cols(z, fn):
            eye = torch.eye(z.shape[-1], dtype=z.dtype, device=z.device)
            return torch.stack(
                [torch.func.jvp(fn, (z,), (eye[i].expand_as(z),))[1]
                 for i in range(z.shape[-1])], -1)

        A = cols(x, lambda z: self.f(z, u))
        B = cols(u, lambda z: self.f(x, z))
        return A.to(x.dtype), B.to(x.dtype)
