"""Plain PyTorch reference of the car, a kinematic bicycle, built from the
numbers of its configuration file alone (``dynamics``, ``lqr``,
``buoys``): the dynamics with the control clamps inside f, the control
saturation, the RK4 step, the wrapped state error, the circles, and the
per-node LQR (S, K), re-linearised at each state and solved here.

Every function takes tensors of any floating dtype and computes in it, its
constants rounded to that dtype: float64 for the reference, bfloat16 for
the controls of ``portbench/control.py`` and of the per-node LQR check.

State x = [px, py, theta, v], control u = [a, delta] (acceleration,
steering angle).
"""
from __future__ import annotations

import math

import torch

_SIGN_ITERS = 40     # the sign iteration's trip count (converged in float64)


class Car:
    def __init__(self, cfg: dict):
        d = cfg["dynamics"]
        if d["integrator"] != "rk4":
            raise ValueError(f"unknown integrator {d['integrator']!r}")
        self.n, self.m = int(cfg["nstates"]), int(cfg["ncontrols"])
        self.dt = float(cfg["dt"])
        self.wrap_dims = tuple(int(i) for i in cfg["wrap_dims"])
        self.base = float(d["wheelbase"])
        self.wmax = (float(d["accel_max"]), float(d["steer_max"]))
        q = cfg["lqr"]
        self.q, self.r = tuple(q["q"]), tuple(q["r"])
        self.v_floor = float(q["v_floor"])
        self.u_eq = tuple(q["u_eq"])
        self.cfg = cfg

    @staticmethod
    def _c(vals, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(vals, dtype=like.dtype, device=like.device)

    def f(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Continuous dynamics xdot = f(x, u), the acceleration and the
        steering angle clamped to their limits inside f."""
        theta, v = x[..., 2], x[..., 3]
        a = torch.clamp(u[..., 0], -self.wmax[0], self.wmax[0])
        delta = torch.clamp(u[..., 1], -self.wmax[1], self.wmax[1])
        return torch.stack([v * torch.cos(theta), v * torch.sin(theta),
                            v * torch.tan(delta) / self.base, a], -1)

    def saturate(self, u: torch.Tensor) -> torch.Tensor:
        w = self._c(self.wmax, u)
        return torch.maximum(torch.minimum(u, w), -w)

    def step(self, x: torch.Tensor, u: torch.Tensor,
             saturate: bool = True) -> torch.Tensor:
        """One RK4 step of dt under the zero-order-hold control u."""
        if saturate:
            u = self.saturate(u)
        h = self.dt
        k1 = self.f(x, u)
        k2 = self.f(x + 0.5 * h * k1, u)
        k3 = self.f(x + 0.5 * h * k2, u)
        k4 = self.f(x + h * k3, u)
        return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)

    def error(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a - b with the angle dims wrapped into [-pi, pi)."""
        e = a - b
        for d in self.wrap_dims:
            e[..., d] = torch.remainder(e[..., d] + math.pi,
                                        2.0 * math.pi) - math.pi
        return e

    # ------------------------------------------------------------ the LQR

    def gain(self):
        """None: the car has no one gain.  Its LQR is re-linearised at
        every node (``lqr``), and the judge's ``gain_med`` takes a single
        constant gain, so the car's plans are judged without it."""
        return None

    def x_map(self, x: torch.Tensor) -> torch.Tensor:
        """The linearisation point: |v| floored at ``v_floor`` (the sign
        kept, 0 taken as positive), so the bicycle stays stabilisable."""
        v = x[..., 3]
        fl = torch.full_like(v, self.v_floor)
        v = torch.where(v.abs() < self.v_floor,
                        torch.where(v < 0, -fl, fl), v)
        return torch.cat([x[..., :3], v[..., None]], -1)

    def jacobians(self, x: torch.Tensor):
        """(A, B), (..., n, n) and (..., n, m): df/dx and df/du in closed
        form at (x, u_eq), in x's dtype (the clamps pass the derivative
        strictly inside their limits)."""
        theta, v = x[..., 2], x[..., 3]
        ue = self._c(self.u_eq, x)
        delta = torch.clamp(ue[1], -self.wmax[1], self.wmax[1])
        inside = ((ue.abs() < self._c(self.wmax, x))
                  .to(x.dtype))                     # (m,)
        c, s = torch.cos(theta), torch.sin(theta)
        t = torch.tan(delta)
        z = torch.zeros_like(v)
        A = torch.stack([
            torch.stack([z, z, -v * s, c], -1),
            torch.stack([z, z, v * c, s], -1),
            torch.stack([z, z, z, (t / self.base).expand_as(v)], -1),
            torch.stack([z, z, z, z], -1)], -2)
        db = v * (1 + t * t) / self.base * inside[1]
        B = torch.stack([
            torch.stack([z, z], -1),
            torch.stack([z, z], -1),
            torch.stack([z, db], -1),
            torch.stack([z + inside[0], z], -1)], -2)
        return A, B

    def lqr(self, x: torch.Tensor):
        """The per-node (S, K) at ``x_map(x)`` for states x (N, n), in x's
        dtype: the CARE A'S + SA - S B R^-1 B' S + Q = 0 solved by the
        scaled Newton iteration of the Hamiltonian's matrix sign, each
        inverse and determinant by Gauss-Jordan elimination with partial
        pivoting written here in elementwise operations (so it runs in
        any dtype), S from the sign's stable-subspace equations by their
        normal equations; K = R^-1 B'S."""
        xl = self.x_map(x)
        A, B = self.jacobians(xl)
        n = self.n
        Q = torch.diag(self._c(self.q, x))
        rinv = 1.0 / self._c(self.r, x)
        G = (B * rinv) @ B.mT
        H = torch.cat([torch.cat([A, -G], -1),
                       torch.cat([-Q.expand_as(A), -A.mT], -1)], -2)
        W = _matrix_sign(H)
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        M = torch.cat([W[..., :n, n:], W[..., n:, n:] + eye], -2)
        rhs = -torch.cat([W[..., :n, :n] + eye, W[..., n:, :n]], -2)
        S = _inverse(M.mT @ M)[0] @ (M.mT @ rhs)
        S = 0.5 * (S + S.mT)
        K = rinv[:, None] * (B.mT @ S)
        return S, K

    # ------------------------------------------------------------ obstacles

    def circles_free(self, p):
        """(...,) bool: positions p (..., 2) outside every circle plus its
        margin, in float32: d2 = (c - p)^2 summed over x, y against
        (r + margin)^2, both rounded as float32 (the configuration's
        precision)."""
        b = self.cfg["buoys"]
        c = torch.tensor(b["centers"], dtype=torch.float32)
        r2 = (torch.tensor(b["radii"], dtype=torch.float32)
              + torch.tensor(b["margin"], dtype=torch.float32)) ** 2
        p = torch.as_tensor(p, dtype=torch.float32)
        d = c - p[..., None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
        return (d2 > r2).all(-1).numpy()


def _inverse(Z: torch.Tensor):
    """(Z^-1, log|det Z|) of a batch of square matrices (N, d, d), by
    Gauss-Jordan elimination with partial pivoting, in Z's dtype."""
    N, d, _ = Z.shape
    eye = torch.eye(d, dtype=Z.dtype, device=Z.device)
    M = torch.cat([Z, eye.expand(N, d, d)], -1)
    rows = torch.arange(N, device=Z.device)
    logdet = torch.zeros(N, dtype=Z.dtype, device=Z.device)
    for k in range(d):
        piv = k + M[:, k:, k].abs().argmax(-1)
        top, low = M[rows, k].clone(), M[rows, piv].clone()
        M[rows, piv] = top
        M[rows, k] = low
        p = M[:, k, k].clone()
        logdet = logdet + torch.log(p.abs())
        M[:, k] = M[:, k] / p[:, None]
        col = M[:, :, k].clone()
        col[:, k] = 0
        M = M - col[:, :, None] * M[:, k][:, None, :]
    return M[:, :, d:], logdet


def _matrix_sign(H: torch.Tensor, iters: int = _SIGN_ITERS) -> torch.Tensor:
    """sign(H) by Z <- (c Z + (c Z)^-1) / 2 with the determinant scaling
    c = |det Z|^(-1/d)."""
    d = H.shape[-1]
    Z = H
    for _ in range(iters):
        Zi, logdet = _inverse(Z)
        c = torch.exp(-logdet / d)[:, None, None]
        Z = 0.5 * (c * Z + Zi / c)
    return Z
