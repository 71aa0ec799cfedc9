"""Plain PyTorch reference of the WAM-V boat, a 3-DOF surface vessel, built
from the numbers of its configuration file alone (``dynamics``, ``lqr``,
``buoys``, ``grid``): the body-frame dynamics, the wrench saturation, the
RK4 step, the wrapped state error, the constant LQR gain (linearised and
solved here, in float64) and the obstacle field, as circles and as the
raster of the buoys.

Every function takes tensors of any floating dtype and computes in it, its
constants rounded to that dtype: float64 for the reference, bfloat16 for
the control of ``portbench/control.py``.

State x = [px, py, psi, vx, vy, w], control u = [Fx, Fy, Mz].
"""
from __future__ import annotations

import math

import numpy as np
import torch


class Boat:
    def __init__(self, cfg: dict):
        d = cfg["dynamics"]
        if d["integrator"] != "rk4":
            raise ValueError(f"unknown integrator {d['integrator']!r}")
        self.n, self.m = int(cfg["nstates"]), int(cfg["ncontrols"])
        self.dt = float(cfg["dt"])
        self.wrap_dims = tuple(int(i) for i in cfg["wrap_dims"])
        self.mass = float(d["mass"])
        self.sway = float(d["sway_mass"])
        self.inv_m = (1.0 / d["mass"], 1.0 / d["sway_mass"],
                      1.0 / d["yaw_inertia"])
        self.d_lin = tuple(d["d_lin"])
        self.d_quad = tuple(d["d_quad"])
        self.wmax = tuple(d["wrench_max"])
        self.cfg = cfg

    @staticmethod
    def _c(vals, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor(vals, dtype=like.dtype, device=like.device)

    def f(self, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Continuous dynamics xdot = f(x, u) (no saturation)."""
        psi, vx, vy, w = x[..., 2], x[..., 3], x[..., 4], x[..., 5]
        nu = x[..., 3:]
        c, s = torch.cos(psi), torch.sin(psi)
        ms, mm = self.sway, self.mass
        pdot = torch.stack([c * vx - s * vy, s * vx + c * vy, w], -1)
        cor = torch.stack([ms * vy * w, -mm * vx * w, (mm - ms) * vx * vy], -1)
        drag = (self._c(self.d_lin, x) * nu
                + self._c(self.d_quad, x) * nu * nu.abs())
        nudot = self._c(self.inv_m, x) * (u + cor - drag)
        return torch.cat([pdot, nudot], -1)

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

    # ------------------------------------------------------------- LQR gain

    def gain(self) -> np.ndarray:
        """The constant LQR gain K (m, n), float64: f linearised at the
        configuration's x_eq and u = 0 by central differences, the CARE
        solved from the stable invariant subspace of the Hamiltonian."""
        q = self.cfg["lqr"]
        x_eq = torch.tensor(q["x_eq"], dtype=torch.float64)
        u_eq = torch.zeros(self.m, dtype=torch.float64)
        h = 1e-7    # the drag's nu |nu| has a kink at rest: keep h small
        A = np.empty((self.n, self.n))
        B = np.empty((self.n, self.m))
        for i in range(self.n):
            dx = torch.zeros(self.n, dtype=torch.float64)
            dx[i] = h
            A[:, i] = ((self.f(x_eq + dx, u_eq) - self.f(x_eq - dx, u_eq))
                       / (2 * h)).numpy()
        for i in range(self.m):
            du = torch.zeros(self.m, dtype=torch.float64)
            du[i] = h
            B[:, i] = ((self.f(x_eq, u_eq + du) - self.f(x_eq, u_eq - du))
                       / (2 * h)).numpy()
        Q = np.diag(np.asarray(q["q"], np.float64))
        R = np.diag(np.asarray(q["r"], np.float64))
        S = care(A, B, Q, R)
        return np.linalg.solve(R, B.T @ S)

    # ------------------------------------------------------------ obstacles

    def circles_free(self, p: np.ndarray) -> np.ndarray:
        """(...,) bool: positions p (..., 2) outside every buoy plus its
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

    def raster(self, shift=None) -> np.ndarray:
        """(H, W) bool occupancy of the buoys (plus their margin) over the
        configuration's grid: a cell is occupied where its centre lies
        within the radius plus the margin of a buoy, the centres in
        float64 and (r + margin)^2 rounded as float32.  ``shift`` (S, 2)
        moves the field a scenario: (S, H, W)."""
        g, b = self.cfg["grid"], self.cfg["buoys"]
        org = np.asarray(g["origin"], np.float32)
        res = float(g["resolution"])
        W = int(round((g["extent"][0] - org[0]) / res))
        H = int(round((g["extent"][1] - org[1]) / res))
        gx = org[0] + (np.arange(W) + 0.5) * res
        gy = org[1] + (np.arange(H) + 0.5) * res
        cen = np.asarray(b["centers"], np.float32)
        r2 = ((np.asarray(b["radii"], np.float32) + np.float32(g["margin"]))
              ** 2).astype(np.float32)
        sh = np.zeros((1, 2), np.float32) if shift is None else np.asarray(
            shift, np.float32).reshape(-1, 2)
        occ = np.zeros((len(sh), H, W), bool)
        for k in range(len(cen)):
            cx = cen[k, 0] + sh[:, 0]
            cy = cen[k, 1] + sh[:, 1]
            occ |= ((gx[None, None, :] - cx[:, None, None]) ** 2
                    + (gy[None, :, None] - cy[:, None, None]) ** 2 <= r2[k])
        return occ[0] if shift is None else occ

    def grid_free(self, p: np.ndarray, occ: np.ndarray,
                  which: np.ndarray | None = None) -> np.ndarray:
        """(...,) bool: positions p (..., 2) in a free cell of ``occ``
        (H, W), or of ``occ[which]`` for (S, H, W) grids; out of bounds is
        occupied.  The cell is floor((p - origin) / resolution) in float32,
        the configuration's precision."""
        g = self.cfg["grid"]
        org = torch.tensor(g["origin"], dtype=torch.float32)
        res = torch.tensor(g["resolution"], dtype=torch.float32)
        cell = torch.floor((torch.as_tensor(p, dtype=torch.float32) - org)
                           / res).numpy()
        H, W = occ.shape[-2:]
        cx, cy = cell[..., 0], cell[..., 1]
        inb = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
        col = np.where(inb, cx, 0).astype(np.int64)
        row = np.where(inb, cy, 0).astype(np.int64)
        if which is None:
            hit = occ[row, col]
        else:
            hit = occ[np.asarray(which, np.int64), row, col]
        return inb & ~hit


def care(A, B, Q, R) -> np.ndarray:
    """The stabilising solution S of A'S + SA - S B R^-1 B' S + Q = 0,
    float64, from the eigenvectors of the Hamiltonian whose eigenvalues
    have negative real parts."""
    n = A.shape[0]
    G = B @ np.linalg.solve(R, B.T)
    Ham = np.block([[A, -G], [-Q, -A.T]])
    w, V = np.linalg.eig(Ham)
    stable = V[:, w.real < 0]
    if stable.shape[1] != n:
        raise ValueError("the Hamiltonian has no n-dimensional stable "
                         "subspace")
    S = np.real(stable[n:] @ np.linalg.inv(stable[:n]))
    return 0.5 * (S + S.T)
