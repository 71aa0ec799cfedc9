"""Pure-numpy sequential re-implementation of the reference algorithm (the
port's own copy of lqrrt_tpu/oracle/numpy_planner.py; the algorithm is
unchanged, line for line).

This is the oracle of SURVEY.md section 4: a pinned-seed, single-threaded,
iteration-at-a-time lqRRT with the reference's exact control flow
(sample -> LQR-metric nearest -> LQR steer with per-step feasibility ->
insert -> goal test; SURVEY.md section 3.2), written against numpy only.

It serves two purposes:
1. Golden-test oracle: the batched planner must solve the same problems
   with comparable plan quality (tolerance-based comparison — batch commit
   order differs from sequential insert order by design, SURVEY.md section 7).
2. Empirical baseline: the reference publishes no numbers (SURVEY.md section
   6), so this oracle's expansions/s on one CPU core *is* the baseline a
   bench compares against (BASELINE.md: "must be measured empirically").

Deliberately styled after the reference's sequential loop, NOT the batched
design: python per-step steer loop, growing arrays, vectorized-numpy NN scan
(the reference's only data parallelism, SURVEY.md P0a).
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np


class NumpyOracle:
    def __init__(self, dynamics: Callable, lqr: Callable, erf: Callable,
                 is_feasible: Callable, goal_buffer, horizon: float,
                 dt: float = 0.05, error_tol: float = 0.05,
                 saturate: Callable = None, goal_entry_trunc: bool = False):
        """``goal_entry_trunc``: stop each steer rollout at its FIRST in-goal
        step, like the batched planner's fused goal stop (core/steer.py) — the
        reference tests only rollout endpoints, quantizing time-to-goal at
        horizon multiples.  Default False = exact reference semantics; the
        quality harness turns it ON so oracle-vs-planner duration ratios compare
        planners, not dt resolution (VERDICT r3 item 4 / PARITY C6)."""
        self.dynamics = dynamics          # (x, u, dt) -> xnext, numpy
        self.lqr = lqr                    # (x, u) -> (S, K), numpy
        self.erf = erf                    # (xgoal, x) -> e, numpy
        self.is_feasible = is_feasible    # (x, u) -> bool, numpy
        self.goal_buffer = np.asarray(goal_buffer, np.float64)
        self.horizon_steps = max(int(round(horizon / dt)), 1)
        self.dt = dt
        self.error_tol = error_tol
        self.saturate = saturate or (lambda u: u)
        self.goal_entry_trunc = bool(goal_entry_trunc)

    def _steer(self, x0, K, xtar, goal=None):
        """Reference steer loop (SURVEY.md C5): per-dt python loop.  With
        ``goal`` set (goal_entry_trunc), the committed step that first lands
        inside the goal box ends the rollout (first-entry truncation)."""
        x = np.array(x0, np.float64)
        xs, us = [], []
        for _ in range(self.horizon_steps):
            e = self.erf(xtar, x)
            if np.linalg.norm(e) <= self.error_tol:
                break
            u = self.saturate(K @ e)
            xn = self.dynamics(x, u, self.dt)
            if not self.is_feasible(xn, u):
                break
            x = xn
            xs.append(x.copy())
            us.append(np.asarray(u, np.float64))
            if goal is not None and np.all(
                    np.abs(self.erf(goal, xn)) <= self.goal_buffer):
                break
        return np.asarray(xs), np.asarray(us), x

    def plan(self, x0, goal, sample_space, goal_bias=0.0, seed: int = 0,
             max_nodes: int = 100000, min_time: float = 0.0,
             max_time: float = 1.0, sys_time: Callable = time.time):
        """Sequential grow loop; returns (reached, stats, plan)."""
        rng = np.random.default_rng(seed)
        x0 = np.asarray(x0, np.float64)
        goal = np.asarray(goal, np.float64)
        space = np.asarray(sample_space, np.float64)
        gb = np.broadcast_to(np.asarray(goal_bias, np.float64),
                             (x0.shape[0],))

        S0, K0 = self.lqr(x0, None)
        states = [x0]
        Ss, Ks = [np.asarray(S0)], [np.asarray(K0)]
        parent, edges = [-1], [(np.zeros((0, x0.shape[0])),
                                np.zeros((0, 0)))]
        node_time = [0.0]
        goal_node = None

        t0 = sys_time()
        expansions = 0
        while True:
            elapsed = sys_time() - t0
            if elapsed >= max_time or len(states) >= max_nodes:
                break
            if goal_node is not None and elapsed >= min_time:
                break
            # sample with per-dim goal bias (SURVEY.md C3)
            xr = rng.uniform(space[:, 0], space[:, 1])
            mask = rng.uniform(size=x0.shape[0]) < gb
            xr = np.where(mask, goal, xr)
            # nearest under per-node LQR metric, vectorized (SURVEY.md C4)
            st = np.asarray(states)
            e = np.stack([self.erf(xr, s) for s in st])     # (N, n)
            Sarr = np.asarray(Ss)
            cost = np.einsum("ij,ijk,ik->i", e, Sarr, e)
            pid = int(np.argmin(cost))
            # steer (SURVEY.md C5)
            xs, us, xnew = self._steer(
                states[pid], Ks[pid], xr,
                goal if self.goal_entry_trunc else None)
            expansions += 1
            if len(xs) == 0:
                continue
            S, K = self.lqr(xnew, None)
            states.append(xnew)
            Ss.append(np.asarray(S))
            Ks.append(np.asarray(K))
            parent.append(pid)
            edges.append((xs, us))
            node_time.append(node_time[pid] + len(xs) * self.dt)
            # goal test (SURVEY.md C6)
            if np.all(np.abs(self.erf(goal, xnew)) <= self.goal_buffer):
                if goal_node is None or node_time[-1] < node_time[goal_node]:
                    goal_node = len(states) - 1
        elapsed = sys_time() - t0

        # best branch extraction (SURVEY.md C7)
        if goal_node is not None:
            best = goal_node
        else:
            eg = np.stack([self.erf(goal, s) for s in states])
            cg = np.einsum("ij,ijk,ik->i", eg, np.asarray(Ss), eg)
            best = int(np.argmin(cg))
        chain = []
        i = best
        while i != -1:
            chain.append(i)
            i = parent[i]
        chain = chain[::-1]
        xs_all = [states[0][None, :]]
        for i in chain[1:]:
            xs_all.append(edges[i][0])
        plan = np.concatenate(xs_all, 0)

        stats = dict(nodes=len(states), expansions=expansions,
                     elapsed_s=elapsed,
                     expansions_per_s=expansions / max(elapsed, 1e-9),
                     goal_found=goal_node is not None,
                     plan_steps=len(plan),
                     plan_duration_s=node_time[best])
        return goal_node is not None, stats, plan


# ---------------------------------------------------------------- numpy models
# Independent numpy implementations of the demo workloads (deliberately NOT
# imports of the port's models — they double as cross-checks of its dynamics).

def di_dynamics(x, u, dt):
    """2-D double integrator, rk4 (matches models/double_integrator)."""
    def f(x, u):
        return np.concatenate([x[2:], u])
    k1 = f(x, u); k2 = f(x + 0.5 * dt * k1, u)
    k3 = f(x + 0.5 * dt * k2, u); k4 = f(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def boat_dynamics_factory():
    """6-state WAM-V boat, rk4 (mirrors models/boat constants)."""
    M = np.array([350.0, 400.0, 400.0])
    D_LIN = np.array([30.0, 60.0, 60.0])
    D_QUAD = np.array([60.0, 120.0, 120.0])
    WMAX = np.array([600.0, 300.0, 600.0])

    def f(x, u):
        u = np.clip(u, -WMAX, WMAX)
        psi, nu = x[2], x[3:]
        c, s = np.cos(psi), np.sin(psi)
        pdot = np.array([c * nu[0] - s * nu[1], s * nu[0] + c * nu[1], nu[2]])
        cor = np.array([M[1] * nu[1] * nu[2], -M[0] * nu[0] * nu[2],
                        (M[0] - M[1]) * nu[0] * nu[1]])
        drag = D_LIN * nu + D_QUAD * nu * np.abs(nu)
        return np.concatenate([pdot, (u + cor - drag) / M])

    def dynamics(x, u, dt):
        k1 = f(x, u); k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u); k4 = f(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def saturate(u):
        return np.clip(u, -WMAX, WMAX)

    return dynamics, saturate


def boat_erf(xgoal, x):
    e = xgoal - x
    e[2] = np.mod(e[2] + np.pi, 2 * np.pi) - np.pi
    return e


def make_erf_np(angle_dims=()):
    """Numpy erf: subtract + wrap the given angle dims into [-pi, pi)."""
    dims = tuple(angle_dims)

    def erf(xgoal, x):
        e = xgoal - x
        for d in dims:
            e[d] = np.mod(e[d] + np.pi, 2 * np.pi) - np.pi
        return e

    return erf


def car_dynamics_factory():
    """Kinematic bicycle, rk4 (independent mirror of models/car constants —
    doubles as a cross-check of the port's dynamics, like boat_dynamics_factory)."""
    WHEELBASE, DELTA_MAX, A_MAX = 2.5, 0.55, 3.0
    U_MIN = np.array([-A_MAX, -DELTA_MAX])
    U_MAX = np.array([A_MAX, DELTA_MAX])

    def f(x, u):
        a = np.clip(u[0], -A_MAX, A_MAX)
        d = np.clip(u[1], -DELTA_MAX, DELTA_MAX)
        return np.array([x[3] * np.cos(x[2]), x[3] * np.sin(x[2]),
                         x[3] * np.tan(d) / WHEELBASE, a])

    def dynamics(x, u, dt):
        k1 = f(x, u); k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u); k4 = f(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def saturate(u):
        return np.clip(u, U_MIN, U_MAX)

    return dynamics, saturate, f


def quadrotor_dynamics_factory():
    """12-state quadrotor, rk4 (independent mirror of models/quadrotor)."""
    MASS, G = 1.0, 9.81
    INERTIA = np.array([0.01, 0.01, 0.02])
    T_MAX, TAU_MAX = 25.0, 0.5
    HOVER_T = MASS * G
    U_MIN = np.array([-HOVER_T, -TAU_MAX, -TAU_MAX, -TAU_MAX])
    U_MAX = np.array([T_MAX - HOVER_T, TAU_MAX, TAU_MAX, TAU_MAX])

    def f(x, u):
        rpy, v, w = x[3:6], x[6:9], x[9:12]
        T = np.clip(u[0] + HOVER_T, 0.0, T_MAX)
        tau = np.clip(u[1:], -TAU_MAX, TAU_MAX)
        r, p, y = rpy
        cr, sr = np.cos(r), np.sin(r)
        cp_raw, sp = np.cos(p), np.sin(p)
        cy, sy = np.cos(y), np.sin(y)
        R = np.array([
            [cy * cp_raw, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp_raw, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp_raw * sr, cp_raw * cr]])
        cp = max(cp_raw, 0.2)  # gimbal-lock guard (mirrors models/quadrotor)
        tp = sp / cp
        E = np.array([[1.0, sr * tp, cr * tp],
                      [0.0, cr, -sr],
                      [0.0, sr / cp, cr / cp]])
        acc = R @ np.array([0.0, 0.0, T]) / MASS - np.array([0.0, 0.0, G])
        w_dot = (tau - np.cross(w, INERTIA * w)) / INERTIA
        return np.concatenate([v, E @ w, acc, w_dot])

    def dynamics(x, u, dt):
        k1 = f(x, u); k2 = f(x + 0.5 * dt * k1, u)
        k3 = f(x + 0.5 * dt * k2, u); k4 = f(x + dt * k3, u)
        return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def saturate(u):
        return np.clip(u, U_MIN, U_MAX)

    return dynamics, saturate, f


def make_scipy_relinearized_lqr(f, Q, R, u_eq, x_map=None, eps=1e-5):
    """Reference-style re-linearized LQR: finite-difference Jacobians of the
    numpy dynamics + scipy.linalg.solve_continuous_are, K = R^-1 B' S.

    Mirrors the reference demos' pattern (the *user* solves CARE via scipy,
    SURVEY.md section 0) and is fully independent of the port's Riccati path
    — so oracle-vs-planner plan-quality comparisons exercise two disjoint solver
    stacks end to end.
    """
    import scipy.linalg

    Q = np.asarray(Q, np.float64)
    R = np.asarray(R, np.float64)
    u_eq = np.asarray(u_eq, np.float64)
    m = u_eq.shape[0]

    def lqr(x, u):
        del u
        xl = np.array(x, np.float64)
        if x_map is not None:
            xl = x_map(xl)
        n = xl.shape[0]
        A = np.zeros((n, n)); B = np.zeros((n, m))
        for i in range(n):
            dx = np.zeros(n); dx[i] = eps
            A[:, i] = (f(xl + dx, u_eq) - f(xl - dx, u_eq)) / (2 * eps)
        for j in range(m):
            du = np.zeros(m); du[j] = eps
            B[:, j] = (f(xl, u_eq + du) - f(xl, u_eq - du)) / (2 * eps)
        S = scipy.linalg.solve_continuous_are(A, B, Q, R)
        K = np.linalg.solve(R, B.T @ S)
        return S, K

    return lqr


def make_circle_feasibility(centers, radii, margin=0.0):
    centers = np.asarray(centers, np.float64)
    radii = np.asarray(radii, np.float64)

    def is_feasible(x, u):
        d = np.linalg.norm(centers - x[:2], axis=1)
        return bool(np.all(d > radii + margin))

    return is_feasible
