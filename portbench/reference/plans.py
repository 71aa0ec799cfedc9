"""The numbers that decide ``correct``: committed plans judged against the
plain model reference (``portbench/reference/<model>.py``).

A plan is a dict: ``x`` (P, n) float32 states from the start, ``u``
(P - 1, m) float32 controls or None (the fleet's plans carry states only),
``x0`` and ``goal`` (n,), ``claims_goal`` (the program said it reached the
goal box), and ``scenario``, the index into per-scenario grids or None.

- ``bad_plans``: plans that fail an exact check, in float32, the
  configuration's precision: the first state is x0; every number is
  finite; there is one control less than states; every control lies in the
  wrench box; every state after the first lies outside the obstacles.
- ``goal_excess``: over the plans that claim the goal, the most by which
  the last state lies outside the goal box in any dim (0 inside).
- ``gap_max``, ``gap_med``: the step gap of each step k is the norm of the
  wrapped change d of x_k for which the reference's RK4 step from x_k + d
  under u_k lands on x_{k+1} (Newton in float64).  Where a plan carries no
  controls, u_k is fitted first: the least-squares control of that step.
- ``gain_med`` (plans with controls): on each pair of steps whose control
  component is inside the box at both, |u_{k+1} - u_k + K (x_{k+1} - x_k)|
  over the box's half-width, with the reference's own gain K: a steer under
  u = K e toward a fixed target gives 0 inside an edge.  The median.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import torch

_F64 = torch.float64
_HERE = Path(__file__).resolve().parent


def load_model(cfg: dict):
    """The reference model named by the configuration's ``model`` key,
    from ``portbench/reference/<model>.py`` (its class is the model's
    name, capitalised)."""
    name = cfg["model"]
    spec = importlib.util.spec_from_file_location(
        f"portbench_reference_{name}", _HERE / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name.capitalize())(cfg)


# ------------------------------------------------------------ exact checks

def plan_faults(model, plan: dict, occ=None) -> list:
    """The exact checks a plan fails, by name (empty when it passes)."""
    x, u = plan.get("x"), plan.get("u")
    if x is None or len(x) == 0:
        return ["missing"]
    x = np.asarray(x, np.float32)
    bad = []
    if not np.array_equal(x[0], np.asarray(plan["x0"], np.float32)):
        bad.append("start")
    if not np.isfinite(x).all():
        bad.append("finite")
    if u is not None:
        u = np.asarray(u, np.float32)
        if u.shape != (len(x) - 1, model.m):
            bad.append("controls")
        elif not np.isfinite(u).all():
            bad.append("finite")
        elif (np.abs(u) > np.asarray(model.wmax, np.float32)).any():
            bad.append("wrench")
    p = x[1:, :2]
    if len(p):
        if occ is None:
            free = model.circles_free(p)
        else:
            which = (None if plan.get("scenario") is None
                     else np.full(len(p), plan["scenario"]))
            free = model.grid_free(p, occ, which)
        if not free.all():
            bad.append("obstacle")
    return bad


def goal_excess(model, plan: dict) -> float:
    x = np.asarray(plan["x"], np.float64)
    e = model.error(torch.tensor(plan["goal"], dtype=_F64),
                    torch.as_tensor(x[-1])).abs().numpy()
    return float(max(0.0, (e - np.asarray(model.cfg["goal_buffer"])).max()))


# ---------------------------------------------------------------- dynamics

def _jacobian(fn, z: torch.Tensor, h: float = 1e-6) -> torch.Tensor:
    """(T, k_out, k_in) central differences of fn over the rows of z."""
    k = z.shape[-1]
    eye = torch.eye(k, dtype=z.dtype) * h
    zp = (z[:, None, :] + eye).reshape(-1, k)
    zm = (z[:, None, :] - eye).reshape(-1, k)
    d = (fn(zp) - fn(zm)).reshape(z.shape[0], k, -1) / (2 * h)
    return d.transpose(1, 2)


def fit_controls(model, x: torch.Tensor, xn: torch.Tensor,
                 iters: int = 3) -> torch.Tensor:
    """The least-squares control of each step x -> xn (float64,
    Gauss-Newton on the unsaturated step)."""
    u = torch.zeros(x.shape[0], model.m, dtype=_F64)
    xr = x.repeat_interleave(model.m, 0)
    for _ in range(iters):
        r = model.error(xn, model.step(x, u, saturate=False))
        J = _jacobian(lambda v: model.step(xr, v, saturate=False), u)
        u = u + torch.linalg.lstsq(J, r[..., None]).solution[..., 0]
    return u


def step_gaps(model, x: torch.Tensor, u: torch.Tensor, xn: torch.Tensor,
              saturate: bool = True, iters: int = 3) -> torch.Tensor:
    """(T,) the norm of the change d of x with step(x + d, u) == xn."""
    d = torch.zeros_like(x)
    n = x.shape[1]
    ur = u.repeat_interleave(n, 0)
    for _ in range(iters):
        r = model.error(xn, model.step(x + d, u, saturate))
        J = _jacobian(lambda z: model.step(z, ur, saturate), x + d)
        d = d + torch.linalg.solve(J, r[..., None])[..., 0]
    return d.norm(dim=-1)


def _steps(plans):
    """Every step of the plans as rows: x_k, x_{k+1}, u_k (or None)."""
    xs, xns, us = [], [], []
    for p in plans:
        x = np.asarray(p["x"], np.float64)
        xs.append(x[:-1])
        xns.append(x[1:])
        if p.get("u") is not None:
            us.append(np.asarray(p["u"], np.float64))
    x = torch.as_tensor(np.concatenate(xs))
    xn = torch.as_tensor(np.concatenate(xns)).reshape(x.shape)
    u = torch.as_tensor(np.concatenate(us)) if us else None
    return x, xn, u


def gain_residuals(model, K: np.ndarray, plans) -> np.ndarray:
    """Per (step pair, control component) residuals of u = K e inside
    the box, over the box's half-width (see the module docstring)."""
    Kt = torch.as_tensor(K, dtype=_F64)
    wmax = np.asarray(model.wmax, np.float64)
    out = []
    for p in plans:
        x = torch.as_tensor(np.asarray(p["x"], np.float64))
        u = np.asarray(p["u"], np.float64)
        if len(u) < 2:
            continue
        dx = model.error(x[1:-1], x[:-2])               # x_{k+1} - x_k
        du = u[1:] - u[:-1]
        r = np.abs(du + (dx @ Kt.T).numpy()) / wmax
        inside = (np.abs(u[1:]) < wmax) & (np.abs(u[:-1]) < wmax)
        out.append(r[inside])
    return np.concatenate(out) if out else np.zeros(0)


# ------------------------------------------------------------------ numbers

def judge(model, plans, occ=None, K=None, dyn_idx=None) -> tuple:
    """(numbers, faults): the compared numbers over ``plans`` and the
    exact faults found, as (plan index, names).  The dynamics numbers read
    the plans ``dyn_idx`` (all by default; a sample drawn by the caller)
    that pass the exact checks; ``K`` adds ``gain_med`` for plans with
    controls."""
    faults = [(i, f) for i, p in enumerate(plans)
              if (f := plan_faults(model, p, occ))]
    bad = {i for i, _ in faults}
    numbers = {"bad_plans": len(bad)}
    claims = [p for i, p in enumerate(plans)
              if i not in bad and p.get("claims_goal")]
    numbers["goal_excess"] = max((goal_excess(model, p) for p in claims),
                                 default=0.0)
    idx = range(len(plans)) if dyn_idx is None else dyn_idx
    dyn = [plans[i] for i in idx if i not in bad and len(plans[i]["x"]) > 1]
    if dyn:
        x, xn, u = _steps(dyn)
        with_u = u is not None
        if not with_u:
            u = fit_controls(model, x, xn)
        g = step_gaps(model, x, u, xn, saturate=with_u).numpy()
        numbers["gap_max"] = float(g.max())
        numbers["gap_med"] = float(np.median(g))
        if K is not None and with_u:
            r = gain_residuals(model, K, dyn)
            if len(r):
                numbers["gain_med"] = float(np.median(r))
    return numbers, faults


def control_plans(model, plans, dtype=torch.bfloat16):
    """The plans as the reference computed in ``dtype`` would give them:
    each state after the first is the ``dtype`` RK4 step from the
    program's previous state under its control (fitted where the plan
    carries none), and each control is rounded to ``dtype``."""
    out = []
    for p in plans:
        x = np.asarray(p["x"], np.float64)
        if len(x) < 2:
            out.append(dict(p))
            continue
        xt = torch.as_tensor(x)
        if p.get("u") is not None:
            u = torch.as_tensor(np.asarray(p["u"], np.float64))
            sat = True
        else:
            u = fit_controls(model, xt[:-1], xt[1:])
            sat = False
        xl = model.step(xt[:-1].to(dtype), u.to(dtype), saturate=sat)
        xc = np.concatenate([x[:1], xl.to(_F64).numpy()]).astype(np.float32)
        q = dict(p, x=xc)
        if p.get("u") is not None:
            q["u"] = u.to(dtype).to(_F64).numpy().astype(np.float32)
        out.append(q)
    return out
