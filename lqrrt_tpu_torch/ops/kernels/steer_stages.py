"""The rollout stage scaffold (port of tools/exp_steer_stages_v5.py
``build`` and tools/dbg_steer_kernel.py ``run_stage``), to find where
kernel D's time goes.

Both tools wrap a step body in the same scaffold: an H-step loop over the
batch-trailing tiles x (n, B), K (m, n, B), tar (n, B) that stores each
step's x_out (and, in ``build``, its u) and adds each step's count to the
length.  ``build``'s twelve configurations enrich the body stage by stage,
from identity to D's step and then pieces of the dynamics; ``run_stage``'s
six stages do the same with 1-D outputs and a body that gives (x_out, inc).

- The plain PyTorch bodies on (n, B) tensors, one function a stage, each in
  the JAX body's expression order (``s_...``); the boat's callbacks are the
  port's (``models/boat.py``), called on the transposed views.
- ``STAGES``: name -> (plain body, stage id of ``lqrrt_steer_stage`` in
  ``csrc/steer_stages.cu``, the tool: "F2" for ``build``, "F3" for
  ``run_stage``), with the flops of one step counted from each body's
  expression (``FLOPS``).  F3's names carry a ``dbg_`` prefix; its
  identity, erf and dynamics stages compute F2's x_out.
- ``build(stage)`` -> steer(x0T, KT, tarT) -> (xs (H, n, B), us (H, m, B),
  length (1, B) int32), and ``run_stage(stage)`` -> steer(x0T, KT, tarT)
  -> (xs, length (B,) int32): the plain loop (``plain``) for CPU tensors,
  the kernel for CUDA tensors; there is no other path.  The stage's name
  is the only setting: the tool's ``store=False`` is the stage
  ``identity_nostore``, which stores only xs[0] and us[0] (the rest is
  undefined, in the kernel as in the tool).
- ``LAUNCHES`` counts the kernel's launches by stage, where they happen.

The kernel runs kernel D's step forms (``csrc/boat_device.cuh``) in D's
launch geometry (``steer_kernel.rollout_geometry``: threads a block from B
and the card's SM count), so that the stages' times split D's.  The
stages that keep x on a failed step (full, dbg_feasibility, dbg_full)
only store once a step has failed, as D does once done: every later step
would repeat it (``csrc/steer_stages.cu``).
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..._const import Const
from ...models import boat
from ..angles import wrap_angle
from ..integrate import rk4_step
from .nn_kernel import _launch, sm_count
from .steer_kernel import boat_params, rollout_geometry

H, NS, NC, DT = 100, 6, 3, 0.05     # the tools' horizon, n, m and dt
_DLIN = Const(boat.D_LIN[:, None])
_MINV = Const(boat._Minv[:, None])


@functools.lru_cache(maxsize=None)
def _problem():
    """The boat problem's numbers the bodies and the kernel read."""
    prob = boat.default_problem()
    centers, r2 = prob["constraints"].is_feasible.circles
    return dict(
        prob=prob,
        params=Const(boat_params()),
        circles=Const(np.concatenate(
            [np.asarray(centers, np.float32).reshape(-1, 2),
             np.asarray(r2, np.float32).reshape(-1, 1)], 1)),
        ncirc=len(r2),
        goal=Const(np.asarray(prob["goal"], np.float32)),
        gbuf=Const(prob["constraints"].goal_buffer))


# --- the plain bodies, (n, B) / (m, n, B) / (n, B) -> (x_out, u) (F2) or
# --- x_out / (x_out, inc) (F3)
def _erf(tar, x):
    e = tar - x
    e[2] = wrap_angle(e[2])
    return e


def _matvec(K, e):
    u = K[:, 0, :] * e[0][None, :]
    for j in range(1, NS):
        u = u + K[:, j, :] * e[j][None, :]
    return u


def _dyn(x, u):
    return boat.dynamics(x.T, u.T, DT).T


def _feas(xn, u):
    return _problem()["prob"]["constraints"].is_feasible(xn.T, u.T)


def s_identity(x, K, tar):
    return x * 1.000001, x[:NC] * 0.5


def s_erf(x, K, tar):
    e = _erf(tar, x)
    return x + 0.001 * e, e[:NC]


def s_matvec(x, K, tar):
    e = _erf(tar, x)
    return x + 0.001 * e, _matvec(K, e)


def s_sat(x, K, tar):
    e = _erf(tar, x)
    return x + 0.001 * e, boat.saturate(_matvec(K, e).T).T


def s_dyn(x, K, tar):
    e = _erf(tar, x)
    u = boat.saturate(_matvec(K, e).T).T
    return _dyn(x, u), u


def s_full(x, K, tar):
    e = _erf(tar, x)
    arrived = (e * e).sum(0, keepdim=True) <= 0.0025
    u = boat.saturate(_matvec(K, e).T).T
    xn = _dyn(x, u)
    ok = _feas(xn, u)[None, :] & ~arrived
    return torch.where(ok, xn, x), u


def s_sin(x, K, tar):
    return x + 0.001 * torch.sin(x), x[:NC] * 0.5


def s_sincos8(x, K, tar):
    acc = x
    for _ in range(4):
        acc = acc + 0.001 * torch.sin(acc[2:3]) + 0.001 * torch.cos(acc[2:3])
    return acc, x[:NC] * 0.5


def _f_lin(xb, ub):
    """The tool's rows without trig: pdot = nu, nudot = Minv (u - D_LIN
    nu)."""
    nu = xb[3:]
    return torch.cat([nu, _MINV.like(xb) * (ub - _DLIN.like(xb) * nu)])


def s_rk4_lin(x, K, tar):
    u = x[:NC] * 0.1
    k1 = _f_lin(x, u)
    k2 = _f_lin(x + 0.025 * k1, u)
    k3 = _f_lin(x + 0.025 * k2, u)
    k4 = _f_lin(x + 0.05 * k3, u)
    return x + (0.05 / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4), u


def s_euler_full(x, K, tar):
    u = x[:NC] * 0.1
    return x + 0.05 * boat.f(x.T, u.T).T, u


def s_rk4_trig(x, K, tar):
    """The tool's ``s_rk4_trig_nostack``: its row form of the dynamics is
    ``boat.f``'s expression, term for term."""
    u = x[:NC] * 0.1
    return rk4_step(boat.f, x.T, u.T, DT).T, u


def d_matvec(x, K, tar):
    u = _matvec(K, _erf(tar, x))
    return x + 0.001 * u.sum(0)[None]


def d_feasibility(x, K, tar):
    u = _matvec(K, _erf(tar, x))
    xn = _dyn(x, boat.saturate(u.T).T)
    feas = _feas(xn, u)
    return torch.where(feas[None, :], xn, x), feas.int()


def d_full(x, K, tar):
    e = _erf(tar, x)
    arrived = (e * e).sum(0) <= 0.0025
    u = _matvec(K, e)
    xn = _dyn(x, boat.saturate(u.T).T)
    feas = _feas(xn, u)
    p = _problem()
    hit = (_erf(p["goal"].like(xn)[:, None], xn).abs()
           <= p["gbuf"].like(xn)[:, None]).all(0)
    ok = feas & ~arrived & ~hit
    return torch.where(ok[None, :], xn, x), ok.int()


class Stage(NamedTuple):
    body: Callable
    sid: int          # the stage id of lqrrt_steer_stage
    tool: str         # "F2" (build) or "F3" (run_stage)


STAGES = {
    "identity": Stage(s_identity, 0, "F2"),
    "identity_nostore": Stage(s_identity, 1, "F2"),
    "erf": Stage(s_erf, 2, "F2"),
    "matvec": Stage(s_matvec, 3, "F2"),
    "saturate": Stage(s_sat, 4, "F2"),
    "dynamics": Stage(s_dyn, 5, "F2"),
    "full": Stage(s_full, 6, "F2"),
    "sin_whole": Stage(s_sin, 7, "F2"),
    "sincos8_row": Stage(s_sincos8, 8, "F2"),
    "rk4_lin_rows": Stage(s_rk4_lin, 9, "F2"),
    "euler_full": Stage(s_euler_full, 10, "F2"),
    "rk4_trig_rows": Stage(s_rk4_trig, 11, "F2"),
    "dbg_identity": Stage(lambda x, K, tar: s_identity(x, K, tar)[0], 12,
                          "F3"),
    "dbg_erf": Stage(lambda x, K, tar: s_erf(x, K, tar)[0], 13, "F3"),
    "dbg_matvec": Stage(d_matvec, 14, "F3"),
    "dbg_dynamics": Stage(lambda x, K, tar: s_dyn(x, K, tar)[0], 15, "F3"),
    "dbg_feasibility": Stage(d_feasibility, 16, "F3"),
    "dbg_full": Stage(d_full, 17, "F3"),
}
F2 = tuple(k for k, s in STAGES.items() if s.tool == "F2")
F3 = tuple(k for k, s in STAGES.items() if s.tool == "F3")
LAUNCHES = dict.fromkeys(STAGES, 0)
# the step bodies of csrc/steer_stages.cu in its enum's order: the first
# template argument of each stage_kernel instance
BODIES = ("identity", "erf", "matvec", "saturate", "dynamics", "full",
          "sin_whole", "sincos8_row", "rk4_lin_rows", "euler_full",
          "rk4_trig_rows", "dbg_matvec", "dbg_feasibility", "dbg_full")

# fp32 operations of one step, from each body's expression: erf 9 (6 sub,
# the wrap's add, fmod, sub); x + 0.001 e 12; the matvec 33 (18 mul, 15
# add); the saturation 6 (a clamp is 2); boat.f 39 (sin, cos, 6 for pdot, 7
# for the Coriolis terms, 15 for drag, 9 for nudot), so the RK4 234 (4 f,
# 36 for the stage states, 42 for the sum); the arrived test 12 (6 mul, 5
# add, compare); the circles 6 each (7 for the boat); the goal box 21
_RK4, _CIRC = 234, 6 * 7
FLOPS = {
    "identity": 9, "identity_nostore": 9,             # 6 + 3 mul
    "erf": 9 + 12,
    "matvec": 9 + 33 + 12,
    "saturate": 9 + 33 + 6 + 12,
    "dynamics": 9 + 33 + 6 + _RK4,
    "full": 9 + 12 + 33 + 6 + _RK4 + _CIRC,
    "sin_whole": 6 * 3 + 3,                           # sin, mul, add; u
    "sincos8_row": 4 * (2 + 2 + 12) + 3,              # sin, cos, 2 mul, 12 add
    "rk4_lin_rows": 3 + 4 * 9 + 36 + 42,              # _f_lin 9 (3 x mul,
                                                      # sub, mul)
    "euler_full": 3 + 39 + 12,
    "rk4_trig_rows": 3 + _RK4,
    "dbg_identity": 6,
    "dbg_erf": 9 + 12,
    "dbg_matvec": 9 + 33 + 2 + 12,
    "dbg_dynamics": 9 + 33 + 6 + _RK4,
    "dbg_feasibility": 9 + 33 + 6 + _RK4 + _CIRC,
    "dbg_full": 9 + 12 + 33 + 6 + _RK4 + _CIRC + 21,
}


def plain(stage: str, x0T, KT, tarT):
    """The tool's scaffold around the stage's plain body, on any device:
    (xs (H, n, B), us (H, m, B) or None for F3, length: (1, B) for F2,
    (B,) for F3, int32).  ``identity_nostore`` never stores a step."""
    st = STAGES[stage]
    f2 = st.tool == "F2"
    store = stage != "identity_nostore"
    B = x0T.shape[1]
    xs = torch.empty((H, NS, B), dtype=x0T.dtype, device=x0T.device)
    us = (torch.empty((H, NC, B), dtype=x0T.dtype, device=x0T.device)
          if f2 else None)
    length = torch.zeros((1, B) if f2 else (B,), dtype=torch.int32,
                         device=x0T.device)
    x = x0T
    for h in range(H):
        out = st.body(x, KT, tarT)
        if f2:
            x_out, u = out
            inc = 1
        else:
            x_out, inc = out if isinstance(out, tuple) else (out, 1)
        if store:
            xs[h] = x_out
            if f2:
                us[h] = u
        x = x_out
        length += inc
    if not store:
        xs[0] = x
        us[0] = x[:NC] * 0.0
    return xs, us, length


def _check(name, x0T, KT, tarT):
    for what, t, shape in (("x0T", x0T, (NS, -1)), ("KT", KT, (NC, NS, -1)),
                           ("tarT", tarT, (NS, -1))):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {what} must be float32")
        if t.device != x0T.device:
            raise ValueError(f"{name}: all inputs must share a device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
        if (t.dim() != len(shape) or tuple(t.shape[:-1]) != shape[:-1]
                or t.shape[-1] != x0T.shape[-1]):
            raise ValueError(f"{name}: x0T ({NS}, B), KT ({NC}, {NS}, B) and "
                             f"tarT ({NS}, B), got {tuple(x0T.shape)}, "
                             f"{tuple(KT.shape)} and {tuple(tarT.shape)}")
    if x0T.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x0T.device}")


def _launch_stage(stage, x0T, KT, tarT):
    st = STAGES[stage]
    f2 = st.tool == "F2"
    B, dev = x0T.shape[1], x0T.device
    xs = torch.empty((H, NS, B), dtype=torch.float32, device=dev)
    us = (torch.empty((H, NC, B), dtype=torch.float32, device=dev)
          if f2 else None)
    length = torch.empty((1, B) if f2 else (B,), dtype=torch.int32,
                         device=dev)
    if B:
        p = _problem()
        _launch("lqrrt_steer_stage", x0T, KT, tarT, st.sid,
                p["params"].like(x0T), p["circles"].like(x0T), p["ncirc"],
                p["goal"].like(x0T), p["gbuf"].like(x0T), xs, us, length, B,
                H, 0.5 * DT, DT, DT / 6.0,
                *rollout_geometry(B, sm_count(dev)))
        LAUNCHES[stage] += 1
    return xs, us, length


def build(stage: str):
    """steer(x0T (n, B), KT (m, n, B), tarT (n, B)) -> (xs, us, length
    (1, B)) for one of the tool's twelve configurations (``F2``)."""
    if STAGES.get(stage, Stage(None, -1, "")).tool != "F2":
        raise ValueError(f"build: unknown stage {stage!r}; one of {F2}")

    def steer(x0T, KT, tarT):
        _check(f"build[{stage}]", x0T, KT, tarT)
        if x0T.device.type == "cpu":
            return plain(stage, x0T, KT, tarT)
        return _launch_stage(stage, x0T, KT, tarT)

    return steer


def run_stage(stage: str):
    """steer(x0T, KT, tarT) -> (xs (H, n, B), length (B,)) for one of
    ``run_stage``'s six stages (``F3``)."""
    if STAGES.get(stage, Stage(None, -1, "")).tool != "F3":
        raise ValueError(f"run_stage: unknown stage {stage!r}; one of {F3}")

    def steer(x0T, KT, tarT):
        _check(f"run_stage[{stage}]", x0T, KT, tarT)
        if x0T.device.type == "cpu":
            xs, _, length = plain(stage, x0T, KT, tarT)
        else:
            xs, _, length = _launch_stage(stage, x0T, KT, tarT)
        return xs, length

    return steer
