"""Batched closed-loop LQR steering rollouts (port of lqrrt_tpu/core/steer.py,
the time-major ``"tm"`` layout of ``_make_steer_bt`` only).

Each step: e = erf(xtar, x); u = K e (then ``saturate``); xn = dynamics(x,
u, dt); the step commits unless the rollout is done, has arrived
(converged within ``error_tol``) or xn is infeasible; padding steps hold the
last state.  With ``goal_buffer`` the rollout also stops at its FIRST
in-goal step.  The JAX ``lax.scan`` becomes a Python loop over H that writes
into preallocated time-major outputs ``(H, n, B)`` / ``(H, m, B)`` /
``(H, B)``; per-candidate fields are batch-leading.  Callers that want a
batch-leading rollout (prune, finish) transpose the output.

``make_routed_steer`` is the steer the planner's rounds, prune and finish
and the fleet's round run: the same function through kernel D (``ops/kernels/steer_kernel.py``,
one launch a call) on CUDA tensors wherever D's factory accepts the
problem, and through ``make_steer`` everywhere else.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .._const import Const
from ..utils.timing import NO_SPANS


class SteerResult(NamedTuple):
    x_seq: torch.Tensor    # (H, n, B) rollout states, padded with the last
    u_seq: torch.Tensor    # (H, m, B) rollout efforts
    mask: torch.Tensor     # (H, B) bool step validity
    length: torch.Tensor   # (B,) int32 valid steps
    xnew: torch.Tensor     # (B, n) final feasible state
    reached: torch.Tensor  # (B,) bool, converged to the target
    in_goal: torch.Tensor  # (B,) bool, entered the goal box (goal stop only)


def make_steer(dynamics: Callable, erf: Callable, is_feasible: Callable,
               horizon_steps: int, dt: float, error_tol,
               saturate: Callable | None = None,
               goal_buffer=None) -> Callable:
    """Build steer(x0 (B, n), K (B, m, n), xtar (B, n)[, goal]).

    ``error_tol`` is a scalar (2-norm threshold) or a per-dim vector
    (elementwise |e| <= tol).  ``goal``, (n,) or one a row (B, n), is
    required iff ``goal_buffer`` is set."""
    tol_np = np.asarray(error_tol, np.float32)
    per_dim = tol_np.ndim > 0
    tol = Const(tol_np)
    gbuf = None if goal_buffer is None else Const(
        np.asarray(goal_buffer, np.float32))
    H = int(horizon_steps)

    def converged(e):                          # (B, n) -> (B,)
        if per_dim:
            return (e.abs() <= tol.like(e)).all(-1)
        return torch.sqrt((e * e).sum(-1)) <= tol.like(e)

    def steer(x0, K, xtar, goal=None):
        B, n = x0.shape
        m = K.shape[1]
        dev = x0.device
        xs = torch.empty((H, n, B), dtype=x0.dtype, device=dev)
        us = torch.empty((H, m, B), dtype=x0.dtype, device=dev)
        mask = torch.empty((H, B), dtype=torch.bool, device=dev)
        x = x0
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        length = torch.zeros((B,), dtype=torch.int32, device=dev)
        hit_seen = torch.zeros((B,), dtype=torch.bool, device=dev)
        for h in range(H):
            e = erf(xtar, x)
            arrived = converged(e)
            u = (K * e[:, None, :]).sum(-1)    # (B, m) = K e
            if saturate is not None:
                u = saturate(u)
            xn = dynamics(x, u, dt)
            feas = is_feasible(xn, u)
            commit = ~done & ~arrived & feas
            x = torch.where(commit[:, None], xn, x)
            length += commit
            done = done | arrived | ~feas
            if gbuf is not None:
                hit = commit & (erf(goal, xn).abs() <= gbuf.like(xn)).all(-1)
                hit_seen = hit_seen | hit
                done = done | hit
            xs[h] = x.T
            us[h] = u.T
            mask[h] = commit
        reached = converged(erf(xtar, x))
        return SteerResult(xs, us, mask, length, x, reached, hit_seen)

    return steer


def _kernel_steer(dynamics, erf, is_feasible, horizon_steps, dt, error_tol,
                  saturate, goal_buffer):
    """Kernel D's steer of the problem (``make_steer_kernel``, its flat
    variant), or None where D's factory refuses it: a data-bound predicate,
    a raster with a footprint, two rasters, or one past D's cap, a model
    without device functions, another erf or saturation, or a shape its
    checks refuse.  A raster D takes (``OccupancyGrid.feasibility()``) is
    staged in each block's shared memory, one bit a cell (2,400 B for the
    grid boat), and costs a step one shared-memory read."""
    from ..ops.kernels.steer_kernel import make_steer_kernel
    try:
        return make_steer_kernel(dynamics, erf, is_feasible, horizon_steps,
                                 dt, error_tol, saturate=saturate,
                                 goal_buffer=goal_buffer)
    except (NotImplementedError, ValueError):
        return None


def steer_route(dynamics: Callable, erf: Callable, is_feasible: Callable,
                horizon_steps: int, dt: float, error_tol,
                saturate: Callable | None = None, goal_buffer=None,
                device="cpu") -> str:
    """The route ``make_routed_steer``'s steer of this problem takes on
    ``device``: "kernel" (kernel D) on CUDA where D's factory accepts the
    problem, else "scan" (``make_steer``'s loop)."""
    if torch.device(device).type != "cuda":
        return "scan"
    kernel = _kernel_steer(dynamics, erf, is_feasible, horizon_steps, dt,
                           error_tol, saturate, goal_buffer)
    return "scan" if kernel is None else "kernel"


def make_routed_steer(dynamics: Callable, erf: Callable,
                      is_feasible: Callable, horizon_steps: int, dt: float,
                      error_tol, saturate: Callable | None = None,
                      goal_buffer=None, spans=NO_SPANS) -> Callable:
    """Build ``make_steer``'s steer(x0, K, xtar[, goal]) with kernel D under
    it: a call on CUDA tensors launches D where D's factory accepts the
    problem; a call on CPU tensors, or of a problem D refuses, runs
    ``make_steer``'s loop (``steer_route`` says which).  D equals the loop
    bit for bit (``chip_smoke.py``).  The goal, D's as the loop's, is one
    (n,) for every row or one a row, (B, n) (the fleet's round).  Each
    call tallies its route in ``spans``: "steer.kernel" or "steer.scan"."""
    scan = make_steer(dynamics, erf, is_feasible, horizon_steps, dt,
                      error_tol, saturate=saturate, goal_buffer=goal_buffer)
    kernel = _kernel_steer(dynamics, erf, is_feasible, horizon_steps, dt,
                           error_tol, saturate, goal_buffer)

    def steer(x0, K, xtar, goal=None):
        if kernel is not None and xtar.is_cuda:
            spans.tally("steer.kernel")
            # a caller's xrand_gen may hand over a strided view; D reads
            # dense rows
            return kernel(x0, K, xtar.contiguous(), goal)
        spans.tally("steer.scan")
        return scan(x0, K, xtar, goal)

    return steer
