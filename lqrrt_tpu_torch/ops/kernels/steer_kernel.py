"""The fused closed-loop steer rollout, kernel D (port of
tools/steer_kernel_experimental.py: ``make_steer_pallas`` and
``make_steer_pallas_tree``), and the factory of its double-vmap variant F1
(tools/exp_steer_dv_v5.py: ``make_steer_pallas_dv``).

Both factories build a steer that computes ``core.steer.make_steer``'s
function and returns its ``SteerResult``, time-major: x_seq (H, n, B),
u_seq (H, m, B), mask (H, B), and per candidate length, xnew, reached and
in_goal.  Commits are a prefix, so mask is ``arange(H)[:, None] <
length``.

- ``make_steer_kernel(...)`` -> ``steer(x0 (B, n), K (B, m, n), xtar (B, n)
  [, goal])``, the goal one (n,) for every candidate or one a candidate,
  (B, n) (the fleet's rows, each toward its scenario's goal): the kernel
  reads it with a stride of 0 or n, chosen from its shape;
- ``make_steer_kernel_tree(...)`` -> ``steer(states (N, n), K (N, m, n),
  pids (B,) int32, xtar (B, n)[, goal])``, which starts candidate b from
  tree row pids[b]: x0 = states[pids], K0 = K[pids]
  (``steer.takes_tree = True``); a pid outside [0, N) gives a NaN start
  row and gain (``gather_rows``);
- ``make_steer_kernel_dv(...)`` -> ``make_steer_kernel``'s steer, counted
  as "dv".  The Pallas kernel's double vmap writes (H, n, 1, B) and
  squeezes it; on the card that is the same memory as (H, n, B), so F1's
  counterpart is kernel D under F1's factory.

The kernel chooses its own launch geometry from B and the card's SM count
(``rollout_geometry``: threads a block, blocks); the factories' ``block``
and ``batch_tile``, the Pallas kernels' tile, are checked as before and
change nothing on the card.

A CUDA kernel cannot trace Python callbacks, so the kernel
(``csrc/steer_rollout.cu``) carries each model's callbacks written out as
device functions, and ``_MODELS`` maps a ``dynamics`` object to them and to
its numbers: the boat, the car, the quadrotor and the double integrator.
The factories check the erf (the model's wrapped dims, ``angle_dims``;
``torch.subtract`` wraps none), the saturation (the model's own) and the
predicate (its tags: ``collision.circles_free``'s ``circles``,
``control_limits``' box, ``OccupancyGrid.feasibility``'s ``grid`` without a
footprint, ``all_of``'s parts made of those, or the all-true default) and
raise ``NotImplementedError`` on anything else, whatever the device:
nothing drops back to the Python loop on the card.  The planner's router
(``core.steer.make_routed_steer``) catches that error, and a shape the
checks refuse, and runs the plain steer instead.

A raster is packed once, when the steer is built (``pack_grid``: one bit a
cell, 2,400 B for the grid boat's 96 x 200 cells), and the kernel's
instance with a raster stages it in each block's shared memory: a step's
test is then one shared-memory read.  At most ``MAX_GRID_WORDS`` words.

Each steer takes the plain version (``core.steer.make_steer``; for the tree
variant after ``gather_rows``) for CPU tensors and launches the kernel for
CUDA tensors; there is no other path.  The kernel's saturation keeps NaN as
``torch.clamp`` does, so the two give the same NaN rows.  ``LAUNCHES``
counts the kernel's launches by variant ("flat", "tree", "dv"), where they
happen.
"""
from __future__ import annotations

import numpy as np
import torch

from ..._const import Const
from ...core.steer import SteerResult, make_steer
from ...models import boat, car, double_integrator, quadrotor
from .nn_kernel import _launch, sm_count

VARIANTS = ("flat", "tree", "dv")
LAUNCHES = dict.fromkeys(VARIANTS, 0)
MAX_CIRCLES = 64          # kMaxCircles in csrc/steer_rollout.cu
MAX_THREADS = 128         # kMaxThreads there
MAX_GRID_WORDS = 11776    # kMaxGridWords there: 46 KiB of shared memory,
                          # 376,832 cells


def rollout_geometry(B: int, sms: int):
    """(threads, blocks) of one rollout launch over B candidates on a card
    of ``sms`` SMs: thread t of the grid takes candidate t.  Threads:
    MAX_THREADS, or fewer (a multiple of 32) where MAX_THREADS would leave
    an SM without a block: the time is one warp's chain of H steps
    (csrc/steer_rollout.cu), so the warps should spread over every SM."""
    threads = max(32, min(MAX_THREADS, B // max(sms, 1) // 32 * 32))
    return threads, -(-B // threads)


def sqrt_threshold(tol) -> np.float32:
    """The largest float32 s whose rounded square root is <= tol: for
    s >= 0 (or NaN), sqrt(s) <= tol exactly when s <= this, since the
    rounded sqrt is monotone.  The kernel's scalar converged test compares
    the sum of squares with it, without the sqrt."""
    t = np.float32(tol)
    if not t >= 0:                     # negative or NaN: never converged
        return np.float32(-np.inf)
    up, down = np.float32(np.inf), np.float32(-np.inf)
    s = np.float32(t) * np.float32(t)
    with np.errstate(over="ignore"):
        while np.sqrt(np.nextafter(s, up)) <= t and s < up:
            s = np.nextafter(s, up)
        while np.sqrt(s) > t:
            s = np.nextafter(s, down)
    return s


def boat_params() -> np.ndarray:
    """The boat's numbers in the kernel's order (the enum in
    ``csrc/steer_rollout.cu``): M_MASS, M_SWAY, 1 / (M_MASS, M_SWAY,
    I_YAW) as float32 (as ``boat.f`` uses them), D_LIN, D_QUAD,
    WRENCH_MAX."""
    minv = np.array([1.0 / boat.M_MASS, 1.0 / boat.M_SWAY, 1.0 / boat.I_YAW],
                    np.float32)
    return np.concatenate([[boat.M_MASS, boat.M_SWAY], minv, boat.D_LIN,
                           boat.D_QUAD, boat.WRENCH_MAX]).astype(np.float32)


def car_params() -> np.ndarray:
    """The car's numbers in the kernel's order (``csrc/car_device.cuh``):
    A_MAX, DELTA_MAX, 1 / WHEELBASE as float32 (PyTorch's CUDA division
    by a Python float multiplies by it), U_MIN, U_MAX."""
    inv = np.float32(1.0) / np.float32(car.WHEELBASE)
    return np.concatenate([[car.A_MAX, car.DELTA_MAX, inv], car.U_MIN,
                           car.U_MAX_VEC]).astype(np.float32)


def quadrotor_params() -> np.ndarray:
    """The quadrotor's numbers in the kernel's order
    (``csrc/quadrotor_device.cuh``): HOVER_T, T_MAX, TAU_MAX, G, the
    pitch cosine's floor 0.2, INERTIA, U_MIN, U_MAX.  The device f takes
    ``T / MASS`` as T itself: MASS is 1."""
    return np.concatenate([[quadrotor.HOVER_T, quadrotor.T_MAX,
                            quadrotor.TAU_MAX, quadrotor.G, 0.2],
                           quadrotor.INERTIA, quadrotor.U_MIN,
                           quadrotor.U_MAX_VEC]).astype(np.float32)


def double_integrator_params() -> np.ndarray:
    """The double integrator's numbers (``csrc/double_integrator_device.cuh``):
    U_MAX."""
    return np.array([double_integrator.U_MAX], np.float32)


# dynamics -> the kernel's model id, its numbers, (n, m), the erf's
# wrapped dims and the saturation the kernel's device functions compute
_MODELS = {
    boat.dynamics: dict(id=0, params=boat_params, nm=(6, 3),
                        angle_dims=(2,), saturate=boat.saturate),
    car.dynamics: dict(id=1, params=car_params, nm=(4, 2), angle_dims=(2,),
                       saturate=car.saturate),
    quadrotor.dynamics: dict(id=2, params=quadrotor_params, nm=(12, 4),
                             angle_dims=(5,), saturate=quadrotor.saturate),
    double_integrator.dynamics: dict(id=3, params=double_integrator_params,
                                     nm=(4, 2), angle_dims=(),
                                     saturate=double_integrator.saturate),
}


def predicate_parts(is_feasible):
    """(circles (K, 3) float32: cx, cy, (r + margin)^2; control_limits'
    (lo, hi) or None; the raster (occ (H, W) bool, origin (2,) float32,
    resolution) or None) of a predicate the kernel computes: a
    ``circles_free`` on dims (0, 1) (``circles``, ``pos_dims`` tags), a
    ``control_limits`` (its tag), an ``OccupancyGrid.feasibility()`` on
    dims (0, 1) without a footprint (``grid``, ``pos_dims``), the all-true
    default (none of them), or an ``all_of`` (``parts``) of those, whose
    circles are concatenated, whose boxes intersect and which holds at
    most one raster.  Raises ``NotImplementedError`` otherwise."""
    circles, limits, grids = [], [], []

    def walk(pred):
        if hasattr(pred, "parts"):
            for q in pred.parts:
                walk(q)
        elif hasattr(pred, "circles") or hasattr(pred, "grid"):
            if tuple(getattr(pred, "pos_dims", (0, 1))) != (0, 1):
                raise NotImplementedError(
                    "steer kernel: the circles and the raster must test "
                    "dims (0, 1)")
            if hasattr(pred, "grid"):
                grids.append(pred.grid)
            else:
                centers, r2 = pred.circles
                circles.append(np.concatenate(
                    [np.asarray(centers, np.float32).reshape(-1, 2),
                     np.asarray(r2, np.float32).reshape(-1, 1)], 1))
        elif hasattr(pred, "control_limits"):
            limits.append(pred.control_limits)
        else:
            raise NotImplementedError(
                "steer kernel: the predicate has no circles tag, "
                "control_limits tag, grid tag or parts tag; only "
                "collision.circles_free, collision.control_limits, "
                "OccupancyGrid.feasibility() without a footprint, "
                "collision.all_of of those and the all-true default have a "
                "device form")

    walk(is_feasible)
    if len(grids) > 1:
        raise NotImplementedError(
            f"steer kernel: at most one raster, got {len(grids)}")
    circ = (np.concatenate(circles) if circles
            else np.zeros((0, 3), np.float32))
    box = None
    if limits:
        box = (np.max([np.asarray(lo, np.float32) for lo, _ in limits], 0),
               np.min([np.asarray(hi, np.float32) for _, hi in limits], 0))
    return circ, box, (grids[0] if grids else None)


def pack_grid(occ) -> np.ndarray:
    """The raster occ (H, W) as the kernel reads it: row-major, one bit a
    cell, cell i = y W + x in bit i & 31 of uint32 word i >> 5 (set where
    occupied), the last word padded with free cells; returned as int32
    words of the same bits."""
    bits = np.asarray(occ, bool).reshape(-1)
    bits = np.concatenate([bits, np.zeros(-len(bits) % 32, bool)])
    return np.packbits(bits, bitorder="little").view("<i4").astype(np.int32)


class _Spec:
    """What the kernel needs of one problem, checked once at build time,
    and the plain version; the device copies are made on first use
    (``Const``)."""

    def __init__(self, dynamics, erf, is_feasible, horizon_steps, dt,
                 error_tol, saturate, goal_buffer, block):
        model = _MODELS.get(dynamics)
        if model is None:
            raise NotImplementedError(
                "steer kernel: this dynamics has no device functions; only "
                "the boat's, the car's, the quadrotor's and the double "
                "integrator's (models/) do")
        dims = () if erf is torch.subtract else getattr(erf, "angle_dims",
                                                        None)
        if dims is None or tuple(dims) != model["angle_dims"]:
            raise NotImplementedError(
                f"steer kernel: the erf must wrap dims {model['angle_dims']}"
                " (make_erf's angle_dims tag, or torch.subtract for none); "
                "other erfs have no device form")
        if saturate is not model["saturate"]:
            raise NotImplementedError(
                "steer kernel: saturate must be the model's own "
                "(e.g. boat.saturate); other saturations have no device form")
        circles, box, grid = predicate_parts(is_feasible)
        if len(circles) > MAX_CIRCLES:
            raise NotImplementedError(
                f"steer kernel: at most {MAX_CIRCLES} circles, got "
                f"{len(circles)}")
        words = None if grid is None else pack_grid(grid[0])
        if words is not None and not 0 < len(words) <= MAX_GRID_WORDS:
            raise NotImplementedError(
                f"steer kernel: a raster of 1 to {32 * MAX_GRID_WORDS} "
                f"cells, got {np.size(grid[0])}")
        self.model = model["id"]
        self.n, self.m = model["nm"]
        tol = np.asarray(error_tol, np.float32)
        self.per_dim = tol.ndim > 0
        if self.per_dim and tol.shape != (self.n,):
            raise ValueError(f"steer kernel: error_tol must be a scalar or "
                             f"({self.n},), got {tol.shape}")
        self.has_goal = goal_buffer is not None
        if self.has_goal and np.shape(goal_buffer) != (self.n,):
            raise ValueError(f"steer kernel: goal_buffer must be "
                             f"({self.n},), got {np.shape(goal_buffer)}")
        if not (32 <= block <= 1024 and block % 32 == 0):
            raise ValueError(f"steer kernel: block must be a multiple of 32 "
                             f"in [32, 1024], got {block}")
        if box is not None and (box[0].shape != (self.m,)
                                or box[1].shape != (self.m,)):
            raise ValueError(f"steer kernel: control_limits must be "
                             f"({self.m},), got {box[0].shape}")
        self.ncirc = len(circles)
        self.H = int(horizon_steps)
        # rk4_step's step sizes, each rounded once to float32 as the plain
        # version's Python floats are
        self.steps = (0.5 * dt, float(dt), dt / 6.0)
        self.params = Const(model["params"]())
        # per dim: tol itself; scalar: its sqrt threshold (the kernel tests
        # the sum of squares)
        self.tol = Const(tol if self.per_dim
                         else np.array([sqrt_threshold(tol)], np.float32))
        self.gbuf = Const(np.asarray(goal_buffer if self.has_goal
                                     else np.zeros(self.n), np.float32))
        self.circles = Const(circles)
        self.limits = None if box is None else Const(np.stack(box))
        # the raster: its words, (W, H) and the cell transform as PyTorch's
        # CUDA division by a Python float computes it, (p - origin) times
        # the float32 reciprocal of the resolution
        self.grid = None if words is None else Const(words)
        self.grid_args = (0, 0, 0.0, 0.0, 0.0)
        if words is not None:
            occ, origin, res = grid
            origin = np.asarray(origin, np.float32)
            self.grid_args = (occ.shape[1], occ.shape[0], float(origin[0]),
                              float(origin[1]),
                              float(np.float32(1.0) / np.float32(res)))
        self.plain = make_steer(dynamics, erf, is_feasible, horizon_steps,
                                dt, error_tol, saturate, goal_buffer)

    def launch(self, rows, gains, pids, xtar, goal, variant):
        """Launch ``lqrrt_steer_rollout`` on CUDA tensors in
        ``rollout_geometry``; returns the SteerResult."""
        B, (n, m), H = xtar.shape[0], (self.n, self.m), self.H
        dev = xtar.device
        # one goal for every candidate, or one a candidate (check's shapes)
        goal_stride = 0 if goal is None or goal.dim() == 1 else n
        xs = torch.empty((H, n, B), dtype=torch.float32, device=dev)
        us = torch.empty((H, m, B), dtype=torch.float32, device=dev)
        length = torch.empty((B,), dtype=torch.int32, device=dev)
        xnew = torch.empty((B, n), dtype=torch.float32, device=dev)
        reached = torch.empty((B,), dtype=torch.bool, device=dev)
        in_goal = torch.empty((B,), dtype=torch.bool, device=dev)
        if B:
            _launch("lqrrt_steer_rollout", rows, gains, pids, rows.shape[0],
                    xtar, goal if self.has_goal else None, goal_stride,
                    self.params.like(xtar), self.tol.like(xtar),
                    self.gbuf.like(xtar) if self.has_goal else None,
                    self.circles.like(xtar), self.ncirc,
                    None if self.limits is None else self.limits.like(xtar),
                    None if self.grid is None else self.grid.like(xtar),
                    *self.grid_args, xs, us, length, xnew, reached, in_goal,
                    B, H, int(self.per_dim), *self.steps, self.model,
                    *rollout_geometry(B, sm_count(dev)))
            LAUNCHES[variant] += 1
        mask = torch.arange(H, device=dev)[:, None] < length[None, :]
        return SteerResult(xs, us, mask, length, xnew, reached, in_goal)

    def check(self, name, rows, gains, xtar, goal, pids=None):
        """dtype, device, shape and contiguity of a call's inputs."""
        n, m = self.n, self.m
        ins = [("x0/states", rows), ("K", gains), ("xtar", xtar)]
        if self.has_goal:
            if goal is None:
                raise ValueError(f"{name}: goal is required with a "
                                 "goal_buffer")
            ins.append(("goal", goal))
        for what, t in ins:
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: {what} must be float32")
            if t.device != xtar.device:
                raise ValueError(f"{name}: all inputs must share a device")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {what} must be contiguous")
        if xtar.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {xtar.device}")
        if pids is not None and (
                pids.dtype != torch.int32 or pids.dim() != 1
                or pids.device != xtar.device or not pids.is_contiguous()):
            raise TypeError(f"{name}: pids must be a contiguous (B,) int32 "
                            "tensor on the inputs' device")
        R = rows.shape[0] if rows.dim() == 2 else -1
        B = xtar.shape[0] if pids is None else pids.shape[0]
        if (rows.shape != (R, n) or gains.shape != (R, m, n)
                or xtar.shape != (B, n)
                or (goal is not None and self.has_goal
                    and goal.shape not in ((n,), (B, n)))):
            raise ValueError(
                f"{name}: x0/states (R, {n}), K (R, {m}, {n}), xtar (B, {n})"
                f" and goal ({n},) or (B, {n}), got {tuple(rows.shape)}, "
                f"{tuple(gains.shape)}, {tuple(xtar.shape)} and "
                f"{None if goal is None else tuple(goal.shape)}")
        if pids is None and R != B:
            raise ValueError(f"{name}: x0 and xtar must have the same "
                             f"batch, got {R} and {B}")


def _flat_steer(spec, variant, name):
    def steer(x0, K, xtar, goal=None):
        spec.check(name, x0, K, xtar, goal)
        if xtar.device.type == "cpu":
            return spec.plain(x0, K, xtar, goal)
        return spec.launch(x0, K, None, xtar, goal, variant)

    return steer


def make_steer_kernel(dynamics, erf, is_feasible, horizon_steps: int,
                      dt: float, error_tol, saturate=None, goal_buffer=None,
                      block: int = 64):
    """Build steer(x0 (B, n), K (B, m, n), xtar (B, n)[, goal (n,) or
    (B, n)]).

    ``block``: the Pallas kernel's ``batch_tile``, a multiple of 32 in
    [32, 1024]; checked, and not the card's geometry
    (``rollout_geometry``)."""
    return _flat_steer(_Spec(dynamics, erf, is_feasible, horizon_steps, dt,
                             error_tol, saturate, goal_buffer, block), "flat",
                       "steer_rollout")


def gather_rows(states, K, pids):
    """(states[pids], K[pids]), with a NaN row where a pid is outside
    [0, N): what the tree kernel reads.  A clamped index and ``torch.where``,
    so nothing syncs with the host and no pid wraps around (a plain index
    would read row N + pid for pid in [-N, 0))."""
    N = states.shape[0]
    idx = pids.long()
    ok = (idx >= 0) & (idx < N)
    safe = idx.clamp(0, max(N - 1, 0))
    nan = torch.full((), float("nan"), dtype=states.dtype,
                     device=states.device)
    return (torch.where(ok[:, None], states[safe], nan),
            torch.where(ok[:, None, None], K[safe], nan))


def make_steer_kernel_tree(dynamics, erf, is_feasible, horizon_steps: int,
                           dt: float, error_tol, saturate=None,
                           goal_buffer=None, block: int = 64):
    """Build steer(states (N, n), K (N, m, n), pids (B,) int32, xtar (B, n)
    [, goal (n,) or (B, n)]): the rollout of ``make_steer_kernel`` from the
    parents' rows, gathered inside the kernel (a (B, n) goal is one a
    candidate, as xtar).  A pid outside [0, N) gives a NaN start row and
    gain on the card and on the CPU alike: with circles, an empty,
    unreached rollout of NaN x and u (length 0, not in the goal).  The JAX
    tree kernel's one-hot gather gives a zero start there."""
    spec = _Spec(dynamics, erf, is_feasible, horizon_steps, dt, error_tol,
                 saturate, goal_buffer, block)

    def steer(states, K, pids, xtar, goal=None):
        spec.check("steer_rollout_tree", states, K, xtar, goal, pids)
        if xtar.device.type == "cpu":
            return spec.plain(*gather_rows(states, K, pids), xtar, goal)
        return spec.launch(states, K, pids, xtar, goal, "tree")

    steer.takes_tree = True
    return steer


def make_steer_kernel_dv(dynamics, erf, is_feasible, horizon_steps: int,
                         dt: float, error_tol, saturate=None,
                         goal_buffer=None, batch_tile: int = 512):
    """Build steer(x0 (B, n), K (B, m, n), xtar (B, n)[, goal]), the
    counterpart of ``make_steer_pallas_dv``: kernel D, counted as "dv";
    ``batch_tile``, a multiple of 32 up to 1024, is checked as ``block``
    is.  The Pallas kernel tests sum(e * e) <= tol^2; this one keeps the
    scan's norm (ROADMAP section 3)."""
    return _flat_steer(_Spec(dynamics, erf, is_feasible, horizon_steps, dt,
                             error_tol, saturate, goal_buffer, batch_tile),
                       "dv", "steer_rollout_dv")


def math_probe(op: str, a, b=None):
    """The kernel's ``tanf`` (op "tan": tan(a)) or ``div_rn`` (op "div":
    a / b) of float32 tensors, elementwise: on CUDA tensors the card's
    functions as kernel D computes them (``lqrrt_math_probe``), which
    ``chip_smoke.py`` holds against ``torch.tan`` and torch's ``/`` bit for
    bit; on the CPU those PyTorch functions."""
    if op not in ("tan", "div"):
        raise ValueError(f"math_probe: unknown op {op!r}")
    b = a if b is None else b
    if a.dtype != torch.float32 or b.shape != a.shape or b.device != a.device:
        raise ValueError("math_probe: a and b must be float32 tensors of "
                         "one shape on one device")
    if a.device.type == "cpu":
        return torch.tan(a) if op == "tan" else a / b
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    _launch("lqrrt_math_probe", a, b, out, a.numel(),
            ("tan", "div").index(op))
    return out
