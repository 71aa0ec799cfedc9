"""Feasibility predicates (port of lqrrt_tpu/ops/collision.py).  Predicates
are batch-leading: ``(x[..., n], u[..., m]) -> bool[...]``; the data-driven
ones (``circles_free_data``, ``grid_free_data``) take a third argument, the
obstacle data, for ``Constraints(feasibility_data=...)``.

A NaN position is never free: the grid tests its bounds on the float cell
(false for NaN) before the cast to int, and a data circle counts a NaN
distance as a hit.  The JAX functions read a NaN position as free (XLA
casts NaN to cell 0, and ``d2 <= r2`` is false for NaN).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .._const import Const


def all_of(*preds: Callable) -> Callable:
    """Conjunction of feasibility predicates, tagged with them
    (``is_feasible.parts``) for the steer kernel."""
    def is_feasible(x, u):
        ok = None
        for p in preds:
            r = p(x, u)
            ok = r if ok is None else ok & r
        if ok is None:
            ok = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        return ok

    is_feasible.parts = preds
    return is_feasible


def circles_free(centers, radii, pos_dims: Sequence[int] = (0, 1),
                 margin: float = 0.0) -> Callable:
    """Feasible iff the position is outside every circular obstacle.

    centers: (K, 2), radii: (K,).  The predicate is tagged with what it
    tests, ``is_feasible.circles = (centers (K, 2), (radii + margin)^2
    (K,))`` as numpy, and ``is_feasible.pos_dims``: the steer kernel
    (``ops/kernels/steer_kernel.py``) reads the tags."""
    centers = Const(np.asarray(centers, np.float32).reshape(-1, 2))
    r2 = Const((np.asarray(radii, np.float32).reshape(-1) + margin) ** 2)
    dims = tuple(int(d) for d in pos_dims)

    def is_feasible(x, u):
        del u
        p = torch.stack([x[..., d] for d in dims], dim=-1)     # (..., 2)
        d2 = ((centers.like(x) - p[..., None, :]) ** 2).sum(-1)  # (..., K)
        return (d2 > r2.like(x)).all(-1)

    is_feasible.circles = (centers.value, r2.value)
    is_feasible.pos_dims = dims
    return is_feasible


def control_limits(umin, umax) -> Callable:
    """Feasible iff u is inside the box [umin, umax] (actuation limits).
    Tagged ``is_feasible.control_limits = (umin, umax)`` as float32 numpy
    for the steer kernel."""
    lo = Const(np.asarray(umin, np.float32))
    hi = Const(np.asarray(umax, np.float32))

    def is_feasible(x, u):
        del x
        return ((u >= lo.like(u)) & (u <= hi.like(u))).all(-1)

    is_feasible.control_limits = (lo.value, hi.value)
    return is_feasible


def _pos(x, dims):
    return torch.stack([x[..., d] for d in dims], dim=-1)


def state_box(xmin, xmax, dims: Sequence[int] | None = None) -> Callable:
    """Feasible iff the selected state dims stay inside [xmin, xmax]."""
    lo = Const(np.asarray(xmin, np.float32))
    hi = Const(np.asarray(xmax, np.float32))
    sel = None if dims is None else tuple(int(d) for d in dims)

    def is_feasible(x, u):
        del u
        xs = x if sel is None else _pos(x, sel)
        return ((xs >= lo.like(xs)) & (xs <= hi.like(xs))).all(-1)

    return is_feasible


def _grid_cells(p, origin, res: float, H: int, W: int):
    """(in bounds, flat cell index) of world positions p (..., 2).  The
    bounds are tested on the float cell, so NaN and huge coordinates are
    out of bounds, and only in-bounds cells are cast to int."""
    c = torch.floor((p - origin) / res)
    cx, cy = c[..., 0], c[..., 1]
    inb = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
    col = torch.where(inb, cx, 0.0).long()
    row = torch.where(inb, cy, 0.0).long()
    return inb, row * W + col


class OccupancyGrid:
    """Dense 2-D occupancy grid with a world->cell transform: ``occ`` (H, W),
    nonzero = occupied, row = y cell, column = x cell; ``origin`` is the
    world coordinate of cell (0, 0), ``resolution`` metres a cell.  Out of
    bounds (and NaN) is occupied.  The grid is copied to a device once, on
    the first call there."""

    def __init__(self, occ, origin, resolution: float,
                 pos_dims: Sequence[int] = (0, 1)):
        self.occ = np.asarray(occ) != 0
        self.origin = np.asarray(origin, np.float32)
        self.resolution = float(resolution)
        self.pos_dims = tuple(int(d) for d in pos_dims)
        self._occ_flat = Const(self.occ.reshape(-1))
        self._origin = Const(self.origin)

    def occupied(self, p):
        """True where world position p (..., 2) is in an occupied cell,
        out of bounds, or NaN."""
        H, W = self.occ.shape  # noqa: N806
        inb, flat = _grid_cells(p, self._origin.like(p), self.resolution,
                                H, W)
        hit = self._occ_flat.like(p, torch.bool)[flat]
        return torch.where(inb, hit, True)

    def is_feasible(self, x, u):
        del u
        return ~self.occupied(_pos(x, self.pos_dims))

    def feasibility(self, footprint_radius: float = 0.0,
                    n_ring: int = 8) -> Callable:
        """An is_feasible predicate, optionally inflated by a circular
        footprint sampled at ``n_ring`` boundary points."""
        if footprint_radius <= 0.0:
            return self.is_feasible
        ang = np.linspace(0.0, 2.0 * np.pi, n_ring, endpoint=False,
                          dtype=np.float32)
        ring = Const(footprint_radius
                     * np.stack([np.cos(ang), np.sin(ang)], -1))

        def is_feasible(x, u):
            del u
            p = _pos(x, self.pos_dims)[..., None, :]         # (..., 1, 2)
            pts = torch.cat([p, p + ring.like(p)], dim=-2)
            return ~self.occupied(pts).any(-1)

        return is_feasible


def _lead(data: torch.Tensor, core: int, x: torch.Tensor) -> torch.Tensor:
    """Per-scenario data (L..., *core) against states (L..., B..., n): a
    view with a singleton for each batch axis of x after the leading axes
    L, so it broadcasts row by row (JAX: the predicate under the fleet's
    ``vmap``).  Shared data (no leading axes) broadcasts as it is."""
    lead = data.dim() - core
    k = x.dim() - 1 - lead
    if lead == 0 or k <= 0:
        return data
    return data.reshape(data.shape[:lead] + (1,) * k + data.shape[lead:])


def circles_free_data(pos_dims: Sequence[int] = (0, 1),
                      margin: float = 0.0) -> Callable:
    """is_feasible(x, u, data) over a dynamic circle field: data =
    {"centers": (K, 2), "radii": (K,)} tensors; a slot with radius < 0 is
    inactive (K is fixed: a new K builds new chunks).  Leading axes on
    the data, (S, K, 2) and (S, K), give each of S scenarios its own
    field: x is then (S, ..., n)."""
    dims = tuple(int(d) for d in pos_dims)
    m = float(margin)

    def is_feasible(x, u, data):
        del u
        p = _pos(x, dims)[..., None, :]                      # (..., 1, 2)
        centers = _lead(data["centers"], 2, x)
        radii = _lead(data["radii"], 1, x)
        d2 = ((centers - p) ** 2).sum(-1)                    # (..., K)
        hit = (radii >= 0.0) & ~(d2 > (radii + m) ** 2)
        return ~hit.any(-1)

    return is_feasible


def grid_free_data(origin, resolution: float,
                   pos_dims: Sequence[int] = (0, 1)) -> Callable:
    """is_feasible(x, u, occ) over a dynamic occupancy grid: ``occ`` (the
    feasibility_data) is an (H, W) tensor, nonzero = occupied, under the
    fixed transform (origin, resolution).  Out of bounds is occupied.
    Leading axes on ``occ``, (S, H, W), give each of S scenarios its own
    grid: x is then (S, ..., n), and each state reads its scenario's grid
    in place (one gather into the S grids; no copy of a grid a row)."""
    org = Const(np.asarray(origin, np.float32))
    res = float(resolution)
    dims = tuple(int(d) for d in pos_dims)

    def is_feasible(x, u, occ):
        del u
        H, W = occ.shape[-2:]  # noqa: N806
        p = _pos(x, dims)
        inb, flat = _grid_cells(p, org.like(p), res, H, W)
        lead = occ.shape[:-2]
        if lead:
            # each state's scenario: its index over the leading axes
            sc = torch.arange(occ[..., 0, 0].numel(), device=occ.device)
            flat = flat + _lead(sc.reshape(lead), 0, x) * (H * W)
        hit = occ.reshape(-1)[flat] != 0
        return ~torch.where(inb, hit, True)

    return is_feasible
