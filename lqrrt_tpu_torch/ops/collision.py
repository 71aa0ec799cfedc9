"""Feasibility predicates (port of ``all_of``, ``circles_free`` and
``control_limits`` from lqrrt_tpu/ops/collision.py).  Predicates are
batch-leading: ``(x[..., n], u[..., m]) -> bool[...]``."""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from .._const import Const


def all_of(*preds: Callable) -> Callable:
    """Conjunction of feasibility predicates."""
    def is_feasible(x, u):
        ok = None
        for p in preds:
            r = p(x, u)
            ok = r if ok is None else ok & r
        if ok is None:
            ok = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        return ok
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
    """Feasible iff u is inside the box [umin, umax] (actuation limits)."""
    lo = Const(np.asarray(umin, np.float32))
    hi = Const(np.asarray(umax, np.float32))

    def is_feasible(x, u):
        del x
        return ((u >= lo.like(u)) & (u <= hi.like(u))).all(-1)

    return is_feasible
