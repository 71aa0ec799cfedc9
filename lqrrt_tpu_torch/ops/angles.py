"""Angle wrapping and erf constructors (port of lqrrt_tpu/ops/angles.py)."""
from __future__ import annotations

import math
from typing import Sequence

import torch

TWO_PI = 2.0 * math.pi


def wrap_angle(a: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) into [-pi, pi).  ``torch.remainder`` is a floor-mod
    like ``jnp.mod`` (``torch.fmod`` would keep the dividend's sign)."""
    return torch.remainder(a + math.pi, TWO_PI) - math.pi


def make_erf(nstates: int, angle_dims: Sequence[int] = ()):
    """Build batch-leading erf(xgoal, x) = xgoal - x, wrapped on
    ``angle_dims``.  The ``angle_dims`` tag tells the planner the erf is
    affine, which selects the constant-metric NN kernel."""
    dims = tuple(int(d) for d in angle_dims)
    for d in dims:
        if not 0 <= d < nstates:
            raise ValueError(f"angle dim {d} out of range for {nstates} "
                             "states")

    def erf(xgoal, x):
        e = xgoal - x                 # a fresh tensor: safe to wrap in place
        for d in dims:
            e[..., d] = wrap_angle(e[..., d])
        return e

    erf.angle_dims = dims
    return erf
