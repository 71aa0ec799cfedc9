"""Problem specification record (port of lqrrt_tpu/constraints.py).

A numpy record: goal/search buffers are backend-neutral numpy arrays, and
``is_feasible`` is a batch-leading predicate ``(x[..., n], u[..., m]) ->
bool[...]``, or ``(x, u, data) -> bool[...]`` with ``feasibility_data``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def _all_true(x, u):
    del u
    return torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)


# the tag of ``ops.collision.circles_free``: no circles
_all_true.circles = (np.zeros((0, 2), np.float32), np.zeros((0,), np.float32))


def tree_map(fn, tree, *rest):
    """fn over the leaves of a dict / list / tuple tree (and of ``rest``,
    trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def host_leaf(a) -> torch.Tensor:
    """One leaf of feasibility_data as a tensor, floats as float32."""
    t = a.detach() if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))
    return t.float() if t.is_floating_point() else t


class Constraints:
    def __init__(self, nstates: int, ncontrols: int, goal_buffer,
                 search_buffer=None, is_feasible: Callable = None,
                 feasibility_data=None):
        self.nstates = int(nstates)
        self.ncontrols = int(ncontrols)
        self.goal_buffer = np.asarray(goal_buffer, np.float32)
        if self.goal_buffer.shape != (self.nstates,):
            raise ValueError(
                f"goal_buffer must have shape ({self.nstates},), got "
                f"{self.goal_buffer.shape}")
        if search_buffer is None:
            search_buffer = np.zeros((self.nstates, 2), np.float32)
        self.search_buffer = np.asarray(search_buffer, np.float32).reshape(
            self.nstates, 2)
        self.feasibility_data = feasibility_data
        self.set_feasibility_function(
            _all_true if is_feasible is None else is_feasible)

    def sample_space(self, x0, goal):
        """Per-dim sampling box spanning x0 -> goal padded by
        search_buffer."""
        x0 = np.asarray(x0, np.float32).reshape(self.nstates)
        goal = np.asarray(goal, np.float32).reshape(self.nstates)
        lo = np.minimum(x0, goal) + self.search_buffer[:, 0]
        hi = np.maximum(x0, goal) + self.search_buffer[:, 1]
        return np.stack([lo, hi], axis=1)

    def set_feasibility_function(self, is_feasible: Callable):
        """Swap the feasibility predicate (dynamic obstacle updates)."""
        if not callable(is_feasible):
            raise ValueError("is_feasible must be callable (x, u) -> bool")
        self.is_feasible = is_feasible
        self._feasibility_version = getattr(
            self, "_feasibility_version", -1) + 1

    def set_feasibility_data(self, data):
        """Swap the obstacle DATA of a 3-arg predicate ``is_feasible(x, u,
        data)`` without rebuilding the planner's chunks.

        ``data`` is a dict, list or tuple of arrays (or one array) whose
        shapes stay fixed across updates, e.g. a fixed-size occupancy grid,
        or (K, 2) circle centers with (K,) radii, unused slots padded with
        radius < 0.  The planner copies each update into the same device
        tensors; a change of shape builds new chunks."""
        if self.feasibility_data is None:
            raise ValueError(
                "constraints were built without feasibility_data; construct "
                "with feasibility_data=... and a 3-arg is_feasible(x, u, "
                "data)")
        self.feasibility_data = data
