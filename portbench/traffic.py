"""The one traffic generator: every mix is a data file
(``portbench/traffic/<name>.json``) of parameters that this module reads.

Keys of a mix:
- ``obstacle_model``: "circles" or "grid" (the configuration's buoys or
  their raster);
- ``per_scenario_grids`` (fleet, optional): {"lo", "hi", "levels"}, the
  stratified set of (dx, dy) shifts of the raster, one a scenario;
- ``min_time``, ``max_time``: the replan budget (s); ``pruning``;
- ``goals``: {"dims", "lo", "hi", "levels"}: the stratified set of goal
  offsets from the configuration's goal.

Every mix runs as a closed loop: the next replan starts when the last has
returned.

Every seed gets the same set of goals (and shifts) in another order, so
the seed changes the order and the planner's draws, and a window's plan
durations and goal rate do not swing with where a uniform draw of goals
happens to fall.
"""
from __future__ import annotations

import itertools

import numpy as np

# separate streams of one seed
_GOAL_ORDER, _SHIFT_ORDER, _SAMPLE = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def stratified(lo, hi, levels) -> np.ndarray:
    """(prod(levels), d) points at the centres of a regular grid of cells
    over the box [lo, hi]."""
    axes = [lo_ + (np.arange(k) + 0.5) / k * (hi_ - lo_)
            for lo_, hi_, k in zip(lo, hi, levels)]
    return np.array(list(itertools.product(*axes)), np.float64)


class GoalStream:
    """Goals for replans: the configuration's goal moved by each offset of
    the mix's stratified set, in an order drawn from the seed; a fresh
    order each time the set is used up."""

    def __init__(self, cfg: dict, mix: dict, seed: int):
        g = mix["goals"]
        self.base = np.asarray(cfg["goal"], np.float32)
        self.dims = list(g["dims"])
        self.offsets = stratified(g["lo"], g["hi"], g["levels"])
        self._rng = rng(seed, _GOAL_ORDER)
        self._queue = []

    def _goal(self, off) -> np.ndarray:
        goal = self.base.copy()
        goal[self.dims] += off.astype(np.float32)
        return goal

    def next_goal(self) -> np.ndarray:
        if not self._queue:
            self._queue = list(self._rng.permutation(len(self.offsets)))
        return self._goal(self.offsets[self._queue.pop(0)])

    def cycle_goals(self, n_scenarios: int) -> np.ndarray:
        """(S, n) goals of one fleet cycle: the whole set, tiled to S
        scenarios, in a fresh order."""
        reps = -(-n_scenarios // len(self.offsets))
        idx = np.tile(np.arange(len(self.offsets)), reps)[:n_scenarios]
        idx = self._rng.permutation(idx)
        out = np.tile(self.base, (n_scenarios, 1))
        out[:, self.dims] += self.offsets[idx].astype(np.float32)
        return out


def scenario_shifts(mix: dict, seed: int, n_scenarios: int) -> np.ndarray:
    """(S, 2) shifts of the obstacle raster, one a scenario: the mix's
    stratified set in an order drawn from the seed."""
    s = mix["per_scenario_grids"]
    pts = stratified(s["lo"], s["hi"], s["levels"])
    reps = -(-n_scenarios // len(pts))
    idx = np.tile(np.arange(len(pts)), reps)[:n_scenarios]
    return pts[rng(seed, _SHIFT_ORDER).permutation(idx)].astype(np.float32)


def sample_indices(seed: int, n: int, k: int, must=()) -> list:
    """k of range(n) drawn from the seed, with the indices ``must``."""
    pick = set(int(i) for i in must)
    order = rng(seed, _SAMPLE).permutation(n)
    for i in order:
        if len(pick) >= min(k, n):
            break
        pick.add(int(i))
    return sorted(pick)
