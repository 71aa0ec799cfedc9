"""One expansion round: sample -> nearest -> steer -> commit (port of
lqrrt_tpu/core/rounds.py ``RoundSpec``, ``Candidates``, ``make_expand``,
``commit_candidates``, ``make_round`` and ``make_refine_round``; and of
the fleet's round, ``parallel/fleet.py``'s vmapped ``make_round``, as
``make_fleet_round``).

``make_expand`` is the per-candidate compute: nearest under the LQR metric,
gather the parent's state and gain, then ``make_extend``: steer with the
first-entry goal stop, the endpoint LQR, wrapping of the angle dims, and
the goal cost-to-go.

The factories take ``spans``, a ``utils.timing.PhaseTimer`` that times
each phase of a round on the host (``round.sample``, ``round.nearest``,
``round.steer``, ``round.endpoint``, ``round.finish``, ``round.commit``)
and tallies the steer's route; the default, ``NO_SPANS``, times nothing.
The steer is ``core.steer.make_routed_steer``'s: kernel D on CUDA tensors
wherever D's factory accepts the problem, else the plain loop.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .commit import (commit_batch, commit_batch_dense,
                     commit_batch_dense_all, commit_batch_refine)
from .nearest import make_nearest
from .sampling import sample_batch
from .steer import make_routed_steer
from .tree import TreeArrays
from ..utils.timing import NO_SPANS


class RoundSpec(NamedTuple):
    """Static configuration of an expansion round.  The JAX spec's
    ``commit_all`` is ``commit_candidates``' argument here (true for the
    Planner's rounds, false for the map-sharded ones), and its
    ``lane_block`` has no counterpart: the block-column kernel of the
    dense commit-all takes any offset."""
    nstates: int
    ncontrols: int
    batch: int              # candidates per round
    horizon_steps: int      # steer rollout cap H
    capacity: int           # logical tree capacity
    dt: float
    nn_block: int = 1024
    slack: int = 0          # spare rows past capacity; >= batch takes a
                            # dense commit


class Candidates(NamedTuple):
    """Per-candidate results; edge rollouts time-major (H, ., B)."""
    pids: torch.Tensor      # (B,) int32
    length: torch.Tensor    # (B,) int32
    x_seq: torch.Tensor     # (H, n, B)
    u_seq: torch.Tensor     # (H, m, B)
    xnew: torch.Tensor      # (B, n)
    S_new: torch.Tensor     # (B, n, n)
    K_new: torch.Tensor     # (B, m, n)
    in_goal: torch.Tensor   # (B,) bool
    gcost: torch.Tensor     # (B,) f32


def make_extend(spec: RoundSpec, dynamics: Callable, lqr: Callable,
                erf: Callable, is_feasible: Callable, error_tol,
                goal_buffer, wrap_mask=None,
                saturate: Callable | None = None,
                spans=NO_SPANS) -> Callable:
    """Build extend(pids, x0, K0, xrand, goal) -> Candidates: the part of
    an expansion after the nearest pick, shared by ``make_expand`` and the
    fleet's round, for R rows: x0 and xrand (R, n), K0 (R, m, n), goal
    (n,) or one a row (R, n).  Steer with the first-entry goal stop
    (``round.steer``), the lqr at each endpoint with its last committed
    effort (``round.endpoint``), then the wrap of the angle dims and the
    goal cost-to-go (``round.finish``).  The steer is
    ``make_routed_steer``'s, its route tallied in ``spans``."""
    from ..ops.angles import wrap_angle

    steer = make_routed_steer(dynamics, erf, is_feasible, spec.horizon_steps,
                              spec.dt, error_tol, saturate=saturate,
                              goal_buffer=goal_buffer, spans=spans)
    wrap_dims = ([] if wrap_mask is None
                 else [int(d) for d in np.flatnonzero(wrap_mask)])

    def extend(pids, x0, K0, xrand, goal) -> Candidates:
        with spans.span("round.steer"):
            res = steer(x0, K0, xrand, goal)
        with spans.span("round.endpoint"):
            # effort of the last committed step (step 0 for an empty
            # rollout)
            last = torch.clamp(res.length - 1, min=0).long()
            u_last = res.u_seq.gather(
                0, last[None, None, :].expand(1, res.u_seq.shape[1], -1)
            )[0].T
            S_new, K_new = lqr(res.xnew, u_last)
        with spans.span("round.finish"):
            xnew, x_seq = res.xnew, res.x_seq
            if wrap_dims:
                # wrap both the endpoint and the stored edge states
                xnew = xnew.clone()
                for d in wrap_dims:
                    xnew[:, d] = wrap_angle(xnew[:, d])
                    x_seq[:, d, :] = wrap_angle(x_seq[:, d, :])
            e_goal = erf(goal, xnew)
            gcost = torch.einsum("bi,bij,bj->b", e_goal, S_new, e_goal)
            return Candidates(pids=pids, length=res.length, x_seq=x_seq,
                              u_seq=res.u_seq, xnew=xnew,
                              S_new=S_new.contiguous(),
                              K_new=K_new.contiguous(),
                              in_goal=res.in_goal, gcost=gcost)

    return extend


def make_expand(spec: RoundSpec, dynamics: Callable, lqr: Callable,
                erf: Callable, is_feasible: Callable, error_tol,
                goal_buffer, wrap_mask=None,
                saturate: Callable | None = None,
                nearest_fn: Callable | None = None,
                spans=NO_SPANS) -> Callable:
    """Build expand(tree, xrand, goal) -> Candidates.  ``nearest_fn``
    replaces the plain blocked scan (e.g. with the nn_const kernel)."""
    nearest = nearest_fn if nearest_fn is not None else make_nearest(
        erf, block=min(spec.nn_block, spec.capacity))
    extend = make_extend(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         spans=spans)

    def expand(tree: TreeArrays, xrand, goal) -> Candidates:
        with spans.span("round.nearest"):
            pids, _ = nearest(tree.state, tree.S, tree.size, xrand)
            pl = pids.long()
            x0, K0 = tree.state[pl], tree.K[pl]
        return extend(pids, x0, K0, xrand, goal)

    return expand


def commit_candidates(spec: RoundSpec, tree: TreeArrays, c: Candidates,
                      mode: str = "grow", commit_all: bool = True
                      ) -> TreeArrays:
    """Commit a round's candidates in place, selected as JAX's
    ``commit_candidates``: ``mode="refine"`` replaces leaves of a full
    tree (``commit_batch_refine``); ``mode="grow"`` appends them, with
    ``slack >= batch`` through the dense commit-all (every row lands) or,
    ``commit_all=False``, the sorted dense commit (valid rows first),
    else through the masked scatter ``commit_batch``."""
    args = (c.pids, c.length, c.x_seq, c.u_seq, c.xnew, c.S_new, c.K_new,
            c.in_goal, c.gcost)
    if mode == "refine":
        return commit_batch_refine(tree, spec.dt, spec.capacity, *args)
    if spec.slack >= c.pids.shape[0]:
        if commit_all:
            return commit_batch_dense_all(tree, spec.dt, spec.capacity,
                                          *args)
        return commit_batch_dense(tree, spec.dt, spec.capacity, *args)
    return commit_batch(tree, spec.dt, *args)


def make_round(spec: RoundSpec, dynamics: Callable, lqr: Callable,
               erf: Callable, is_feasible: Callable, error_tol,
               goal_buffer, wrap_mask=None,
               xrand_gen: Callable | None = None,
               saturate: Callable | None = None,
               nearest_fn: Callable | None = None) -> Callable:
    """Build round(tree, gen, goal, sample_space, goal_bias, bias_target)
    -> tree (updated in place).  ``xrand_gen(gen, batch)`` replaces the
    default sampler."""
    expand = make_expand(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn)

    def round_fn(tree, gen, goal, sample_space, goal_bias, bias_target):
        if xrand_gen is None:
            xrand = sample_batch(gen, spec.batch, sample_space, goal_bias,
                                 bias_target)
        else:
            xrand = xrand_gen(gen, spec.batch)
        return commit_candidates(spec, tree, expand(tree, xrand, goal))

    return round_fn


def make_refine_round(spec: RoundSpec, dynamics: Callable, lqr: Callable,
                      erf: Callable, is_feasible: Callable, error_tol,
                      goal_buffer, wrap_mask=None,
                      xrand_gen: Callable | None = None,
                      saturate: Callable | None = None,
                      nearest_fn: Callable | None = None,
                      spans=NO_SPANS) -> Callable:
    """The round of a full tree: ``half = max(batch // 2, 1)`` candidates
    expand and replace leaves (``commit_batch_refine``), then ``batch -
    half`` targets are rewired (``core/rewire.py``).

    round(tree, gen, goal, sample_space, goal_bias, bias_target,
          start=None) -> tree (updated in place).
    The half batch is ``xrand_gen(gen, half)`` when given (the planner's
    sampler), else ``sample_batch``; the rewire's window starts at
    ``start`` (a 0-d tensor) or is drawn from ``gen`` after the
    candidates."""
    from .rewire import make_rewire

    half = max(spec.batch // 2, 1)
    expand = make_expand(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn, spans=spans)
    rewire = make_rewire(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         batch=max(spec.batch - half, 1),
                         wrap_mask=wrap_mask, saturate=saturate)

    def round_fn(tree, gen, goal, sample_space, goal_bias, bias_target,
                 start=None):
        with spans.span("round.sample"):
            if xrand_gen is not None:
                xrand = xrand_gen(gen, half)
            else:
                xrand = sample_batch(gen, half, sample_space, goal_bias,
                                     bias_target)
        cand = expand(tree, xrand, goal)
        with spans.span("round.commit"):
            commit_candidates(spec, tree, cand, mode="refine")
        return rewire(tree, gen, start)

    return round_fn


def make_fleet_round(spec: RoundSpec, dynamics: Callable, lqr: Callable,
                     erf: Callable, is_feasible: Callable, error_tol,
                     goal_buffer, wrap_mask=None,
                     saturate: Callable | None = None,
                     spans=NO_SPANS) -> Callable:
    """The fleet's grow round over S scenario trees (JAX's
    ``jax.vmap(make_round(...))`` of ``parallel/fleet.py``, whose slack
    takes ``commit_batch_dense``).

    round(trees, xrand (S, B, n), goal_rows (S·B, n)) -> trees (in place).
    Each scenario's candidates find their nearest node in its own tree
    (``make_nearest`` over the scenario axis); then the S × B candidates are ONE batch of
    S·B rows for the steer, the endpoint lqr, the wrap and the goal cost,
    each row with its scenario's goal (``goal_rows``), and go back to
    (S, B) for the commit.  ``is_feasible`` sees rows of that batch.  The
    steer is ``make_extend``'s: kernel D, one launch for the S·B rows, on
    CUDA where D's factory takes the problem (the boat's circles), else
    the plain loop (a per-scenario-data predicate, CPU tensors)."""
    nearest = make_nearest(erf, block=min(spec.nn_block, spec.capacity))
    extend = make_extend(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         spans=spans)

    def round_fn(trees: TreeArrays, xrand, goal_rows) -> TreeArrays:
        n_sc, B, n = xrand.shape
        R = n_sc * B
        with spans.span("round.nearest"):
            pids, _ = nearest(trees.state, trees.S, trees.size, xrand)
            sc = torch.arange(n_sc, device=xrand.device)[:, None]
            pl = pids.long()
            x0, K0 = trees.state[sc, pl], trees.K[sc, pl]
        c = extend(pids.reshape(R), x0.reshape(R, n),
                   K0.reshape((R,) + K0.shape[2:]), xrand.reshape(R, n),
                   goal_rows)
        with spans.span("round.commit"):
            return commit_batch_dense(trees, spec.dt, spec.capacity,
                                      *scenario_leading(c, n_sc, B))

    return round_fn


def scenario_leading(c: Candidates, n_sc: int, B: int) -> Candidates:
    """Candidates of S·B flattened rows (scenario-major) -> the fleet
    commit's layout: (S, B, ...) per candidate, (S, H, ., B) edges (a
    view of the time-major rollouts)."""
    def rows(t):
        return t.reshape((n_sc, B) + t.shape[1:])

    def edges(t):
        return t.reshape(t.shape[:2] + (n_sc, B)).permute(2, 0, 1, 3)

    return Candidates(pids=rows(c.pids), length=rows(c.length),
                      x_seq=edges(c.x_seq), u_seq=edges(c.u_seq),
                      xnew=rows(c.xnew), S_new=rows(c.S_new),
                      K_new=rows(c.K_new), in_goal=rows(c.in_goal),
                      gcost=rows(c.gcost))
