"""Batched tree rewiring (port of lqrrt_tpu/core/rewire.py).

One rewire round re-parents a window of live target rows onto shorter
arriving edges: for each target the LQR-metric nearest strict
time-predecessor (not its current parent) is steered to the target's state;
the edge is taken iff the rollout converges within ``error_tol`` and
shortens the target's root arrival time.  Node times are then recomputed
for every row by pointer doubling, so descendants see the gain at once.
Judged against one pre-round ``node_time``, every edge old or new strictly
increases time from parent to child, so no batch of rewires makes a cycle.

Like ``core/commit.py``, the port mutates the tree's tensors in place, and
nothing here asks the host for a value: the window's start is drawn on the
device, and the reference's dropped scatters (``mode="drop"`` at row N)
become writes of each row's own value or adds of zero.

Child counts: a zero-length row (an empty rollout the dense commit stored
as a copy of its parent) is not in its parent's ``n_children``.  The
reference decrements the old parent of every re-parented target whether or
not it was counted (``rewire.py:170``); the port decrements only where the
target's old edge has ``edge_len >= 1``, so counts stay equal to the real
child counts and no parent with real children looks like a leaf.
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from .steer import make_steer
from .tree import TreeArrays

_EPS_IMPROVE = 1e-4   # required strict arrival-time gain (s)


def recompute_node_times(parent, edge_len, dt: float) -> torch.Tensor:
    """Root -> node time of every row by pointer doubling: ``parent`` (N,)
    int32 with -1 for the root and unused rows, ``edge_len`` (N,) int32.
    The same ceil(log2 N) + 1 iterations of ``d + d[p]`` over a virtual
    root row N as the reference, so the fp32 sums agree bit for bit."""
    N = parent.shape[0]
    dev = parent.device
    has = parent >= 0
    d = torch.where(has, edge_len.float() * dt, 0.0)
    p = torch.where(has, parent.long(), N)
    d = torch.cat([d, torch.zeros(1, dtype=torch.float32, device=dev)])
    p = torch.cat([p, torch.full((1,), N, dtype=torch.long, device=dev)])
    iters = max(int(math.ceil(math.log2(max(N, 2)))) + 1, 1)
    for _ in range(iters):
        d, p = d + d[p], p[p]
    return d[:N]


def make_nearest_pred(erf: Callable, block: int = 1024) -> Callable:
    """Blocked LQR-metric nearest neighbour among time-predecessors.

    nearest(states, S, node_time, live, x_t, time_t, excl, dt)
      -> (src ids int32, costs f32)

    A row is a candidate iff ``row < live``, ``node_time + dt < time_t``
    (a strict time-predecessor: not the target nor any descendant) and
    ``row != excl``.  Ties go to the lowest row, as ``jnp.argmin``; a
    non-finite cost drops only its own row (the reference's ``jnp.min``
    carries a NaN and drops the block).  Every row is scanned, the last
    block partial if ``block`` does not divide N.
    """
    def nearest(states, S, node_time, live, x_t, time_t, excl, dt):
        N = states.shape[0]
        B = x_t.shape[0]
        blk = min(block, N)
        dev = states.device
        best = torch.full((B,), math.inf, dtype=torch.float32, device=dev)
        best_id = torch.zeros((B,), dtype=torch.int32, device=dev)
        for j0 in range(0, N, blk):
            j1 = min(j0 + blk, N)
            e = erf(x_t[:, None, :], states[None, j0:j1, :])  # (B, blk, n)
            q = torch.einsum("jik,bjk->bji", S[j0:j1], e)
            cost = (e * q).sum(-1)                             # (B, blk)
            idx = torch.arange(j0, j1, device=dev)
            ok = (torch.isfinite(cost) & (idx[None, :] < live)
                  & (node_time[None, j0:j1] + dt < time_t[:, None])
                  & (idx[None, :] != excl[:, None]))
            cost = torch.where(ok, cost, math.inf)
            bc, bi = cost.min(dim=1)
            take = bc < best
            best = torch.where(take, bc, best)
            best_id = torch.where(take, (bi + j0).to(torch.int32), best_id)
        return best_id, best

    return nearest


def make_rewire(spec, dynamics: Callable, lqr: Callable, erf: Callable,
                is_feasible: Callable, error_tol, batch: int,
                wrap_mask=None, saturate: Callable | None = None) -> Callable:
    """Build rewire(tree, gen=None, start=None) -> tree, updated in place.

    ``spec`` is a ``core.rounds.RoundSpec``; ``batch`` targets a call;
    ``lqr`` is unused (a target's state, S and K do not change), as in the
    reference.  The targets are rows ``1 + (start + k) % (live - 1)``;
    ``start`` is a 0-d integer tensor on the tree's device, or None to draw
    it uniform in [0, live - 1) from ``gen`` on the device (the reference's
    ``jax.random.randint`` bound by a device scalar)."""
    del lqr
    dt = spec.dt
    steer = make_steer(dynamics, erf, is_feasible, spec.horizon_steps, dt,
                       error_tol, saturate=saturate)
    nearest = make_nearest_pred(erf, block=min(spec.nn_block, spec.capacity))
    wrap_dims = ([] if wrap_mask is None
                 else [int(d) for d in np.flatnonzero(wrap_mask)])

    def rewire(tree: TreeArrays, gen=None, start=None) -> TreeArrays:
        from ..ops.angles import wrap_angle

        dev = tree.size.device
        live = torch.clamp(tree.size, max=spec.capacity)
        nlive = torch.clamp(live - 1, min=1)
        if start is None:
            u = torch.rand((), generator=gen, device=dev)
            start = torch.minimum((u * nlive).floor().long(), nlive - 1)
        ar = torch.arange(batch, device=dev)
        t_idx = 1 + (start + ar) % nlive                   # int64
        valid_t = ar < live - 1

        x_t = tree.state[t_idx]
        time_t = tree.node_time[t_idx]
        cur_parent = tree.parent[t_idx]
        old_len = tree.edge_len[t_idx]

        src, _ = nearest(tree.state, tree.S, tree.node_time, live, x_t,
                         time_t, cur_parent, dt)
        srcl = src.long()
        res = steer(tree.state[srcl], tree.K[srcl], x_t)
        t_new = tree.node_time[srcl] + res.length.float() * dt
        improve = (res.reached & valid_t & (res.length >= 1)
                   & (t_new < time_t - _EPS_IMPROVE))
        x_seq = res.x_seq
        for d in wrap_dims:
            x_seq[:, d, :] = wrap_angle(x_seq[:, d, :])

        # child counts: masked adds (row 0, value 0, where nothing moves)
        zero = torch.zeros_like(srcl)
        moved = improve.to(torch.int32)
        counted = (improve & (old_len >= 1)).to(torch.int32)
        tree.n_children.index_add_(
            0, torch.where(improve, cur_parent.long(), zero), -counted)
        tree.n_children.index_add_(0, torch.where(improve, srcl, zero),
                                   moved)

        # the reference drops the writes of targets that do not improve.
        # Here every target writes: a rewired one its new edge, the others
        # their own row back.  Past the window (batch > live - 1) targets
        # repeat, and each repeat writes what its first occurrence writes
        # (its entry k % (live - 1)), so repeated rows get one value.
        first = ar % nlive
        imp = improve[first]
        tree.parent.index_copy_(0, t_idx, torch.where(
            imp, src[first], cur_parent))
        tree.edge_len.index_copy_(0, t_idx, torch.where(
            imp, res.length[first], old_len))
        for buf, seq in ((tree.edge_x, x_seq), (tree.edge_u, res.u_seq)):
            buf.index_copy_(2, t_idx, torch.where(
                imp, seq[:, :, first], buf[:, :, t_idx]))

        tree.node_time.copy_(recompute_node_times(tree.parent, tree.edge_len,
                                                  dt))
        return tree

    return rewire
