"""Batch commits of steered candidates into the tree (port of
lqrrt_tpu/core/commit.py: ``commit_batch``, ``commit_batch_dense`` on one
tree or over a fleet's scenario axis, ``commit_batch_dense_all`` and
``commit_batch_refine``).

The JAX functions donate the tree's buffers and return new arrays; this
port MUTATES the given tree's tensors in place and returns the same tree.
A write the reference drops (``mode="drop"`` at row N) is here a write of
the row's own value back to it, at rows distinct from every kept write,
or an add of zero: nothing syncs, and no two writes race.
"""
from __future__ import annotations

import torch

from ..ops.kernels.write_kernel import block_write
from .tree import TreeArrays


def commit_batch(tree: TreeArrays, dt: float, pids, length, x_seq, u_seq,
                 xnew, S_new, K_new, in_goal, gcost) -> TreeArrays:
    """The masked scatter commit (JAX's ``commit_batch``): every candidate
    with ``length >= 1`` lands at row ``size + (its rank among them)``,
    in batch order, while that row is below the array's N rows (slack
    included, as JAX's ``tree.capacity``); the rest are dropped and
    ``size`` saturates at N.

    Candidate k is given the distinct row ``(size + j_k) % N``: j_k its
    rank among the kept candidates, or n_kept plus its rank among the
    dropped ones; a dropped candidate's row is written back with its own
    value.  So every write is an ``index_copy_`` at distinct rows, which
    needs B <= N."""
    B = pids.shape[0]
    N = tree.capacity
    if B > N:
        raise ValueError(f"commit_batch needs batch {B} <= the tree's "
                         f"{N} rows")
    valid = length >= 1
    vi = valid.to(torch.int32)
    pos = tree.size + vi.cumsum(0) - 1
    ok = valid & (pos < N)
    oki = ok.to(torch.int32)
    n_ok = oki.sum(dtype=torch.int32)
    j = torch.where(ok, oki.cumsum(0) - 1, n_ok + (1 - oki).cumsum(0) - 1)
    rows = ((tree.size + j) % N).long()
    pids_l = pids.long()
    node_time = tree.node_time[pids_l] + length.float() * dt

    def put(buf, new, dim=0):
        old = buf.index_select(dim, rows)
        shape = [1] * buf.dim()
        shape[dim] = B
        buf.index_copy_(dim, rows, torch.where(ok.reshape(shape),
                                               new.to(buf.dtype), old))

    put(tree.state, xnew)
    put(tree.S, S_new)
    put(tree.K, K_new)
    put(tree.parent, pids)
    put(tree.edge_x, x_seq, dim=2)
    put(tree.edge_u, u_seq, dim=2)
    put(tree.edge_len, length)
    put(tree.node_time, node_time)
    put(tree.in_goal, in_goal)
    put(tree.goal_cost, gcost)
    tree.n_children.index_add_(0, torch.where(ok, pids_l, 0), oki)
    tree.goal_found.logical_or_((in_goal & ok).any())
    tree.size.add_(n_ok)
    return tree


def commit_batch_dense_all(tree: TreeArrays, dt: float, limit: int, pids,
                           length, x_seq, u_seq, xnew, S_new, K_new, in_goal,
                           gcost) -> TreeArrays:
    """All B candidate rows (empty rollouts included) land contiguously at
    row ``start = min(size, limit)``, in raw batch order; the tree needs
    ``slack >= B`` rows past ``limit``.

    An empty-rollout row (length 0) is an inert zero-length duplicate of
    its parent: in_goal is masked false and it is left out of the parent's
    child count.  The time-major edge buffers are written by the
    block-column kernel, which reads ``start`` on the device; the other
    arrays take an ``index_copy_`` at ``start + arange(B)``, so nothing here
    asks the host for ``size``."""
    B = pids.shape[0]
    dev = tree.size.device
    valid = length >= 1
    start = torch.clamp(tree.size, max=limit)               # 0-d int32
    rank = torch.arange(B, dtype=torch.int32, device=dev)
    committed = start + rank < limit
    pids_l = pids.long()
    node_time = tree.node_time[pids_l] + length.float() * dt
    in_goal_c = in_goal & valid
    rows = (start + rank).long()

    tree.state.index_copy_(0, rows, xnew)
    tree.S.index_copy_(0, rows, S_new)
    tree.K.index_copy_(0, rows, K_new)
    tree.parent.index_copy_(0, rows, pids.to(torch.int32))
    block_write(tree.edge_x, x_seq.contiguous(), start)
    block_write(tree.edge_u, u_seq.contiguous(), start)
    tree.edge_len.index_copy_(0, rows, length.to(torch.int32))
    tree.node_time.index_copy_(0, rows, node_time)
    tree.in_goal.index_copy_(0, rows, in_goal_c)
    tree.goal_cost.index_copy_(0, rows, gcost)
    tree.n_children.index_add_(0, pids_l,
                               (committed & valid).to(torch.int32))
    tree.goal_found.logical_or_((in_goal_c & committed).any())
    tree.size.copy_(torch.clamp(tree.size + B, max=limit))
    return tree


def commit_batch_dense(trees: TreeArrays, dt: float, limit: int, pids,
                       length, x_seq, u_seq, xnew, S_new, K_new, in_goal,
                       gcost) -> TreeArrays:
    """The sorted dense commit of S scenario trees at once (JAX's
    ``jax.vmap(commit_batch_dense)``, the fleet's commit), or of one tree
    (pids (B,), JAX's ``commit_batch_dense``: the map-sharded rounds').

    Trees are scenario-leading (``core/tree.py``); the candidates are too:
    pids, length, in_goal, gcost (S, B), x_seq (S, H, n, B), u_seq
    (S, H, m, B), xnew (S, B, n), S_new (S, B, n, n), K_new (S, B, m, n).
    Per scenario, as JAX: the candidates in a stable valid-first order
    (valid = ``length >= 1``) land at rows ``start + rank``, ``start =
    min(size, limit)``, all B of them (rows past the valid ones are
    written but stay past ``size``; the trees need ``slack >= B`` rows past
    ``limit``); only ``committed = valid & (start + rank < limit)`` rows
    count a child of their parent or set ``goal_found``; ``size = min(size
    + n_valid, limit)``.  The rank is the stable sort's inverse
    permutation, counted with two prefix sums, so each candidate is
    written straight to its row: index copies, no sort, no sync."""
    if pids.dim() == 1:   # one tree: a scenario axis of 1, views of it
        one = TreeArrays(*(f.unsqueeze(0) for f in trees))
        commit_batch_dense(one, dt, limit, *(a.unsqueeze(0) for a in (
            pids, length, x_seq, u_seq, xnew, S_new, K_new, in_goal,
            gcost)))
        return trees
    n_sc, B = pids.shape
    dev = pids.device
    valid = length >= 1
    vi = valid.to(torch.int32)
    n_valid = vi.sum(1, dtype=torch.int32)                  # (S,)
    rank = torch.where(valid, vi.cumsum(1) - 1,
                       n_valid[:, None] + (1 - vi).cumsum(1) - 1)
    start = torch.clamp(trees.size, max=limit)[:, None]     # (S, 1)
    rows = (start + rank).long()                            # (S, B)
    committed = valid & (start + rank < limit)
    sc = torch.arange(n_sc, device=dev)[:, None]
    pids_l = pids.long()
    node_time = (torch.gather(trees.node_time, 1, pids_l)
                 + length.float() * dt)

    trees.state[sc, rows] = xnew
    trees.S[sc, rows] = S_new
    trees.K[sc, rows] = K_new
    trees.parent[sc, rows] = pids.to(torch.int32)
    # the node axis of the time-major edges is minor: index through
    # (S, N, H, .) views of the buffers and of the rollouts
    trees.edge_x.permute(0, 3, 1, 2)[sc, rows] = x_seq.permute(0, 3, 1, 2)
    trees.edge_u.permute(0, 3, 1, 2)[sc, rows] = u_seq.permute(0, 3, 1, 2)
    trees.edge_len[sc, rows] = length.to(torch.int32)
    trees.node_time[sc, rows] = node_time
    trees.in_goal[sc, rows] = in_goal
    trees.goal_cost[sc, rows] = gcost
    trees.n_children.scatter_add_(1, pids_l, committed.to(torch.int32))
    trees.goal_found.logical_or_((in_goal & committed).any(1))
    trees.size.copy_(torch.clamp(trees.size + n_valid, max=limit))
    return trees


_GOAL_OFFSET = 1e9   # goal-reaching candidates outrank any cost-to-go score


def commit_batch_refine(tree: TreeArrays, dt: float, limit: int, pids,
                        length, x_seq, u_seq, xnew, S_new, K_new, in_goal,
                        gcost) -> TreeArrays:
    """Leaf replacement in a full tree: candidates best-first (goal ones by
    root time, then by cost-to-go; empty rollouts never), replaceable rows
    worst-first by cost-to-go; the k-th best candidate replaces the k-th
    worst row iff its score is strictly lower.  ``size`` is unchanged.

    A row is replaceable iff it is live, not the root or an inert root
    copy of ``root_pad`` (no parent), not in the goal, no live row names it
    as parent, and it is not the parent of a candidate of this batch.
    The reference's orders are kept: a stable argsort of the candidates
    (``jnp.argsort``), and the rows by a stable descending sort, which puts
    the lower row first among equal scores as ``lax.top_k`` does (equal
    scores are common: a zero-length row shares its parent's cost-to-go).
    A victim's old parent loses a child only where the victim's edge has
    ``edge_len >= 1``: a zero-length row was never counted.

    Three repairs of the reference (``commit.py:242-252``), which tests
    ``n_children == 0`` and takes every live row: it decrements a
    zero-length victim's parent all the same; it replaces a row whose only
    children are zero-length rows, which then hold a state their parent no
    longer has (a zero-length row is a copy of its parent's state, and may
    get real children); and its root copies, cost-to-go +inf, rank as the
    worst victims and refuse the best ``root_pad - 1`` candidates of every
    round.  Here a row with any live child, counted or not, is kept, and
    the root copies are never victims."""
    B = pids.shape[0]
    N = tree.state.shape[0]
    dev = tree.size.device
    pids_l = pids.long()

    t_new = tree.node_time[pids_l] + length.float() * dt
    c_score = torch.where(in_goal, t_new - _GOAL_OFFSET, gcost)
    c_score = torch.where(length >= 1, c_score, torch.inf)
    c_order = torch.argsort(c_score, stable=True)
    c_score_s = c_score[c_order]
    pids_s = pids_l[c_order]

    idx = torch.arange(N, device=dev)
    live = (idx >= 1) & (idx < torch.clamp(tree.size, max=limit))
    parent_used = torch.zeros(N, dtype=torch.bool, device=dev).index_fill_(
        0, pids_l, True)
    # rows named as parent by a live row; the others fill the discard row N
    has_parent = live & (tree.parent >= 0)
    has_child = torch.zeros(N + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(has_parent, tree.parent.long(), N), True)[:N]
    replaceable = has_parent & ~has_child & ~tree.in_goal & ~parent_used
    v_score = torch.where(replaceable, tree.goal_cost, -torch.inf)
    v_worst, v_idx = torch.sort(v_score, descending=True, stable=True)
    v_worst, v_idx = v_worst[:B], v_idx[:B]

    replace = (c_score_s < v_worst) & torch.isfinite(v_worst)
    zero = torch.zeros_like(v_idx)
    counted = replace & (tree.edge_len[v_idx] >= 1)
    tree.n_children.index_add_(
        0, torch.where(replace, tree.parent[v_idx].long(), zero),
        -counted.to(torch.int32))
    tree.n_children.index_add_(0, torch.where(replace, pids_s, zero),
                               replace.to(torch.int32))

    # the victims are distinct rows: a row not replaced is written back
    def put(buf, new, dim=0):
        old = buf.index_select(dim, v_idx)
        shape = [1] * buf.dim()
        shape[dim] = B
        mask = replace.reshape(shape)
        buf.index_copy_(dim, v_idx, torch.where(mask, new, old))

    put(tree.state, xnew[c_order])
    put(tree.S, S_new[c_order])
    put(tree.K, K_new[c_order])
    put(tree.parent, pids_s.to(torch.int32))
    put(tree.edge_x, x_seq[:, :, c_order], dim=2)
    put(tree.edge_u, u_seq[:, :, c_order], dim=2)
    put(tree.edge_len, length[c_order].to(torch.int32))
    put(tree.node_time, t_new[c_order])
    put(tree.in_goal, in_goal[c_order])
    put(tree.goal_cost, gcost[c_order])
    tree.goal_found.logical_or_((in_goal[c_order] & replace).any())
    return tree
