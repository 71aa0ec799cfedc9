"""Dense batch commit of steered candidates into the tree (port of
lqrrt_tpu/core/commit.py ``commit_batch_dense_all``).

The JAX function donates the tree's buffers and returns new arrays; this
port MUTATES the given tree's tensors in place and returns the same tree.
"""
from __future__ import annotations

import torch

from ..ops.kernels.write_kernel import block_write
from .tree import TreeArrays


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
