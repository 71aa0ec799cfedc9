"""LQR-metric nearest neighbour over the tree, plain PyTorch (port of
lqrrt_tpu/core/nearest.py ``make_nearest``).

The blocked scan with a running (min, argmin) merge: peak memory stays
O(batch x block x n) whatever the tree's capacity.  It serves any erf and a
per-node S, and it is the planner's NN on the CPU.  Strict '<' across
blocks and the first minimum inside one keep the lowest index on ties; a
non-finite cost never wins.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def make_nearest(erf: Callable, block: int = 1024) -> Callable:
    """Build nearest(states, S, size, xrand) -> (ids int32, costs f32).

    states: (..., N, n); S: (..., N, n, n); size: (...) int tensor; xrand:
    (..., B, n); ids and costs: (..., B).  The leading axes are the fleet's
    scenarios (JAX's ``jax.vmap(make_nearest(...))``); the planner's one
    tree has none.  Each scenario scans only its own tree.
    """
    def nearest(states, S, size, xrand):
        N = states.shape[-2]
        blk = min(block, N)
        dev = states.device
        best = torch.full(xrand.shape[:-1], math.inf, dtype=torch.float32,
                          device=dev)
        best_id = torch.zeros(xrand.shape[:-1], dtype=torch.int32,
                              device=dev)
        live = size[..., None, None]
        for j0 in range(0, N, blk):
            j1 = min(j0 + blk, N)
            e = erf(xrand[..., :, None, :],
                    states[..., None, j0:j1, :])         # (..., B, blk, n)
            q = torch.einsum("...jik,...bjk->...bji", S[..., j0:j1, :, :], e)
            cost = (e * q).sum(-1)                       # (..., B, blk)
            idx = torch.arange(j0, j1, device=dev)
            # a non-finite cost (a NaN S row) drops only its own row; the
            # JAX scan's jnp.min would carry the NaN and drop the block
            cost = torch.where(torch.isfinite(cost) & (idx < live), cost,
                               math.inf)
            bc, bi = cost.min(dim=-1)
            take = bc < best
            best = torch.where(take, bc, best)
            best_id = torch.where(take, (bi + j0).to(torch.int32), best_id)
        return best_id, best

    return nearest
