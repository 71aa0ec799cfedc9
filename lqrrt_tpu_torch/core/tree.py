"""Fixed-capacity structure-of-arrays tree (port of lqrrt_tpu/core/tree.py).

Same fields, dtypes and layout as the JAX ``TreeArrays``: edge rollouts are
stored TIME-MAJOR, ``(H, n, N)`` / ``(H, m, N)`` with the node index minor,
which is the steer's natural output stacking; ``parent`` and ``edge_len``
are int32; ``size`` and ``goal_found`` are 0-d tensors on the device, so a
chunk never has to ask the host for them.  Unlike JAX's immutable arrays,
the port updates these tensors IN PLACE (commit, stash, reseed).

A fleet (``parallel/fleet.py``) holds S trees in one ``TreeArrays`` with a
leading scenario axis on every field: ``state`` (S, N, n), ``edge_x``
(S, H, n, N), ``size`` and ``goal_found`` (S,).  ``capacity``,
``valid_mask``, ``init_tree`` and ``best_node`` serve both forms.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class TreeArrays(NamedTuple):
    """All per-node storage, fixed capacity N; valid rows are [0, size)."""
    state: torch.Tensor      # (N, n) node states
    S: torch.Tensor          # (N, n, n) per-node LQR cost-to-go
    K: torch.Tensor          # (N, m, n) per-node LQR feedback gain
    parent: torch.Tensor     # (N,) int32, root = -1
    edge_x: torch.Tensor     # (H, n, N) incoming-edge rollout states
    edge_u: torch.Tensor     # (H, m, N) incoming-edge rollout efforts
    edge_len: torch.Tensor   # (N,) int32 valid steps of the incoming edge
    node_time: torch.Tensor  # (N,) f32 duration root -> node
    in_goal: torch.Tensor    # (N,) bool
    goal_cost: torch.Tensor  # (N,) f32 e'Se cost-to-go toward the goal
    n_children: torch.Tensor  # (N,) int32
    size: torch.Tensor       # () int32 number of valid rows
    goal_found: torch.Tensor  # () bool, any(in_goal)

    @property
    def capacity(self) -> int:
        return self.state.shape[-2]

    def valid_mask(self) -> torch.Tensor:
        """(..., N) bool: rows below each tree's size."""
        return (torch.arange(self.capacity, device=self.size.device)
                < self.size[..., None])


def init_tree(capacity: int, horizon_steps: int, nstates: int,
              ncontrols: int, x0, S0, K0, goal_cost0, in_goal0,
              slack: int = 0, root_pad: int = 1) -> TreeArrays:
    """Seed a fresh tree with the root x0 on x0's device.

    ``slack`` spare rows past the capacity take the dense commit's block;
    ``root_pad`` > 1 fills rows [1, root_pad) with inert copies of the root
    (row 0 wins every NN tie) so commits start at aligned columns — the
    same layout as the JAX tree, row for row.

    Leading axes of ``x0`` (n,) seed that many trees at once: x0 (S, n),
    S0 (S, n, n), K0 (S, m, n), goal_cost0 and in_goal0 (S,) give a fleet
    of S trees, each seeded as JAX's ``jax.vmap(init_tree)``."""
    N, H, n, m = capacity + slack, horizon_steps, nstates, ncontrols
    P = max(int(root_pad), 1)
    lead = tuple(x0.shape[:-1])
    dev = x0.device
    f32, i32 = torch.float32, torch.int32

    def zeros(*shape, dtype=f32):
        return torch.zeros(lead + shape, dtype=dtype, device=dev)

    state = zeros(N, n)
    state[..., :P, :] = x0[..., None, :]
    S = zeros(N, n, n)
    S[..., :P, :, :] = S0[..., None, :, :]
    K = zeros(N, m, n)
    K[..., :P, :, :] = K0[..., None, :, :]
    in_goal = zeros(N, dtype=torch.bool)
    in_goal[..., 0] = in_goal0
    goal_cost = torch.full(lead + (N,), float("inf"), dtype=f32, device=dev)
    goal_cost[..., 0] = goal_cost0
    return TreeArrays(
        state=state, S=S, K=K,
        parent=torch.full(lead + (N,), -1, dtype=i32, device=dev),
        edge_x=zeros(H, n, N), edge_u=zeros(H, m, N),
        edge_len=zeros(N, dtype=i32), node_time=zeros(N),
        in_goal=in_goal, goal_cost=goal_cost,
        n_children=zeros(N, dtype=i32),
        size=torch.full(lead, P, dtype=i32, device=dev),
        goal_found=in_goal[..., 0].clone())


def best_node(tree: TreeArrays) -> torch.Tensor:
    """Best branch: among goal nodes the shortest duration, else the least
    cost-to-go.  ``torch.argmin`` returns the first minimum, like
    ``jnp.argmin``, so the lowest index wins ties.  Returns a 0-d int64,
    or (S,) for a fleet (JAX's ``jax.vmap(best_node)``)."""
    valid = tree.valid_mask()
    t_masked = torch.where(tree.in_goal & valid, tree.node_time,
                           float("inf"))
    c_masked = torch.where(valid, tree.goal_cost, float("inf"))
    return torch.where(tree.goal_found, torch.argmin(t_masked, dim=-1),
                       torch.argmin(c_masked, dim=-1))
