"""P3: the occupancy map sharded over ranks, collision verdicts reduced
(port of lqrrt_tpu/parallel/map_sharded.py).

When the world map is too large for one device, the grid is split
ROW-WISE over a "map" mesh axis: each rank holds one slab on its device,
and no rank holds the whole grid there.  Steering rolls out with the
cheap local predicates only (control limits, analytic obstacles); the
sharded grid then truncates each rollout at its first occupied step.
That is exact: a rollout's states do not depend on feasibility, which
only truncates, so the truncated edge is the one an in-loop check would
commit, with ONE SUM all-reduce of slab verdicts a round instead of one a
step.

Out of bounds is occupied.  A NaN position is occupied too: the bounds
are tested on the float cell before any cast, as ``ops/collision.py``'s
grids do (the JAX grid casts NaN to cell 0 and may read it free).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from .._const import Const
from ..core.rounds import RoundSpec, commit_candidates, make_expand
from ..core.sampling import sample_batch
from ..core.tree import TreeArrays
from .mesh import axis_group, axis_index, axis_size
from .sharded import gather_candidates


class ShardedGrid:
    """Row-sharded occupancy grid: shard d of the "map" axis holds rows
    [d * rows_per, (d + 1) * rows_per) of the (H, W) grid, padded past H
    with occupied rows.  ``occ_sharded`` (n_shards, rows_per, W) stays on
    the host; ``slab(d, device)`` puts one shard on a device."""

    def __init__(self, occ, origin, resolution: float, n_shards: int,
                 pos_dims=(0, 1)):
        occ = np.asarray(occ) != 0
        H, W = occ.shape
        rows_per = -(-H // n_shards)
        pad = rows_per * n_shards - H
        if pad:
            occ = np.pad(occ, ((0, pad), (0, 0)), constant_values=True)
        self.occ_sharded = occ.reshape(n_shards, rows_per, W)
        self.origin = np.asarray(origin, np.float32)
        self.resolution = float(resolution)
        self.H, self.W = H, W
        self.rows_per = rows_per
        self.n_shards = n_shards
        self.pos_dims = np.asarray(list(pos_dims))
        self._origin = Const(self.origin)

    def occupied_host(self, p):
        """The full grid's verdict on the host (numpy): p (..., 2) -> bool
        (...); the planner checks its prune and finish shortcuts with it
        (they steer with the local predicates only)."""
        c = np.floor((np.asarray(p, np.float32) - self.origin)
                     / self.resolution)
        cx, cy = c[..., 0], c[..., 1]
        inb = (cx >= 0) & (cx < self.W) & (cy >= 0) & (cy < self.H)
        occ_full = self.occ_sharded.reshape(-1, self.W)[:self.H]
        row = np.where(inb, cy, 0).astype(np.int64)
        col = np.where(inb, cx, 0).astype(np.int64)
        return ~inb | (occ_full[row, col] & inb)

    def slab(self, shard_idx: int, device) -> torch.Tensor:
        """Shard ``shard_idx`` as a (rows_per, W) bool tensor on
        ``device``."""
        return torch.as_tensor(self.occ_sharded[shard_idx], device=device)

    def occupied_local(self, p, slab, shard_idx: int):
        """(local, oob) for positions p (..., 2): ``local`` the verdict of
        ONE slab (rows_per, W), false outside its rows (the owning shard
        gives those through the reduction); ``oob`` whole-map out of
        bounds, the same on every shard, OR'd in after the reduction."""
        c = torch.floor((p - self._origin.like(p)) / self.resolution)
        cx, cy = c[..., 0], c[..., 1]
        inb = (cx >= 0) & (cx < self.W) & (cy >= 0) & (cy < self.H)
        ly = cy - shard_idx * self.rows_per
        # JAX's test: a padded row of the last slab reads occupied too
        in_slab = ((ly >= 0) & (ly < self.rows_per) & (cx >= 0)
                   & (cx < self.W))
        # cast before the product: float32 rounds a flat index past 2^24
        row = torch.where(in_slab, ly, 0.0).long()
        col = torch.where(in_slab, cx, 0.0).long()
        local = in_slab & slab.reshape(-1)[row * self.W + col]
        return local, ~inb


def make_grid_truncate(spec: RoundSpec, grid: ShardedGrid, lqr: Callable,
                       erf: Callable, goal_buffer, mesh,
                       axis="map") -> Callable:
    """Build truncate(tree, c, slab, goal) -> Candidates: the sharded
    collision pass.  Each rank scores the rollout batch against its slab;
    ONE SUM all-reduce over ``axis`` assembles the occupied mask, and each
    rollout is cut at its first occupied step.  The endpoint LQR, the goal
    test and the cost-to-go are recomputed at the cut."""
    pos_dims = [int(d) for d in grid.pos_dims]
    gbuf = Const(np.asarray(goal_buffer, np.float32))
    group = axis_group(mesh, axis)
    shard_idx = axis_index(mesh, axis)
    H = spec.horizon_steps

    def truncate(tree: TreeArrays, c, slab, goal):
        # time-major rollouts: x_seq (H, n, B) -> positions (H, B, 2)
        p = c.x_seq[:, pos_dims, :].permute(0, 2, 1)
        local, oob = grid.occupied_local(p, slab, shard_idx)
        hits = local.to(torch.int32)
        dist.all_reduce(hits, group=group)
        occupied = (hits > 0) | oob
        any_occ = occupied.any(0)                          # (B,)
        first = torch.where(any_occ, occupied.to(torch.int32).argmax(0), H)
        length = torch.minimum(c.length, first.to(torch.int32))
        x0 = tree.state[c.pids.long()]
        last = torch.clamp(length - 1, min=0).long()

        def at_last(seq):                              # (H, d, B) -> (B, d)
            return seq.gather(0, last[None, None, :].expand(
                1, seq.shape[1], -1))[0].T

        xnew = torch.where((length >= 1)[:, None], at_last(c.x_seq), x0)
        S_new, K_new = lqr(xnew, at_last(c.u_seq))
        e_goal = erf(goal, xnew)
        in_goal = (e_goal.abs() <= gbuf.like(e_goal)).all(-1)
        gcost = torch.einsum("bi,bij,bj->b", e_goal, S_new, e_goal)
        return c._replace(length=length, xnew=xnew,
                          S_new=S_new.contiguous(),
                          K_new=K_new.contiguous(), in_goal=in_goal,
                          gcost=gcost)

    return truncate


def make_dp_map_round_body(
        spec: RoundSpec, mesh, grid: ShardedGrid, dynamics: Callable,
        lqr: Callable, erf: Callable, local_feasible: Callable, error_tol,
        goal_buffer, wrap_mask=None, saturate: Callable | None = None,
        nearest_fn: Callable | None = None,
        xrand_gen: Callable | None = None,
        dp_axis: str | None = "dp", map_axis: str = "map") -> Callable:
    """The per-rank body of the P1 x P3 composed round over a 2-D (dp, map)
    mesh (JAX's ``make_dp_map_round_body``, the mesh in place of ``n_dp``
    and ``n_map``), reachable from ``Planner(mesh=...,
    feasibility_grid=ShardedGrid(...))`` with the whole anytime surface:

    round_body(tree, slab, gen, goal, sample_space, goal_bias, bias_target)
      -> tree (updated in place)

    Rank (i, j) steers candidate shard i, drawn from ``gen``, the dp row's
    generator (``rank_generator(seed, mesh, dp_axis, ...)``: the same on
    every map shard of the row), and holds grid slab j.  A round: the
    collision all-reduce over ``map_axis``, then the all-gather of the
    candidates over ``dp_axis`` (none with ``dp_axis=None``: the whole
    batch on every rank), then the replicated commit.  spec.batch is the
    GLOBAL batch; ``xrand_gen(gen, local_b)`` replaces the sampler.
    ``local_feasible`` holds what is NOT the sharded map (pass an
    always-true predicate if nothing).  The commit is JAX's choice for
    these rounds: the sorted dense commit with ``slack >= batch``, else
    the masked scatter."""
    n_dp = 1 if dp_axis is None else axis_size(mesh, dp_axis)
    n_map = axis_size(mesh, map_axis)
    if grid.n_shards != n_map:
        raise ValueError(f"grid has {grid.n_shards} shards but mesh "
                         f"'{map_axis}' axis has {n_map} ranks")
    if spec.batch % n_dp != 0:
        raise ValueError(f"batch {spec.batch} not divisible by {dp_axis}="
                         f"{n_dp}")
    local_b = spec.batch // n_dp
    expand = make_expand(spec, dynamics, lqr, erf, local_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn)
    truncate = make_grid_truncate(spec, grid, lqr, erf, goal_buffer, mesh,
                                  map_axis)

    def round_body(tree: TreeArrays, slab, gen, goal, sample_space,
                   goal_bias, bias_target) -> TreeArrays:
        if xrand_gen is None:
            xrand = sample_batch(gen, local_b, sample_space, goal_bias,
                                 bias_target)
        else:
            xrand = xrand_gen(gen, local_b)
        c = truncate(tree, expand(tree, xrand, goal), slab, goal)
        if dp_axis is not None:
            c = gather_candidates(c, mesh, dp_axis)
        return commit_candidates(spec, tree, c, commit_all=False)

    return round_body


# Every rank calls the per-rank body itself (there is no shard_map to wrap
# it in): JAX's composed-round builder is the body under its other name
make_dp_map_round = make_dp_map_round_body


def make_map_sharded_round(spec: RoundSpec, mesh, grid: ShardedGrid,
                           *args, axis: str = "map", **kw) -> Callable:
    """The round with the map sharded over ``axis``, candidates and tree
    replicated: the composed round with no dp axis, its arguments after
    ``grid`` the same.  ``gen`` must draw the same stream on every rank:
    the map axis parallelises the world, not the batch."""
    return make_dp_map_round_body(spec, mesh, grid, *args, dp_axis=None,
                                  map_axis=axis, **kw)
