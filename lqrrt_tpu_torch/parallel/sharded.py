"""Multi-device expansion rounds over ``torch.distributed`` (port of
lqrrt_tpu/parallel/sharded.py, P1/P2).

* The tree is REPLICATED: every rank holds the same tree, so the NN scan
  over it is local compute with no communication.
* The candidate batch is SHARDED over the "dp" axis: each rank draws its
  own shard from its own generator (``rank_generator``, JAX's
  ``fold_in(key, axis_index)``), runs nearest + steer + LQR on
  batch / n_dev candidates, then the candidates are exchanged and every
  rank commits the identical set, so the trees stay bit-identical round
  after round.  Every commit and the rewire are deterministic: index
  copies at distinct rows, integer adds, no float atomics.

The best-edge collectives (P2):

* ``collective="gather"``: an all-gather of the whole candidate batch,
  rank-major (batch-leading fields on axis 0, the time-major rollouts on
  their trailing candidate axis), then the single-device commit.
* ``collective="topk"``: an all-gather of one score a candidate, the same
  global top-k on every rank (a stable ascending sort: ``lax.top_k`` of
  the negated score keeps the lower index on ties), and one SUM
  all-reduce of the zero-masked winner rows (bools through int32); a
  winner whose score is not finite commits nothing.

Each rank runs the JAX per-device body literally (``parallel/mesh.py``):
the bodies take the mesh where JAX takes ``n_dev``, for its groups.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core.rounds import (Candidates, RoundSpec, commit_candidates,
                           make_expand)
from ..core.sampling import sample_batch
from ..core.tree import TreeArrays
from .mesh import axis_group, axis_index, axis_size, world_size

_GOAL_SCORE_OFFSET = 1e9   # goal candidates rank below any cost-to-go score

# Candidates fields whose candidate axis is the LAST one (the time-major
# rollouts); every other field is batch-leading
_TM_FIELDS = frozenset({"x_seq", "u_seq"})


def all_gather_tiled(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """JAX's ``all_gather(x, axis, axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in group-rank order.  The list form of
    ``all_gather``, which neither the card's torch nor a newer one
    deprecates; bools travel as uint8."""
    src = x.contiguous()
    if x.dtype == torch.bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.bool() if x.dtype == torch.bool else out


def gather_candidates(c: Candidates, mesh, axis) -> Candidates:
    """All-gather a round's candidates over ``axis``: batch-leading fields
    on axis 0, the time-major rollouts on their trailing candidate axis."""
    group = axis_group(mesh, axis)
    return Candidates(**{f: all_gather_tiled(getattr(c, f), group,
                                             -1 if f in _TM_FIELDS else 0)
                         for f in Candidates._fields})


mesh_axis_size = axis_size   # JAX's name: ranks over one axis or a tuple


def rank_generator(seed: int, mesh, axis, device) -> torch.Generator:
    """A generator seeded from (seed, the rank's index over ``axis``):
    JAX's ``fold_in(key, axis_index(axis))``.  Ranks that share the index
    (the map shards of one dp row) draw the same stream."""
    words = np.random.SeedSequence(
        [int(seed), axis_index(mesh, axis)]).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed((int(words[0]) << 31) ^ int(words[1]))
    return gen


def candidate_scores(tree: TreeArrays, c: Candidates, dt: float):
    """Commit priority, lower = better: infeasible -> +inf; goal-reaching
    -> root time - 1e9, ahead of every other; else the cost-to-go."""
    t_new = tree.node_time[c.pids.long()] + c.length.float() * dt
    score = torch.where(c.in_goal, t_new - _GOAL_SCORE_OFFSET, c.gcost)
    return torch.where(c.length >= 1, score, torch.inf)


def make_sharded_round_body(
        spec: RoundSpec, mesh, dynamics: Callable, lqr: Callable,
        erf: Callable, is_feasible: Callable, error_tol, goal_buffer,
        wrap_mask=None, saturate: Callable | None = None,
        nearest_fn: Callable | None = None,
        xrand_gen: Callable | None = None, axis="dp",
        collective: str = "gather", topk: int | None = None,
        commit: str = "grow") -> Callable:
    """Build the per-rank round body (JAX's ``make_sharded_round_body``,
    the mesh in place of ``n_dev``): the single-device round's semantics,
    the tree replicated, the candidate batch sharded over ``axis``.

    round_body(tree, gen, goal, sample_space, goal_bias, bias_target,
               rewire_gen=None, start=None) -> tree (updated in place)

    ``gen`` is this rank's generator (``rank_generator``), which draws its
    batch / n_dev candidates, or feeds ``xrand_gen(gen, local_b)``;
    spec.batch is the GLOBAL batch.  ``commit="refine"``: half the local
    batch expands and replaces leaves, then the rewire runs replicated
    from ``rewire_gen``, a generator every rank holds identically (or from
    ``start``, the window's first row), so the trees stay identical.
    ``nearest_fn`` (e.g. kernel A) runs on the rank's shard against its
    replica of the tree."""
    n_dev = axis_size(mesh, axis)
    if spec.batch % n_dev != 0:
        raise ValueError(f"batch {spec.batch} not divisible by mesh axis "
                         f"{axis}={n_dev}")
    if collective not in ("gather", "topk"):
        raise ValueError(f"unknown collective {collective!r}")
    local_b = spec.batch // n_dev
    rewire = None
    if commit == "refine":
        from ..core.rewire import make_rewire
        local_b = max(local_b // 2, 1)
        rewire = make_rewire(spec, dynamics, lqr, erf, is_feasible,
                             error_tol, batch=max(spec.batch // 2, 1),
                             wrap_mask=wrap_mask, saturate=saturate)
    if collective == "topk":
        topk = min(int(topk if topk is not None else spec.batch // 8),
                   spec.batch)
        if topk < 1:
            raise ValueError("topk must be >= 1")
    expand = make_expand(spec, dynamics, lqr, erf, is_feasible, error_tol,
                         goal_buffer, wrap_mask=wrap_mask, saturate=saturate,
                         nearest_fn=nearest_fn)
    group = axis_group(mesh, axis)
    idx = axis_index(mesh, axis)

    def winners_of(tree, cand):
        score = candidate_scores(tree, cand, spec.dt)         # (local_b,)
        score_all = all_gather_tiled(score, group)
        gidx = torch.sort(score_all, stable=True).indices[:topk]
        owner = gidx // local_b
        mine = owner == idx
        lidx = torch.where(mine, gidx % local_b, 0)

        def rows(a, last):
            r = a[..., lidx] if last else a[lidx]
            mask = mine.reshape(((1,) * (a.dim() - 1) + (topk,)) if last
                                else ((topk,) + (1,) * (a.dim() - 1)))
            r = torch.where(mask, r, torch.zeros_like(r))
            if a.dtype == torch.bool:
                r = r.to(torch.int32)
            dist.all_reduce(r, group=group)
            return r.bool() if a.dtype == torch.bool else r

        w = Candidates(**{f: rows(getattr(cand, f), f in _TM_FIELDS)
                          for f in Candidates._fields})
        # a winner whose global score is +inf (nothing feasible) carries
        # the length of an arbitrary owner row: mask it out
        feas = score_all[gidx] < torch.inf
        return w._replace(length=torch.where(feas, w.length, 0))

    def round_body(tree: TreeArrays, gen, goal, sample_space, goal_bias,
                   bias_target, rewire_gen=None, start=None) -> TreeArrays:
        if xrand_gen is None:
            xrand = sample_batch(gen, local_b, sample_space, goal_bias,
                                 bias_target)
        else:
            xrand = xrand_gen(gen, local_b)
        cand = expand(tree, xrand, goal)             # local compute
        if collective == "gather":
            cand = gather_candidates(cand, mesh, axis)
        else:
            cand = winners_of(tree, cand)
        commit_candidates(spec, tree, cand, mode=commit)
        if rewire is not None:
            rewire(tree, rewire_gen, start)
        return tree

    return round_body


# Every rank calls the per-rank body itself: there is no shard_map to wrap
# it in, so JAX's single-round builder is the body under its other name
make_sharded_round = make_sharded_round_body


def replicate_tree(tree: TreeArrays, mesh) -> TreeArrays:
    """Make every rank's tree the first rank's: a broadcast of every leaf,
    in place, over the mesh's ranks (bools as uint8).  The guarantee that
    the replicas start identical; a no-op on one rank."""
    if world_size() == 1:
        return tree
    group = axis_group(mesh, tuple(mesh.mesh_dim_names))
    src = int(mesh.mesh.flatten()[0])
    for t in tree:
        dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t,
                       src=src, group=group)
    return tree
