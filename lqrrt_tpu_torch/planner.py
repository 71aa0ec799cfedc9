"""Planner facade (port of lqrrt_tpu/planner.py, its single-device paths).

Public surface as in the JAX package: ``update_plan``, ``warmup``,
``get_state``, ``get_effort``, ``set_goal``, ``kill_update``, ``unkill``,
``x_seq``/``u_seq``/``T``, ``stats`` with the same keys.  Two anytime
loops, chosen as the JAX planner chooses them; in both the host reads one
small stats vector per chunk, one chunk stale, and nothing inside a chunk
syncs:
- the restart loop (``refine=True`` and ``max_nodes`` at or above the
  capacity): fused-restart chunks, each ``n_cycles`` cycles of [F grow
  rounds -> stash-compare -> reseed with depth planting];
- the host loop (``refine=False``, ``max_nodes`` below the capacity, or
  ``refine_mode="leaf_rewire"``): grow chunks of ``rounds_per_chunk``
  rounds on one tree, stopped at the budget, at the goal after
  ``min_time``, or at min(max_nodes, capacity) rows; with
  ``refine_mode="leaf_rewire"`` (and ``refine=True``, ``max_nodes`` at or
  above the capacity) a full tree is not a stop: the rest of the budget
  runs refine chunks on the same tree, each round a half batch of leaf
  replacements (``core/commit.py`` ``commit_batch_refine``) and a half
  batch of rewires (``core/rewire.py``).

A 3-arg ``is_feasible(x, u, data)`` (``Constraints(feasibility_data=...)``)
reads its data from device tensors the planner keeps: each replan copies
the constraints' data into them in place, so an update of values builds no
chunk and moves no tensor.

Not ported yet, raising ``NotImplementedError`` with the ROADMAP item:
``mesh`` and ``feasibility_grid``.

``get_tree`` snapshots the last planning tree into the host ``Tree``
(``lqrrt_tpu_torch/tree.py``); ``utils`` holds checkpoints, metrics sinks,
the replan watchdog and the phase timer, and ``runtime`` the trajectory
server.

The NN on CUDA is a hand-written kernel for an affine erf (subtract, or at
most one wrapped angle dim): ``nn_const`` when the ``lqr`` is constant (the
boat, the double integrator), ``nn_general`` for a per-node ``lqr`` (the
car and the quadrotor); any other erf takes the plain blocked scan, as in
the JAX planner.  ``nn_selected`` says which ran: "nn_const",
"nn_general" or "scan".

Callbacks are batch-leading (see the package docstring).  The device is
explicit: ``device="cuda"`` (the default) raises when CUDA is absent.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .constraints import Constraints
from .core.rounds import (RoundSpec, commit_candidates, make_expand,
                          make_refine_round)
from .core.sampling import normalize_goal_bias, sample_batch
from .core.steer import make_steer
from .core.tree import TreeArrays, best_node, init_tree
from .ops.angles import wrap_angle
from .tree import Tree

_FPR_PLAN_LEN = 256   # resampled previous-plan states kept for FPR biasing
_PRUNE_MAX = 32       # chain nodes covered by the all-pairs shortcut batch
_FINISH_BATCH = 8     # tiled batch for the terminal goal connection


def _at(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-d index tensor, as a device gather (never ``.item()``)."""
    return t.index_select(0, i.reshape(1))[0]


def _walk(parent: torch.Tensor, start: torch.Tensor, steps: int):
    """(steps,) int64 ids of the chain start -> root, leaf first, -1 past
    the root: a fixed-length walk on the device."""
    cur = start.long()
    ids = []
    for _ in range(steps):
        ids.append(cur)
        up = _at(parent, torch.clamp(cur, min=0)).long()
        cur = torch.where(cur >= 0, up, -1)
    return torch.stack(ids)


def _chunk_stats(tree: TreeArrays) -> torch.Tensor:
    """f32 [size, goal_found, best_goal_time, best_goal_cost, best_id,
    n_live]; n_live counts rows with a real incoming edge, plus the root."""
    b = best_node(tree)
    live = ((tree.edge_len >= 1) & tree.valid_mask()).sum() + 1
    return torch.stack([
        tree.size.float(),
        tree.goal_found.float(),
        torch.where(tree.goal_found, _at(tree.node_time, b), torch.inf),
        _at(tree.goal_cost, b),
        b.float(),
        live.float()])


def _tree_map(fn, tree, *rest):
    """fn over the leaves of a dict / list / tuple tree (and of ``rest``,
    trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def _signature(tree):
    """Hashable structure, shapes and dtypes of a tree of tensors."""
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    return (tuple(tree.shape), tree.dtype)


def _host_leaf(a) -> torch.Tensor:
    """One leaf of feasibility_data as a tensor, floats as float32."""
    t = a.detach() if isinstance(a, torch.Tensor) else torch.as_tensor(
        np.asarray(a))
    return t.float() if t.is_floating_point() else t


class Planner:
    # score vector of the fused-restart chunk, f32[6]:
    # [valid, s1 (0 = best has goal), s2 (goal time | cost-to-go),
    #  n_live of best, any_goal seen, best node id in the stashed tree]
    _RSCORE0 = (0.0, 1.0, np.inf, 1.0, 0.0, 0.0)
    _POOL_DEPTH = 64      # chain-walk cap for the informed pool
    _EXTRACT_DEPTH = 128  # fixed-depth device chain walk (host fallback)

    def __init__(self, dynamics: Callable, lqr: Callable,
                 constraints: Constraints, horizon: float, dt: float = 0.05,
                 FPR: float = 0.0, error_tol=0.05,
                 erf: Callable = torch.subtract,
                 min_time: float = 0.5, max_time: float = 1.0,
                 max_nodes: Optional[int] = None, goal0=None,
                 sys_time: Callable = time.time, printing: bool = True, *,
                 batch_size: int = 512, capacity: Optional[int] = None,
                 wrap_dims=(), nn_block: int = 1024, seed: int = 0,
                 saturate: Optional[Callable] = None,
                 rounds_per_chunk: int = 8, nn_impl: str = "auto",
                 steer_impl: str = "scan",
                 mesh=None, mesh_axis: str = "dp",
                 collective: str = "gather", topk: Optional[int] = None,
                 refine: bool = True, refine_mode: str = "restart",
                 informed: float = 0.5, informed_anneal: float = 1.0,
                 feasibility_grid=None, map_axis: str = "map",
                 device="cuda"):
        if horizon <= 0 or dt <= 0:
            raise ValueError("horizon and dt must be positive")
        if nn_impl not in ("auto", "nn_const", "nn_general", "scan"):
            raise ValueError(f"unknown nn_impl {nn_impl!r}")
        if steer_impl == "auto":
            steer_impl = "scan"
        if steer_impl != "scan":
            raise ValueError(
                f"steer_impl {steer_impl!r} is not available: the planner's "
                "steer is the scan (core/steer.py); the fused rollout, "
                "kernel D, is an experiment (tools/exp_steer_kernel.py)")
        if collective not in ("gather", "topk"):
            raise ValueError(f"unknown collective {collective!r}")
        if refine_mode not in ("restart", "leaf_rewire"):
            raise ValueError(f"unknown refine_mode {refine_mode!r}")
        if refine_mode == "leaf_rewire" and feasibility_grid is not None:
            raise ValueError("refine_mode='leaf_rewire' is not supported "
                             "with a sharded feasibility_grid")
        if informed_anneal != 1.0:
            warnings.warn(
                "informed_anneal != 1.0 measurably degrades anytime plan "
                "quality in the JAX package (tools/exp_informed.py); keep the "
                "default 1.0 unless you have measured otherwise on your "
                "workload", stacklevel=2)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        # the JAX package computes the metric at Precision.HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.dynamics = dynamics
        self.lqr = lqr
        self.constraints = constraints
        self.horizon = float(horizon)
        self.dt = float(dt)
        self.FPR = float(FPR)
        self.error_tol = error_tol
        self.erf = erf
        self.saturate = saturate
        self.min_time = float(min_time)
        self.max_time = float(max_time)
        self.max_nodes = int(1e5) if max_nodes is None else int(max_nodes)
        self.sys_time = sys_time
        self.printing = printing

        self.nstates = constraints.nstates
        self.ncontrols = constraints.ncontrols
        self.horizon_steps = max(int(round(self.horizon / self.dt)), 1)
        self.batch_size = int(batch_size)
        self.nn_block = int(nn_block)
        if capacity is None:
            capacity = min(self.max_nodes, 32768)
        # capacity rounded up to the NN block; block-aligned slack rows
        # take the dense commit
        blk = min(self.nn_block, capacity)
        self.capacity = -(-int(capacity) // blk) * blk
        self.slack = -(-self.batch_size // blk) * blk
        # 512 root-pad rows when batch/capacity/slack are 512-aligned: the
        # same rule as the JAX planner, so both trees match row for row
        _LB = 512
        lb_ok = (self.batch_size % _LB == 0 and self.capacity % _LB == 0
                 and self.slack % _LB == 0 and self.capacity >= 8 * _LB)
        self.root_pad = _LB if lb_ok else 1
        self.wrap_dims = tuple(wrap_dims)
        self.rounds_per_chunk = max(int(rounds_per_chunk), 1)
        self.nn_impl = nn_impl
        self.steer_impl = self.steer_selected = "scan"
        self.refine = bool(refine)
        self.refine_mode = refine_mode
        self.informed = float(informed)
        # read only by the host loop's restart stash, which needs a
        # feasibility_grid (ROADMAP queue 1, item 16)
        self.informed_anneal = float(informed_anneal)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.collective = collective
        self.topk = topk
        self.feasibility_grid = feasibility_grid
        self.map_axis = map_axis
        self._check_ported()

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self._lqr_const = None          # lazily probed (_lqr_is_constant)
        self.nn_selected = None         # NN picked when a chunk is built
        self._chunk_cache = {}
        self._steer_cache = {}
        self._feas_bufs = {}            # data signature -> device tensors
        self._feas_sig = None           # signature of the data in force
        self._killed = False
        self._device_tree: Optional[TreeArrays] = None
        self.tree: Optional[Tree] = None    # host snapshot, made lazily
        # the committed plan is ONE tuple (x_seq, u_seq, T), swapped
        # atomically, so a reader never sees a torn plan
        self._plan = None
        self.plan_reached_goal = False
        self.goal = None
        self.stats = {}
        self.on_replan: Optional[Callable] = None
        if goal0 is not None:
            self.set_goal(goal0)

    def _check_ported(self):
        """Raise for the configurations this port does not have yet."""
        def missing(what, item):
            raise NotImplementedError(
                f"{what} is not ported yet (ROADMAP queue 1, item {item})")
        if self.mesh is not None:
            missing("mesh=", 16)
        if self.feasibility_grid is not None:
            missing("feasibility_grid=", 16)

    # ------------------------------------------------------------------ setup

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def set_goal(self, goal):
        goal = self._tensor(goal)
        if goal.shape != (self.nstates,):
            raise ValueError(f"goal must have shape ({self.nstates},)")
        self.goal = goal

    def kill_update(self):
        """Preempt a running update_plan at the next chunk boundary."""
        self._killed = True

    def unkill(self):
        self._killed = False

    def _wrap_mask(self):
        if not self.wrap_dims:
            return None
        wrap_mask = np.zeros(self.nstates, bool)
        wrap_mask[list(self.wrap_dims)] = True
        return wrap_mask

    def _lqr_is_constant(self) -> bool:
        """Probe whether lqr(x, u) is state-independent (one S for the
        whole tree): two distinct states, compared on the host; an lqr
        that raises on them is not constant."""
        if self._lqr_const is None:
            n, m = self.nstates, self.ncontrols
            xa = torch.zeros(n, device=self.device)
            xb = torch.full((n,), 0.731, device=self.device)
            xb[min(1, n - 1)] = -0.417
            ua = torch.zeros(m, device=self.device)
            ub = torch.full((m,), 0.293, device=self.device)
            try:
                Sa, Ka = (np.asarray(t.cpu()) for t in self.lqr(xa, ua))
                Sb, Kb = (np.asarray(t.cpu()) for t in self.lqr(xb, ub))
            except Exception:
                self._lqr_const = False
            else:
                self._lqr_const = bool(np.all(np.isfinite(Sa))
                                       and np.allclose(Sa, Sb)
                                       and np.allclose(Ka, Kb))
        return self._lqr_const

    def _nearest_override(self):
        """The NN for a chunk (None: the plain blocked scan).  The kernels
        need an affine erf: subtract, or at most one wrapped angle dim
        tagged by make_erf.  "auto" on CUDA takes the nn_const kernel for a
        constant lqr, else the nn_general kernel, and the scan for any other
        erf, as the JAX planner does; "auto" on the CPU, and "scan", take
        the scan.  "nn_const" and "nn_general" force that kernel's wrapper
        (its plain version on CPU tensors) and raise ValueError for an erf
        the kernels cannot take."""
        from .ops.kernels.nn_kernel import (make_nearest_const,
                                            make_nearest_general)

        dims = getattr(self.erf, "angle_dims", None)
        if self.erf is torch.subtract:
            dims = ()
        affine = dims is not None and len(dims) <= 1
        if self.nn_impl in ("nn_const", "nn_general") and not affine:
            raise ValueError(
                f"nn_impl={self.nn_impl!r} needs an affine erf with at most "
                "one wrapped angle dim (torch.subtract, or build it with "
                "ops.angles.make_erf)")
        if (self.nn_impl == "scan" or not affine
                or (self.nn_impl == "auto" and self.device.type == "cpu")):
            self.nn_selected = "scan"
            return None
        wrap_dim = dims[0] if dims else None
        const = self._lqr_is_constant()
        if self.nn_impl == "nn_const" and not const:
            raise ValueError("nn_impl='nn_const' needs a constant lqr (one S "
                             "for the whole tree); this lqr varies with the "
                             "state: use 'nn_general'")
        if self.nn_impl == "nn_const" or (self.nn_impl == "auto" and const):
            self.nn_selected = "nn_const"
            return make_nearest_const(wrap_dim)
        self.nn_selected = "nn_general"
        return make_nearest_general(wrap_dim)

    def _seed(self, x0, goal):
        """(S0, K0, in_goal0, goal_cost0) at x0, all on the device."""
        S0, K0 = self.lqr(x0, torch.zeros(self.ncontrols, device=self.device))
        e0 = self.erf(goal, x0)
        gbuf = self._tensor(self.constraints.goal_buffer)
        in_goal0 = (e0.abs() <= gbuf).all()
        return S0, K0, in_goal0, e0 @ S0 @ e0

    def _seed_tree(self, x0, goal) -> TreeArrays:
        S0, K0, in_goal0, g0 = self._seed(x0, goal)
        return init_tree(self.capacity, self.horizon_steps, self.nstates,
                         self.ncontrols, x0, S0, K0, g0, in_goal0,
                         slack=self.slack, root_pad=self.root_pad)

    def _load_feasibility_data(self):
        """Copy the constraints' feasibility_data into this planner's device
        tensors of its signature (structure, shapes, dtypes): made at the
        first replan with that signature, then updated in place, so an
        update of values changes no tensor address and builds no chunk."""
        data = self.constraints.feasibility_data
        if data is None:
            self._feas_sig = None
            return
        host = _tree_map(_host_leaf, data)
        sig = _signature(host)
        if sig in self._feas_bufs:
            _tree_map(lambda b, a: b.copy_(a), self._feas_bufs[sig], host)
        else:
            self._feas_bufs[sig] = _tree_map(
                lambda a: a.to(self.device, copy=True), host)
        self._feas_sig = sig

    def _feasibility(self):
        """The 2-arg predicate of chunks and steers: the user's, or the
        user's 3-arg one reading this planner's data tensors, bound at
        build time and read at every call (JAX: a traced argument)."""
        user = self.constraints.is_feasible
        if self._feas_sig is None:
            return user
        data = self._feas_bufs[self._feas_sig]
        return lambda x, u: user(x, u, data)

    def _get_steer(self, steps: Optional[int] = None):
        """Steer without the goal stop (prune, finish), cached per
        horizon."""
        steps = self.horizon_steps if steps is None else steps
        key = (steps, self.constraints._feasibility_version, self._feas_sig)
        if key not in self._steer_cache:
            self._steer_cache[key] = make_steer(
                self.dynamics, self.erf, self._feasibility(), steps,
                self.dt, self.error_tol, saturate=self.saturate)
        return self._steer_cache[key]

    def _pool_fn(self):
        """pool(t, best) -> (_FPR_PLAN_LEN, n) states spread evenly along
        the best node's root chain (the informed-restart pool)."""
        D, P, H = self._POOL_DEPTH, _FPR_PLAN_LEN, self.horizon_steps
        dev = self.device
        ar_h = torch.arange(H, device=dev)
        ar_p = torch.arange(P, device=dev)

        def pool(t, best):
            ids = _walk(t.parent, best, D)                  # leaf first
            safe = torch.clamp(ids, 0, t.state.shape[0] - 1)
            ex = t.edge_x[:, :, safe].permute(2, 0, 1)      # (D, H, n)
            el = t.edge_len[safe]
            mask = (ar_h[None, :] < el[:, None]) & (ids >= 0)[:, None]
            flat = ex.reshape(D * H, -1)
            cs = torch.cumsum(mask.reshape(D * H), 0)
            total = torch.clamp(cs[-1], min=1)
            want = (ar_p * total) // P + 1
            pos = torch.searchsorted(cs, want)
            return flat[torch.clamp(pos, 0, D * H - 1)]

        return pool

    def _sampler(self, xrand_gen, n_fpr: int, informed_on: bool):
        """draw(pool, frac, ss, gb, bt, prev_plan, nb=batch_size) -> (nb, n)
        candidates: ``xrand_gen(gen, nb)`` when given; else ``sample_batch``
        whose first frac * rows come, when ``informed_on``, from the
        informed pool plus noise; with FPR, min(n_fpr, nb - 1) rows of
        ``prev_plan`` lead the batch (the refine round draws half
        batches)."""
        B = self.batch_size
        inf_scale = 0.05          # fixed: annealing is measured-harmful
        gen, dev = self._gen, self.device
        wrap_dims = list(self.wrap_dims)
        ar_b = torch.arange(B, device=dev)

        def base_sample(nb, pool_c, frac, ss, gb, bt):
            fresh = sample_batch(gen, nb, ss, gb, bt)
            if not informed_on:
                return fresh
            # informed mixing: the first frac*nb rows come from the
            # incumbent-plan pool plus noise (inert while frac == 0)
            r = torch.randint(0, pool_c.shape[0], (nb,), generator=gen,
                              device=dev)
            scale = (ss[:, 1] - ss[:, 0]) * inf_scale
            noisy = pool_c[r] + torch.randn(fresh.shape, generator=gen,
                                            device=dev) * scale
            for d in wrap_dims:
                noisy[:, d] = wrap_angle(noisy[:, d])
            noisy = torch.clamp(noisy, ss[:, 0], ss[:, 1])
            take = ar_b[:nb] < frac * nb
            return torch.where(take[:, None], noisy, fresh)

        def draw(pool_c, frac, ss, gb, bt, prev_plan, nb=B):
            if xrand_gen is not None:
                return xrand_gen(gen, nb)
            if n_fpr > 0:
                n_take = min(n_fpr, nb - 1)
                fresh = base_sample(nb - n_take, pool_c, frac, ss, gb, bt)
                rows = torch.randint(0, prev_plan.shape[0], (n_take,),
                                     generator=gen, device=dev)
                return torch.cat([prev_plan[rows], fresh], 0)
            return base_sample(nb, pool_c, frac, ss, gb, bt)

        return draw

    def _expand(self, spec: RoundSpec):
        return make_expand(spec, self.dynamics, self.lqr, self.erf,
                           self._feasibility(), self.error_tol,
                           self.constraints.goal_buffer,
                           wrap_mask=self._wrap_mask(),
                           saturate=self.saturate,
                           nearest_fn=self._nearest_override())

    def _spec(self) -> RoundSpec:
        return RoundSpec(
            nstates=self.nstates, ncontrols=self.ncontrols,
            batch=self.batch_size, horizon_steps=self.horizon_steps,
            capacity=self.capacity, dt=self.dt, nn_block=self.nn_block,
            slack=self.slack)

    # ------------------------------------------------- grow / refine chunk

    def _get_chunk(self, xrand_gen, n_fpr: int, commit: str = "grow"):
        """The host loop's chunk: ``rounds_per_chunk`` rounds on one tree,
        then its stats (``_chunk_stats``).  ``commit="grow"`` appends a
        batch a round; ``commit="refine"`` runs the full tree's round,
        ``core.rounds.make_refine_round`` fed by the planner's sampler:
        ``half = max(batch // 2, 1)`` candidates replace leaves, then
        ``batch - half`` targets are rewired, the window's start drawn from
        the planner's generator.

        chunk(tree, goal, sample_space, goal_bias, bias_target,
              prev_plan=None) updates ``tree`` IN PLACE and returns the stats
        tensor.  The informed pool stays inert on this path (the JAX host
        loop refreshes it only in its restart stash, which needs a
        feasibility_grid), so every row not taken by FPR is a fresh
        sample.  The cache key holds ``commit`` at index 3, as the JAX
        planner's."""
        key = (self.constraints._feasibility_version, xrand_gen, n_fpr,
               commit, self._feas_sig)
        if key in self._chunk_cache:
            return self._chunk_cache[key]
        spec = self._spec()
        draw = self._sampler(xrand_gen, n_fpr, informed_on=False)
        n_inner = self.rounds_per_chunk
        if commit == "refine":
            refine_round = make_refine_round(
                spec, self.dynamics, self.lqr, self.erf, self._feasibility(),
                self.error_tol, self.constraints.goal_buffer,
                wrap_mask=self._wrap_mask(), saturate=self.saturate,
                nearest_fn=self._nearest_override(),
                draw=lambda gen, nb, ss, gb, bt, prev_plan: draw(
                    None, 0.0, ss, gb, bt, prev_plan, nb))

            def one_round(tree, goal, ss, gb, bt, prev_plan):
                refine_round(tree, self._gen, goal, ss, gb, bt, prev_plan)
        else:
            expand = self._expand(spec)

            def one_round(tree, goal, ss, gb, bt, prev_plan):
                xrand = draw(None, 0.0, ss, gb, bt, prev_plan)
                commit_candidates(spec, tree, expand(tree, xrand, goal))

        def chunk(tree, goal, ss, gb, bt, prev_plan=None):
            for _ in range(n_inner):
                one_round(tree, goal, ss, gb, bt, prev_plan)
            return _chunk_stats(tree)

        self._chunk_cache[key] = chunk
        return chunk

    # ------------------------------------------------------- restart chunk

    def _get_restart_chunk(self, xrand_gen, n_fpr: int):
        """The fused-restart chunk.  With the dense commit-all, a fresh
        tree grows by exactly ``batch`` rows a round, so it fills after
        F = ceil((capacity - root_pad) / batch) rounds, a static number; a
        chunk runs ``n_cycles`` cycles of [F grow rounds -> stash-compare ->
        reseed] with no data-dependent control flow.

        chunk(cur, best, pool, score, start, goal, sample_space, goal_bias,
              bias_target, prev_plan) updates its first four arguments IN
        PLACE; ``score`` has the layout of _RSCORE0.  ``xrand_gen(gen,
        batch)`` replaces the sampler; ``prev_plan`` feeds FPR."""
        key = (self.constraints._feasibility_version, xrand_gen, n_fpr,
               "restart", self._feas_sig)
        if key in self._chunk_cache:
            return self._chunk_cache[key]

        spec = self._spec()
        F = -(-(self.capacity - self.root_pad) // self.batch_size)
        n_cycles = max(1, self.rounds_per_chunk // F)
        self._restart_chunk_shape = (n_cycles, F)
        expand = self._expand(spec)
        informed_on = xrand_gen is None and self.informed > 0.0
        draw = self._sampler(xrand_gen, n_fpr, informed_on)
        inf_frac = float(self.informed)
        pool_fn = self._pool_fn()
        DP = 32                   # planted-prefix cap (static)
        seed_size = max(self.root_pad, 1)
        ar_dp = torch.arange(DP, device=self.device)

        def chunk(cur, best, pool, score, start, goal, ss, gb, bt,
                  prev_plan=None):
            for c in range(n_cycles):
                # informed fraction from the CURRENT incumbent
                frac = (torch.where((score[0] > 0.5) & (score[1] < 0.5),
                                    inf_frac, 0.0) if informed_on else 0.0)
                for _ in range(F):
                    xrand = draw(pool, frac, ss, gb, bt, prev_plan)
                    commit_candidates(spec, cur, expand(cur, xrand, goal))
                # ---- stash-compare (goal first, then time | cost) ----
                b = best_node(cur)
                gf = cur.goal_found
                s1 = 1.0 - gf.float()
                s2 = torch.where(gf, _at(cur.node_time, b),
                                 _at(cur.goal_cost, b))
                improved = ((score[0] < 0.5) | (s1 < score[1])
                            | ((s1 == score[1]) & (s2 < score[2])))
                live = (((cur.edge_len >= 1) & cur.valid_mask()).sum()
                        + 1).float()
                for cu, be in zip(cur, best):
                    torch.where(improved, cu, be, out=be)
                new_sc = torch.stack([
                    torch.clamp(score[0], min=1.0),
                    torch.where(improved, s1, score[1]),
                    torch.where(improved, s2, score[2]),
                    torch.where(improved, live, score[3]),
                    torch.maximum(score[4], gf.float()),
                    torch.where(improved, b.float(), score[5])])
                if informed_on:
                    torch.where(improved & gf, pool_fn(cur, b), pool,
                                out=pool)
                score.copy_(new_sc)
                self._reseed(cur, best, score, start // F + c, DP, ar_dp,
                             seed_size)

        self._chunk_cache[key] = chunk
        return chunk

    @staticmethod
    def _reseed(cur, best, score, gcyc: int, DP: int, ar_dp, seed_size):
        """Reseed ``cur`` in place (row 0, the root, is never overwritten by
        commits).  Before any goal: plant the stash's best root-first chain
        every cycle.  After a goal: alternate bare reseeds with planted
        ones, and among planted cycles full-chain and half-chain plants
        (the JAX planner's depth-planting policy, round 5)."""
        no_goal_ever = score[4] < 0.5
        rev = _walk(best.parent, score[5].long(), DP)      # leaf first
        L = (rev >= 0).sum()
        # a chain deeper than DP never reaches the root within the walk:
        # planting it would root the tree mid-state, so reseed bare
        deeper = (L == DP) & (_at(best.parent,
                                  torch.clamp(rev[DP - 1], min=0)) >= 0)
        do_plant = ~deeper & (no_goal_ever | (gcyc % 2 == 1))
        Lp = torch.where(no_goal_ever | (gcyc % 4 == 1), L,
                         torch.clamp((L + 1) // 2, min=1))
        idx = torch.clamp(Lp - 1 - ar_dp, 0, DP - 1)
        rows = torch.clamp(rev[idx + (L - Lp)], min=0)      # root first
        take = do_plant & (ar_dp < Lp)
        # rows not taken copy row 0, the inert root
        rows = torch.where(take, rows, 0)
        cur.state[:DP] = best.state[rows]
        cur.S[:DP] = best.S[rows]
        cur.K[:DP] = best.K[rows]
        cur.parent[:DP] = torch.where(take, ar_dp - 1, -1)
        cur.edge_x[:, :, :DP] = best.edge_x[:, :, rows]
        cur.edge_u[:, :, :DP] = best.edge_u[:, :, rows]
        cur.edge_len[:DP] = best.edge_len[rows]
        cur.node_time[:DP] = best.node_time[rows]
        cur.in_goal[:DP] = best.in_goal[rows]
        cur.goal_cost[:DP] = best.goal_cost[rows]
        cur.n_children.zero_()
        cur.n_children[:DP] = take & (ar_dp < Lp - 1)
        cur.size.copy_(torch.clamp(
            torch.where(do_plant, torch.clamp(Lp, max=DP), 1),
            min=seed_size))
        cur.goal_found.copy_(best.in_goal[0]
                             | (take & best.in_goal[rows]).any())

    # ---------------------------------------------------------------- warmup

    def warmup(self, x0, sample_space, goal_bias=0, guide=None,
               xrand_gen: Callable = None, pruning: bool = True):
        """Run one tiny replan (specific_time=0.05) outside any timed
        budget, so every callback has met the device and every path
        update_plan takes (chunk, extraction, pruning steer) has run once;
        the plan state is left as that replan's."""
        self.update_plan(x0, sample_space, goal_bias=goal_bias, guide=guide,
                         xrand_gen=xrand_gen, pruning=pruning,
                         specific_time=0.05)

    # ------------------------------------------------------------ update_plan

    def update_plan(self, x0, sample_space, goal_bias=0, guide=None,
                    xrand_gen: Callable = None, pruning: bool = True,
                    finish_on_goal: bool = False,
                    specific_time: Optional[float] = None) -> bool:
        """Grow trees from x0 until the time budget expires, then commit the
        best branch as the plan.  Returns True iff a goal was reached."""
        if self.goal is None:
            raise RuntimeError("goal not set; call set_goal or pass goal0")
        self._check_ported()
        self.unkill()
        x0 = self._tensor(x0)
        if x0.shape != (self.nstates,):
            raise ValueError(f"x0 must have shape ({self.nstates},)")
        sample_space = self._tensor(sample_space).reshape(self.nstates, 2)
        goal_bias = normalize_goal_bias(goal_bias, self.nstates, self.device)
        bias_target = self.goal if guide is None else self._tensor(guide)
        if specific_time is not None:
            t_min = t_max = float(specific_time)
        else:
            t_min, t_max = self.min_time, self.max_time
        # FPR warm-start pool: the previous plan, or a straight x0 -> goal
        # ramp before the first plan
        n_fpr, prev_plan = 0, None
        if self.FPR > 0.0:
            n_fpr = max(int(round(self.FPR * self.batch_size)), 1)
            if self.x_seq is not None and len(self.x_seq) > 1:
                idx = np.linspace(0, len(self.x_seq) - 1, _FPR_PLAN_LEN)
                plan = np.asarray(self.x_seq)[idx.astype(int)]
            else:
                plan = np.linspace(x0.cpu().numpy(), self.goal.cpu().numpy(),
                                   _FPR_PLAN_LEN, dtype=np.float32)
            prev_plan = self._tensor(plan)
        self._load_feasibility_data()
        loop = (self._run_restart_loop
                if (self.refine and self.refine_mode == "restart"
                    and self.max_nodes >= self.capacity)
                else self._run_host_loop)
        return loop(x0, sample_space, goal_bias, bias_target, t_min, t_max,
                    xrand_gen, n_fpr, prev_plan, pruning, finish_on_goal)

    def _fetch_async(self, t: torch.Tensor, buf: torch.Tensor):
        """Copy ``t`` into host ``buf`` without waiting; returns the event
        to wait on (None on the CPU, where the copy is done)."""
        if self.device.type != "cuda":
            buf.copy_(t)
            return None
        buf.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def _fetched(pending) -> np.ndarray:
        """The host copy of a stats vector, once its copy has landed."""
        buf, ev = pending
        if ev is not None:
            ev.synchronize()
        return buf.numpy().copy()

    def _stats_buffers(self):
        pin = self.device.type == "cuda"
        return [torch.empty(6, pin_memory=pin) for _ in range(2)]

    def _run_restart_loop(self, x0, sample_space, goal_bias, bias_target,
                          t_min, t_max, xrand_gen, n_fpr, prev_plan,
                          pruning, finish_on_goal) -> bool:
        """Anytime loop over fused-restart chunks: the host dispatches
        chunks and reads the previous chunk's stats (a non-blocking copy
        into pinned memory plus an event), one chunk stale."""
        chunk_fn = self._get_restart_chunk(xrand_gen, n_fpr)
        n_cycles, F = self._restart_chunk_shape
        cur = self._seed_tree(x0, self.goal)
        best = self._seed_tree(x0, self.goal)
        pool = self._tensor(np.linspace(x0.cpu().numpy(),
                                        self.goal.cpu().numpy(),
                                        _FPR_PLAN_LEN, dtype=np.float32))
        score = self._tensor(self._RSCORE0)
        bufs = self._stats_buffers()
        t0 = self.sys_time()
        rounds = restarts = 0
        any_goal = False
        pending = None
        if self.printing:
            print(f"[lqrrt] planning: budget [{t_min}, {t_max}]s, "
                  f"batch {self.batch_size} x {n_cycles}x{F} "
                  f"rounds/chunk (fused restarts), "
                  f"capacity {self.capacity}")
        while True:
            elapsed = self.sys_time() - t0
            if self._killed:
                if self.printing:
                    print("[lqrrt] killed; salvaging best-so-far")
                break
            if elapsed >= t_max:
                break
            if any_goal and elapsed >= t_min:
                break
            chunk_fn(cur, best, pool, score, rounds, self.goal,
                     sample_space, goal_bias, bias_target, prev_plan)
            buf = bufs[(rounds // (n_cycles * F)) % 2]
            ev = self._fetch_async(score, buf)
            rounds += n_cycles * F
            restarts += n_cycles
            if pending is not None:   # the previous chunk's stats
                any_goal = bool(self._fetched(pending)[4] > 0.5)
            pending = (buf, ev)
        st = (self._fetched(pending) if pending is not None
              else np.asarray(self._RSCORE0, np.float32))
        elapsed = self.sys_time() - t0
        return self._commit_plan(
            best, int(st[5]), bool(st[4] > 0.5), n_live=int(st[3]),
            tree_rows=(self.capacity if st[0] > 0.5 else 1), rounds=rounds,
            restarts=restarts, elapsed=elapsed, t0=t0, pruning=pruning,
            finish_on_goal=finish_on_goal)

    def _run_host_loop(self, x0, sample_space, goal_bias, bias_target,
                       t_min, t_max, xrand_gen, n_fpr, prev_plan, pruning,
                       finish_on_goal) -> bool:
        """Anytime loop over chunks on one tree (``refine=False``,
        ``max_nodes`` below the capacity, or ``leaf_rewire``): stops at
        min(max_nodes, capacity) rows, at the budget, or at the goal after
        ``t_min``, on stats one chunk stale, so ``max_nodes`` holds at chunk
        granularity.  With ``leaf_rewire``, ``refine=True`` and the stop at
        the capacity, a full tree swaps in the refine chunk and carries on
        (no reseed, no restart), as the JAX host loop does."""
        chunk_fn = self._get_chunk(xrand_gen, n_fpr)
        tree = self._seed_tree(x0, self.goal)
        node_cap = min(self.max_nodes, self.capacity)
        rewire_on = (self.refine and self.refine_mode == "leaf_rewire"
                     and node_cap >= self.capacity)
        bufs = self._stats_buffers()
        t0 = self.sys_time()
        rounds = 0
        size, goal_found, n_live = 1, False, 1
        pending = None
        if self.printing:
            print(f"[lqrrt] planning: budget [{t_min}, {t_max}]s, "
                  f"batch {self.batch_size} x {self.rounds_per_chunk} "
                  f"rounds/chunk, capacity {self.capacity}")
        while True:
            elapsed = self.sys_time() - t0
            if self._killed:
                if self.printing:
                    print("[lqrrt] killed; salvaging best-so-far")
                break
            if size >= node_cap:
                if not rewire_on:
                    break
                chunk_fn = self._get_chunk(xrand_gen, n_fpr, commit="refine")
            if elapsed >= t_max:
                break
            if goal_found and elapsed >= t_min:
                break
            stats = chunk_fn(tree, self.goal, sample_space, goal_bias,
                             bias_target, prev_plan)
            buf = bufs[(rounds // self.rounds_per_chunk) % 2]
            ev = self._fetch_async(stats, buf)
            rounds += self.rounds_per_chunk
            if pending is not None:   # the previous chunk's stats
                st = self._fetched(pending)
                size, goal_found, n_live = (int(st[0]), bool(st[1] > 0.5),
                                            int(st[5]))
            pending = (buf, ev)
        if pending is not None:
            st = self._fetched(pending)
            size, goal_found, n_live = (int(st[0]), bool(st[1] > 0.5),
                                        int(st[5]))
        elapsed = self.sys_time() - t0
        return self._commit_plan(
            tree, int(best_node(tree)), goal_found, n_live=n_live,
            tree_rows=size, rounds=rounds, restarts=0, elapsed=elapsed,
            t0=t0, pruning=pruning, finish_on_goal=finish_on_goal)

    def _commit_plan(self, tree, best_id: int, goal_reached: bool, *,
                     n_live, tree_rows, rounds, restarts, elapsed, t0,
                     pruning, finish_on_goal) -> bool:
        """Extract the best branch of ``tree``, prune it, finish it on the
        goal if asked, swap it in as the plan and fill ``stats``."""
        self._device_tree = tree
        self.tree = None                  # the host snapshot is stale
        t_post = self.sys_time()
        x_seq, u_seq = self._extract(tree, best_id)
        t_extract = self.sys_time() - t_post
        t_p = self.sys_time()
        if pruning and len(x_seq) > 2:
            x_seq, u_seq = self._prune(x_seq, u_seq)
        t_prune = self.sys_time() - t_p
        t_f = self.sys_time()
        if finish_on_goal and goal_reached:
            x_seq, u_seq = self._finish_on_goal(x_seq, u_seq)
        t_finish = self.sys_time() - t_f

        x_seq = np.asarray(x_seq, np.float32)
        u_seq = np.asarray(u_seq, np.float32)
        self._plan = (x_seq, u_seq, self.dt * (len(x_seq) - 1))  # atomic
        self.plan_reached_goal = goal_reached
        self.stats = dict(
            nodes=n_live, tree_rows=tree_rows,
            rounds=rounds, restarts=restarts, elapsed_s=elapsed,
            expansions=rounds * self.batch_size,
            expansions_per_s=rounds * self.batch_size / max(elapsed, 1e-9),
            goal_found=goal_reached, plan_steps=len(self.x_seq),
            plan_duration_s=self.T,
            overhead_extract_s=t_extract, overhead_prune_s=t_prune,
            overhead_finish_s=t_finish,
            overhead_total_s=self.sys_time() - t_post,
            total_s=self.sys_time() - t0)
        if self.printing:
            print(f"[lqrrt] done: {n_live} nodes, "
                  f"{rounds} rounds in {elapsed:.3f}s "
                  f"({self.stats['expansions_per_s']:.0f} expansions/s), "
                  f"goal={'yes' if goal_reached else 'no'}")
        if self.on_replan is not None:
            self.on_replan(dict(self.stats))
        return goal_reached

    # ------------------------------------------------- extraction & smoothing

    def _gather_chain(self, tree: TreeArrays, ids: torch.Tensor):
        """Host copies of (states, gains, edge_x (C, H, n), edge_u,
        edge_len) along chain ``ids``."""
        safe = torch.clamp(ids, 0, tree.state.shape[0] - 1)
        out = (tree.state[safe], tree.K[safe],
               tree.edge_x[:, :, safe].permute(2, 0, 1),
               tree.edge_u[:, :, safe].permute(2, 0, 1),
               tree.edge_len[safe])
        return tuple(t.cpu().numpy() for t in out)

    def _concat_edges(self, chain, states, gains, edge_x, edge_u, edge_len):
        self._last_chain = [int(i) for i in chain]
        self._last_edges = (states, gains, edge_x, edge_u, edge_len)
        xs = [states[0][None, :]]
        us = []
        for i in range(1, len(chain)):
            ln = int(edge_len[i])
            xs.append(edge_x[i][:ln])
            us.append(edge_u[i][:ln])
        x_seq = np.concatenate(xs, axis=0)
        u_seq = (np.concatenate(us, axis=0) if us
                 else np.zeros((0, self.ncontrols), np.float32))
        return x_seq, u_seq

    def _extract(self, tree: TreeArrays, best: int):
        """Climb best -> root on the device (a fixed-depth walk) and
        concatenate the trimmed edge rollouts; deeper chains fall back to
        the host walk."""
        start = torch.tensor(best, device=self.device)
        ids = _walk(tree.parent, start, self._EXTRACT_DEPTH).flip(0)
        states, gains, edge_x, edge_u, edge_len = self._gather_chain(tree,
                                                                     ids)
        ids = ids.cpu().numpy()
        sel = np.flatnonzero(ids >= 0)
        if len(sel) == 0 or ids[sel[0]] != 0:
            return self._extract_host(tree, best)   # deeper than the walk
        return self._concat_edges(ids[sel], states[sel], gains[sel],
                                  edge_x[sel], edge_u[sel], edge_len[sel])

    def _extract_host(self, tree: TreeArrays, best: int):
        """Host-walk extraction for chains of any depth."""
        parent = tree.parent.cpu().numpy()
        chain = []
        i = best
        while i != -1:
            chain.append(i)
            i = int(parent[i])
        chain = chain[::-1]
        ids = torch.tensor(chain, dtype=torch.int64, device=self.device)
        return self._concat_edges(chain, *self._gather_chain(tree, ids))

    def _prune(self, x_seq, u_seq):
        """Shortcut pass: one batched steer over every (source, target)
        pair of the first _PRUNE_MAX chain nodes, then a greedy
        furthest-reachable pick on the host; accepted only if shorter."""
        states, gains, edge_x, edge_u, edge_len = self._last_edges
        L = len(states)
        if L <= 3:
            return x_seq, u_seq
        M = _PRUNE_MAX
        W = min(L, M)
        src = np.zeros((M, self.nstates), np.float32)
        src[:W] = states[:W]
        gns = np.zeros((M,) + gains.shape[1:], np.float32)
        gns[:W] = gains[:W]
        res = self._get_steer()(self._tensor(np.repeat(src, M, axis=0)),
                                self._tensor(np.repeat(gns, M, axis=0)),
                                self._tensor(np.tile(src, (M, 1))))
        reached = res.reached.cpu().numpy().reshape(M, M)
        length = res.length.cpu().numpy().reshape(M, M)

        segs = []          # (kind, i, j): "steer" uses res, "edge" original
        i = 0
        while i < W - 1:
            js = [j for j in range(W - 1, i + 1, -1)
                  if reached[i, j] and length[i, j] >= 1]
            if js:
                j = js[0]
                segs.append(("steer", i, j))
            else:
                j = i + 1
                segs.append(("edge", i, j))
            i = j
        for j in range(W, L):
            segs.append(("edge", j - 1, j))
        steer_pairs = [(i, j) for kind, i, j in segs if kind == "steer"]
        if not steer_pairs:
            return x_seq, u_seq
        flat = torch.tensor([i * M + j for i, j in steer_pairs],
                            device=self.device)
        sx = res.x_seq[:, :, flat].permute(2, 0, 1).cpu().numpy()
        su = res.u_seq[:, :, flat].permute(2, 0, 1).cpu().numpy()
        sl = {p: k for k, p in enumerate(steer_pairs)}
        xs = [states[0][None, :]]
        us = []
        for kind, i, j in segs:
            if kind == "steer":
                k = sl[(i, j)]
                ln = int(length[i, j])
                xs.append(sx[k][:ln])
                us.append(su[k][:ln])
            else:
                ln = int(edge_len[j])
                xs.append(edge_x[j][:ln])
                us.append(edge_u[j][:ln])
        x_new = np.concatenate(xs, axis=0)
        u_new = (np.concatenate(us, axis=0) if us
                 else np.zeros((0, self.ncontrols), np.float32))
        if len(x_new) < len(x_seq):
            return x_new, u_new
        return x_seq, u_seq

    def _finish_on_goal(self, x_seq, u_seq):
        """Force a terminal connection to the goal: a 3x-horizon steer from
        the plan's end; if it falls short of error_tol, append its
        best-improving prefix under the goal's S-weighted error."""
        steer = self._get_steer(3 * self.horizon_steps)
        x_last = self._tensor(x_seq[-1])
        Sg, Kg, _, _ = self._seed(x_last, self.goal)
        res = steer(x_last.expand(_FINISH_BATCH, -1).contiguous(),
                    Kg.expand(_FINISH_BATCH, -1, -1).contiguous(),
                    self.goal.expand(_FINISH_BATCH, -1).contiguous())
        xs0 = res.x_seq[:, :, 0]                           # (H, n)
        ln = int(res.length[0])
        if bool(res.reached[0]):
            cut = ln
        elif ln >= 1:
            e = self.erf(self.goal, xs0)
            costs = torch.einsum("ti,ij,tj->t", e, Sg, e).cpu().numpy()[:ln]
            e0 = self.erf(self.goal, x_last)
            cur = float(e0 @ Sg @ e0)
            k = int(np.argmin(costs))
            cut = k + 1 if costs[k] < cur else 0
        else:
            cut = 0
        if cut >= 1:
            fx = xs0.cpu().numpy()[:cut]
            fu = res.u_seq[:, :, 0].cpu().numpy()[:cut]
            x_seq = np.concatenate([x_seq, fx], 0)
            u_seq = np.concatenate([u_seq, fu], 0) if len(u_seq) else fu
        return x_seq, u_seq

    # --------------------------------------------------- controller-facing API

    @property
    def x_seq(self):
        """Committed plan states (P, n); None before the first plan."""
        plan = self._plan
        return None if plan is None else plan[0]

    @property
    def u_seq(self):
        """Committed plan efforts (P-1, m); None before the first plan."""
        plan = self._plan
        return None if plan is None else plan[1]

    @property
    def T(self) -> float:
        """Committed plan duration in seconds (0 before the first plan)."""
        plan = self._plan
        return 0.0 if plan is None else plan[2]

    def get_state(self, t: float):
        """Plan state at time t (s from plan start): linear interpolation,
        endpoint hold outside [0, T], wrap-aware on wrap_dims."""
        plan = self._plan  # single read: consistent even mid-replan-swap
        if plan is None:
            raise RuntimeError("no plan committed; call update_plan first")
        return self._interp(plan[0], t)

    def get_effort(self, t: float):
        """Plan effort at time t: linear interpolation between effort
        samples, endpoint hold outside the plan."""
        plan = self._plan
        if plan is None:
            raise RuntimeError("no plan committed; call update_plan first")
        u_seq = plan[1]
        if len(u_seq) == 0:
            return np.zeros(self.ncontrols, np.float32)
        tau = np.clip(t / self.dt, 0.0, len(u_seq) - 1)
        i = int(np.floor(tau))
        j = min(i + 1, len(u_seq) - 1)
        a = tau - i
        return (1.0 - a) * u_seq[i] + a * u_seq[j]

    def get_tree(self) -> Tree:
        """Host snapshot of the last planning tree (made at the first call
        after each replan)."""
        if self.tree is None:
            if self._device_tree is None:
                raise RuntimeError("no tree; call update_plan first")
            self.tree = Tree.from_device_arrays(self._device_tree)
        return self.tree

    def visualize(self, dx: int = 0, dy: int = 1, ax=None, show: bool = True):
        """matplotlib figure of the tree and the plan on dims (dx, dy)
        (``viz.visualize_planner``)."""
        from .viz import visualize_planner
        return visualize_planner(self, dx, dy, ax=ax, show=show)

    def _interp(self, seq, t: float):
        tau = np.clip(t / self.dt, 0.0, len(seq) - 1)
        i = int(np.floor(tau))
        j = min(i + 1, len(seq) - 1)
        a = tau - i
        out = (1.0 - a) * seq[i] + a * seq[j]
        if self.wrap_dims:
            # interpolate across the +-pi seam via the wrapped delta
            two_pi = 2.0 * np.pi
            for d in self.wrap_dims:
                delta = (seq[j][d] - seq[i][d] + np.pi) % two_pi - np.pi
                ang = seq[i][d] + a * delta
                out[d] = (ang + np.pi) % two_pi - np.pi
        return out
