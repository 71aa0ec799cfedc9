"""Scenario parallelism: many independent planner instances at once (port
of lqrrt_tpu/parallel/fleet.py ``FleetPlanner``).

The BASELINE.json "pod-scale fleet replanning" config: 1k simultaneous boat
scenarios.  Each scenario owns a fixed-capacity tree; the S trees are one
``TreeArrays`` with a leading scenario axis (``core/tree.py``).  A round
(``core/rounds.py`` ``make_fleet_round``) finds each candidate's nearest
node in its own scenario's tree, steers the S × B candidates as ONE batch
of S·B rows, and commits each scenario's rows with the sorted dense commit
(``core/commit.py`` ``commit_batch_dense``).  Scenarios never read each
other's trees.

All scenarios share the model (dynamics, lqr, erf, feasibility); start
states, goals, sample spaces and, with ``per_scenario_data=True``,
obstacle data are per scenario.  The data stays one copy with a leading
scenario axis on the device: the predicate is called on scenario-leading
views of the steered rows, x (S, B, n) and u (S, B, m), with the data
(S, ...), which is JAX's ``vmap`` read literally; ``circles_free_data``
and ``grid_free_data`` take such leading axes, so an (S, H, W) grid is
never copied a row.  One ``torch.Generator`` on the fleet's device draws
every scenario's candidates (JAX splits a key a scenario: the streams
differ, as they do for the ``Planner``).

``mesh=`` (a 1-D mesh, ``parallel.mesh.make_fleet_mesh``) shards the
scenario axis: each rank owns a contiguous block of S / n_dev scenarios,
takes its block of every per-scenario input, and runs its rounds with no
collective, drawing from its own generator (``sharded.rank_generator``).
``plan`` returns the whole fleet's stats on every rank (an all-gather of
each per-scenario array, JAX's multi-process ``_fetch``); the ranks agree
on each chunk's length and on the budget's end over the host's gloo
group; ``extract_plans`` serves the scenarios the rank owns.

Each ``plan`` times itself in named spans on the host clock
(``utils/timing.py`` ``PhaseTimer.span``; ranges on the profiler's
timeline while ``torch.profiler`` runs): ``fleet.plan``, ``fleet.seed``,
each chunk's dispatch (``fleet.chunk``) and the fetch that ends it
(``fleet.chunk_sync``), and the phases of each round (``round.*``); the
dict it returns holds them under ``"spans"``, and the steer's calls by
route (``core.steer.make_routed_steer``: ``steer.kernel``, kernel D on the
card where D's factory takes the problem, else ``steer.scan``) under
``"tallies"``.  ``extract_plans`` times ``fleet.extract`` and its parts,
which ``last_extract_timings`` reports.

Callbacks are batch-leading (see the package docstring).  The device is
explicit: ``device="cuda"`` (the default) raises when CUDA is absent.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ..constraints import host_leaf, tree_map
from ..core.rounds import RoundSpec, make_fleet_round
from ..core.sampling import sample_batch
from ..core.tree import TreeArrays, best_node, init_tree
from ..utils.timing import PhaseTimer
from . import mesh as meshlib


class FleetPlanner:
    """A fleet of planners over a scenario axis, on one device.

    A throughput-oriented API: one ``plan(...)`` call grows every
    scenario's tree for a number of rounds (or until a wall-clock budget)
    and returns per-scenario results; ``extract_plans`` returns each
    scenario's best plan.
    """

    _MAX_DEPTH = 128   # chain-walk cap for the batched extraction

    def __init__(self, dynamics: Callable, lqr: Callable, erf: Callable,
                 is_feasible: Callable, goal_buffer, horizon: float,
                 dt: float = 0.05, error_tol=0.05, *,
                 n_scenarios: int, batch_size: int = 256,
                 capacity: int = 4096, nn_block: int = 1024,
                 saturate: Optional[Callable] = None, wrap_dims=(),
                 mesh=None, axis: str = "scenario",
                 seed: int = 0, ncontrols: Optional[int] = None,
                 sys_time: Callable = None, per_scenario_data: bool = False,
                 device="cuda"):
        """``per_scenario_data=True``: ``is_feasible(x, u, data)`` is 3-arg
        and ``plan(..., feasibility_data=tree)`` gives each scenario its own
        obstacle data (every leaf's leading axis is the scenario); the
        predicate sees x (S, B, n) and u (S, B, m) with that data."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but CUDA is not available; "
                               "pass device='cpu' to run on the CPU")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        # the JAX package computes the metric at Precision.HIGHEST
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.n_scenarios = int(n_scenarios)
        self._n_local, self._offset = self.n_scenarios, 0
        if mesh is not None:
            meshlib.check_device(mesh, self.device)
            n_dev = meshlib.axis_size(mesh, axis)
            if self.n_scenarios % n_dev != 0:
                raise ValueError(
                    f"n_scenarios={self.n_scenarios} is not divisible by the "
                    f"mesh '{axis}' axis size {n_dev}")
            self._n_local = self.n_scenarios // n_dev
            self._offset = meshlib.axis_index(mesh, axis) * self._n_local
        self.per_scenario_data = bool(per_scenario_data)
        self.dt = float(dt)
        self.horizon_steps = max(int(round(horizon / dt)), 1)
        self.nstates = None  # resolved at plan() from x0 shape
        self.ncontrols = None if ncontrols is None else int(ncontrols)
        self.goal_buffer = np.asarray(goal_buffer, np.float32)
        self.mesh = mesh
        self.axis = axis
        if mesh is None:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int(seed))
        else:
            from .sharded import rank_generator
            self._gen = rank_generator(seed, mesh, axis, self.device)
        self.sys_time = sys_time if sys_time is not None else time.time
        self.spec = RoundSpec(
            nstates=-1, ncontrols=-1, batch=int(batch_size),
            horizon_steps=self.horizon_steps, capacity=int(capacity),
            dt=self.dt, nn_block=int(nn_block))
        self._mk = dict(dynamics=dynamics, lqr=lqr, erf=erf,
                        is_feasible=is_feasible, error_tol=error_tol,
                        saturate=saturate, wrap_dims=tuple(wrap_dims))
        self._round = None
        # this rank's per-scenario data (S, ...), in a box the round's
        # predicate reads: the round holds no reference to the fleet, so
        # a dropped fleet frees its trees without waiting for the cycle
        # collector
        self._data_box = [None]
        self.trees: Optional[TreeArrays] = None  # scenario-leading
        self._spans = PhaseTimer()      # reset at each plan
        self.last_extract_timings = None

    def _tensor(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _build(self, nstates: int, ncontrols: int):
        blk = min(self.spec.nn_block, self.spec.capacity)
        slack = -(-self.spec.batch // blk) * blk  # dense-commit spare rows
        self.spec = self.spec._replace(nstates=nstates, ncontrols=ncontrols,
                                       slack=slack)
        self.nstates = nstates
        wrap_mask = None
        if self._mk["wrap_dims"]:
            wrap_mask = np.zeros(nstates, bool)
            wrap_mask[list(self._mk["wrap_dims"])] = True
        feas = user_feas = self._mk["is_feasible"]
        if self.per_scenario_data:
            n_sc, box = self._n_local, self._data_box

            def feas(x, u):
                # the steered rows are scenario-major: (S·B, .) -> (S, B, .)
                ok = user_feas(x.reshape(n_sc, -1, x.shape[-1]),
                               u.reshape(n_sc, -1, u.shape[-1]), box[0])
                return ok.reshape(x.shape[:-1])
        self._round = make_fleet_round(
            self.spec, self._mk["dynamics"], self._mk["lqr"],
            self._mk["erf"], feas, self._mk["error_tol"], self.goal_buffer,
            wrap_mask=wrap_mask, saturate=self._mk["saturate"],
            spans=self._spans)

    def _seed(self, x0s, goals) -> TreeArrays:
        """Every scenario's tree seeded at its x0: (S0, K0) = lqr(x0, 0),
        the goal box test and e' S0 e toward its goal."""
        n_sc, n = x0s.shape
        m = self.spec.ncontrols
        S0, K0 = self._mk["lqr"](
            x0s, torch.zeros((n_sc, m), device=self.device))
        e0 = self._mk["erf"](goals, x0s)
        gbuf = self._tensor(self.goal_buffer)
        in_goal0 = (e0.abs() <= gbuf).all(-1)
        g0 = ((e0[:, None, :] @ S0) @ e0[:, :, None])[:, 0, 0]
        return init_tree(self.spec.capacity, self.spec.horizon_steps, n, m,
                         x0s, S0, K0, g0, in_goal0, slack=self.spec.slack)

    def _local(self, t):
        """This rank's block of a per-scenario array (the whole of it
        without a mesh)."""
        return t[self._offset:self._offset + self._n_local]

    def _data_leaf(self, a) -> torch.Tensor:
        """One per-scenario data leaf (S, ...) -> this rank's block of it,
        one copy on the device."""
        t = host_leaf(a)
        if t.ndim == 0 or t.shape[0] != self.n_scenarios:
            raise ValueError(f"feasibility_data leaves need a leading axis "
                             f"of {self.n_scenarios} scenarios, got "
                             f"{tuple(t.shape)}")
        return self._local(t).to(self.device).contiguous()

    def _run_rounds(self, trees, nrounds: int, sample_spaces, goal_bias,
                    goals, goal_rows):
        """Enqueue ``nrounds`` rounds on the device; nothing here syncs."""
        for _ in range(nrounds):
            with self._spans.span("round.sample"):
                xrand = sample_batch(self._gen, self.spec.batch,
                                     sample_spaces, goal_bias, goals)
            self._round(trees, xrand, goal_rows)

    def plan(self, x0s, goals, sample_spaces, goal_bias, rounds: int = 10,
             max_time: Optional[float] = None, rounds_per_chunk: int = 8,
             feasibility_data=None):
        """Grow all scenario trees; returns a stats dict.

        x0s: (S, n); goals: (S, n); sample_spaces: (S, n, 2) or (n, 2)
        shared; goal_bias: (n,) or a scalar, shared; feasibility_data:
        per-scenario obstacle data, leading axis S (requires
        per_scenario_data=True).

        Budget semantics (anytime, like Planner.update_plan): with
        ``max_time=None``, exactly ``rounds`` rounds run.  With ``max_time``
        set, chunks of up to ``rounds_per_chunk`` rounds run until the
        wall clock (``sys_time``) budget expires or ``rounds`` is reached:
        a 1-round probe chunk while no per-round time is known, and the
        last chunk clamped to the rounds the remaining budget affords at
        the measured per-round time (an average kept on the instance across
        calls, so a warm-up call seeds the first chunk's clamp).  The one
        host fetch a chunk, of ``goal_found``, is also its sync;
        per-scenario time-to-first-goal is recorded at chunk granularity.
        Seeding runs before the timed window.  ``"spans"`` holds the call's
        spans, {name: {count, total_s, self_s, parent}}, and ``"tallies"``
        its steer calls by route, {"steer.kernel" | "steer.scan": count},
        one a round.
        """
        self._spans.reset()
        with self._spans.span("fleet.plan"):
            out = self._plan(x0s, goals, sample_spaces, goal_bias, rounds,
                             max_time, rounds_per_chunk, feasibility_data)
        out["spans"] = self._spans.span_summary()
        out["tallies"] = self._spans.tallies()
        return out

    def _plan(self, x0s, goals, sample_spaces, goal_bias, rounds, max_time,
              rounds_per_chunk, feasibility_data) -> dict:
        sp = self._spans
        x0s = self._tensor(x0s)
        goals = self._tensor(goals)
        n_sc, n = x0s.shape
        if n_sc != self.n_scenarios:
            raise ValueError(f"x0s holds {n_sc} scenarios; the fleet has "
                             f"{self.n_scenarios}")
        sample_spaces = self._tensor(sample_spaces)
        if sample_spaces.ndim == 2:
            sample_spaces = sample_spaces.expand(n_sc, n, 2)
        goal_bias = self._tensor(goal_bias)
        if goal_bias.ndim == 0:
            goal_bias = goal_bias.expand(n)
        if self.per_scenario_data and feasibility_data is None:
            raise ValueError("per_scenario_data=True requires "
                             "feasibility_data=")

        if self._round is None or self.spec.nstates != n:
            m = (self.ncontrols if self.ncontrols is not None
                 else self._infer_ncontrols(x0s[0]))
            self._build(n, m)
        B = self.spec.batch
        x0s, goals, sample_spaces = (self._local(t) for t in (
            x0s, goals, sample_spaces))
        n_sc = self._n_local
        goal_rows = goals[:, None, :].expand(n_sc, B, n).reshape(n_sc * B, n)
        if self.per_scenario_data:
            self._data_box[0] = tree_map(self._data_leaf, feasibility_data)
        self.trees = None            # the last call's trees go before the new
        with sp.span("fleet.seed"):
            trees = self._seed(x0s, goals)
        args = (sample_spaces, goal_bias, goals, goal_rows)

        t0 = self.sys_time()
        goal_time = np.full(self.n_scenarios, np.nan, np.float32)
        if max_time is None:
            with sp.span("fleet.chunk"):
                self._run_rounds(trees, rounds, *args)
            done = rounds
        else:
            done = 0
            per_round_s = getattr(self, "_per_round_s", None)
            while done < rounds:
                remaining_s = max_time - (self.sys_time() - t0)
                nr = min(rounds_per_chunk, rounds - done)
                if per_round_s is None:
                    nr = 1          # probe: bounds the overshoot to a round
                elif remaining_s > 0:
                    afford = max(int(remaining_s / per_round_s), 1)
                    nr = min(nr, afford)
                stop = remaining_s <= 0
                if self.mesh is not None:   # the first rank's clock rules
                    stop, nr = meshlib.agree_first(stop, nr)
                if stop:
                    break
                tc = self.sys_time()
                with sp.span("fleet.chunk"):
                    self._run_rounds(trees, nr, *args)
                with sp.span("fleet.chunk_sync"):
                    found = self._fetch(trees.goal_found)  # syncs the chunk
                dt_chunk = max(self.sys_time() - tc, 1e-6) / nr
                per_round_s = (dt_chunk if per_round_s is None
                               else 0.5 * per_round_s + 0.5 * dt_chunk)
                self._per_round_s = per_round_s
                done += nr
                now = self.sys_time() - t0
                goal_time = np.where(np.isnan(goal_time) & found,
                                     np.float32(now), goal_time)
        with sp.span("fleet.chunk_sync"):
            sizes = self._fetch(trees.size)           # waits for the device
        elapsed = self.sys_time() - t0
        self.trees = trees
        found = self._fetch(trees.goal_found)
        if max_time is None:
            goal_time = np.where(found, np.float32(elapsed), goal_time)
        expansions = done * self.spec.batch * self.n_scenarios
        return dict(
            sizes=sizes,
            goal_found=found,
            rounds=done,
            elapsed_s=elapsed,
            expansions=expansions,
            expansions_per_s=expansions / max(elapsed, 1e-9),
            goal_time_s=goal_time,
        )

    def _fetch(self, x) -> np.ndarray:
        """A per-scenario array on the host: with a mesh, every rank's
        block gathered over the scenario axis (the whole fleet's)."""
        if self.mesh is not None:
            from .sharded import all_gather_tiled
            x = all_gather_tiled(x, meshlib.axis_group(self.mesh, self.axis))
        return x.cpu().numpy()

    def _infer_ncontrols(self, x0):
        # Read K's leading dim from one lqr evaluation.  Re-linearized lqr
        # callbacks that use ``u`` cannot be probed with u=None: those
        # callers must pass ncontrols=.
        try:
            _, K0 = self._mk["lqr"](x0, None)
        except Exception as e:
            raise ValueError(
                "could not infer ncontrols by probing lqr(x0, None) — the "
                "lqr callback appears to use its u argument; pass "
                "ncontrols= to FleetPlanner explicitly") from e
        return int(K0.shape[-2])

    def best_nodes(self) -> np.ndarray:
        """Each scenario's best node, the whole fleet's."""
        return self._fetch(best_node(self.trees))

    def _chains(self) -> torch.Tensor:
        """(S, D) root-first id chains to each scenario's best node, -1
        padded at the front: a fixed-depth parent walk of D = _MAX_DEPTH
        steps, every scenario at once, on the device."""
        parent = self.trees.parent
        cur = best_node(self.trees)
        ids = []
        for _ in range(self._MAX_DEPTH):
            ids.append(cur)
            up = parent.gather(1, cur.clamp(min=0)[:, None])[:, 0]
            cur = torch.where(cur >= 0, up.long(), -1)
        return torch.stack(ids[::-1], 1)

    def _host_prefix(self, s: int, first: int) -> list:
        """The ids above ``first`` to scenario s's root, root first: the
        host finish of a chain deeper than the device walk."""
        parent = self.trees.parent[s - self._offset].cpu().numpy()
        prefix = []
        cur = int(parent[first])
        while cur != -1:
            prefix.append(cur)
            cur = int(parent[cur])
            if len(prefix) > parent.shape[0]:
                raise RuntimeError(
                    f"scenario {s}: parent cycle during extraction")
        prefix.reverse()
        if (prefix[0] if prefix else first) != 0:
            raise RuntimeError(f"scenario {s}: chain does not reach the root")
        return prefix

    def extract_plans(self, scenarios=None):
        """Batched plan extraction: ONE chain walk on the device for every
        scenario, one gather of the chains' states, edges and lengths by
        index, and ONE device->host transfer for every requested scenario.

        Returns {scenario: (P_s, n) x_seq}; ``last_extract_timings`` says
        where the time went (the spans ``fleet.chain_walk``,
        ``fleet.pair_build``, ``fleet.gather_transfer`` and
        ``fleet.host_assembly`` of this call, inside ``fleet.extract``).
        With a mesh, a rank serves the scenarios it owns (all of them by
        default) and raises for another's.
        """
        if self.trees is None:
            raise RuntimeError("no trees; call plan() first")
        sp = self._spans
        with sp.span("fleet.extract"):
            out, nbytes = self._extract(scenarios)
        tm = {f"{k}_s": round(sp.last_s(f"fleet.{k}"), 4)
              for k in ("chain_walk", "pair_build", "gather_transfer")}
        tm["transfer_bytes"] = nbytes
        tm["host_assembly_s"] = round(sp.last_s("fleet.host_assembly"), 4)
        self.last_extract_timings = tm
        return out

    def _extract(self, scenarios):
        """(plans, bytes transferred) of ``extract_plans``."""
        sp = self._spans
        lo, n_loc = self._offset, self._n_local
        req = (list(range(lo, lo + n_loc)) if scenarios is None
               else [int(s) for s in scenarios])
        for s in req:
            if not lo <= s < lo + n_loc:
                raise ValueError(
                    f"scenario {s} lives on rank {s // n_loc} of the mesh's "
                    f"'{self.axis}' axis; this rank owns [{lo}, "
                    f"{lo + n_loc})")
        t = self.trees
        H, n = t.edge_x.shape[1:3]
        with sp.span("fleet.chain_walk"):
            chains = self._chains().cpu().numpy()           # (S, D)
        with sp.span("fleet.pair_build"):
            # each requested row's chain, root first; one deeper than the
            # device walk (its first id not the root) is finished on the
            # host
            ch = chains[np.asarray(req, np.int64) - lo]
            D = ch.shape[1]
            lens = (ch >= 0).sum(1)
            first = ch[np.arange(len(req)), D - lens]
            deep = np.flatnonzero(first != 0)
            if deep.size:
                ids = [ch[r, D - lens[r]:] for r in range(len(req))]
                for r in deep:
                    ids[r] = np.concatenate(
                        [self._host_prefix(req[r], int(first[r])), ids[r]])
                lens = np.array([len(a) for a in ids])
                node = np.concatenate(ids)
            else:
                node = ch[ch >= 0]               # row-major: chain order
            row0 = np.cumsum(lens) - lens        # each row's first pair
            srow = np.repeat(np.asarray(req, np.int64) - lo, lens)
            pos = np.arange(node.size) - np.repeat(row0, lens)
        with sp.span("fleet.gather_transfer"):
            # the chain nodes' states, incoming edges (P, H, n) and
            # lengths by native indexing, packed into one buffer for one
            # transfer
            si = torch.as_tensor(srow, device=self.device)
            ni = torch.as_tensor(node.astype(np.int64), device=self.device)
            P = node.size
            packed = torch.cat([
                t.state[si, ni], t.edge_x[si, :, :, ni].reshape(P, H * n),
                t.edge_len[si, ni].float()[:, None]], 1).cpu().numpy()
            states = packed[:, :n]
            edge_x = packed[:, n:n + H * n].reshape(P, H, n)
            edge_len = packed[:, -1].astype(np.int64)
        with sp.span("fleet.host_assembly"):
            # one boolean-mask flatten of every valid edge step (row order
            # kept), then per-scenario slices
            lens_eff = np.where(pos == 0, 0, edge_len)
            step_mask = np.arange(H)[None, :] < lens_eff[:, None]
            flat = edge_x[step_mask]                         # (steps, n)
            csum = np.concatenate([[0], np.cumsum(lens_eff)])
            out = {}
            for r, s in enumerate(req):
                k = row0[r]
                a, b = csum[k], csum[k + lens[r]]
                out[s] = np.concatenate([states[k][None], flat[a:b]], 0)
        return out, int(packed.nbytes)

    def extract_plan(self, scenario: int):
        """Plan extraction for one scenario (see extract_plans)."""
        return self.extract_plans([scenario])[scenario]
