"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compile the CUDA kernels from ``lqrrt_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), with ``ptxas``'s resource lines; every
   instance of kernels A (n = 1-20), C (n = 1-20 and the one that takes n
   at run time) and E, kernel D's eight (the boat, the car, the
   quadrotor and the double integrator, each with and without a raster in
   its predicate, the five of ``D_REGISTERS`` at their registers) and all
   15 of the stage scaffold's ``stage_kernel`` (F2, F3) without spills;
3. kernel A (nn_const) vs its plain PyTorch version at N = 40960,
   B = 8192 with an fp64 brute-force anchor: the boat's n = 6 (wrap dim 2)
   at sizes 0 to 32768, the root-pad tie at sizes 1024 and 32768, NaN
   state rows inside and past size, n = 4, 12, 16, 17 and 20 wrapped at
   the first and the last dim and unwrapped; id match >= 0.999 at each;
   then the
   wrapper's time with its dispatch and alone, its launch alone, its prep
   alone and the plain version's time;
4. kernel B (block_write) vs its plain version, bit for bit, at C = 6 and
   3 and aligned, unaligned, negative and tail starts; both times, and the
   kernel and ``copy_`` alone in turns with L2 cold and warm
   (``lqrrt_tpu_torch.tools.kernel_times.time_write``);
5. kernel C (nn_general) vs its plain version at N = 40960, B = 8192 for
   n = 4 (wrap dim 2) and n = 12 (wrap dim 5) with random SPD per-node S,
   with an fp64 brute-force anchor, at sizes 0 to 32768 (partial tiles,
   node partitions with no live row); the root-pad tie (id 0, also across
   partitions), NaN S rows inside and past size, a non-symmetric S; both
   times, the wrapper alone and the launch alone; then n = 20 (the last
   template instance) and n = 24 (the run-time instance) at sizes 4097 and
   32768, wrapped at dim 0 and unwrapped;
5b. kernel E (nn_expand) in each cross-term mode (fma, bf16, bf16x3) vs
   its plain version at N = 40960, B = 8192, boat S and boat-scale data,
   sizes 512 / 8704 / 32768, wrap dim 2 and unwrapped: id match, fp64
   excess and an fp64 brute-force anchor against the mode's error bound,
   cost agreement, and the times of the launch alone, the wrapper alone
   and with its dispatch, and the plain version; kernel A's launch alone on
   the same inputs; then kernel E's main path, the experiment's entry point
   ``lqrrt_tpu_torch.tools.exp_nn_hybrid.main`` at full width, with the
   launch counts set to 0 just before and read just after;
5c. kernel D (steer_rollout), flat and tree-gather, vs its plain version
   (``core.steer.make_steer``, after the index gather for the tree) at
   B = 8192, H = 100 on the boat, with its circles and with its raster
   (the grid boat's), on a batch that reaches every branch of the step
   (goal stop, infeasible stop, length 0, the psi wrap, saturated
   efforts): every field of the result bit for bit, agreement of length,
   in_goal and reached, max |dx| and |du| where lengths agree, the branch
   counts, and both times; then kernel D's
   main path, the experiment's entry point
   ``lqrrt_tpu_torch.tools.exp_steer_kernel.main`` at full width (B = 8192,
   a tree of N = 40960 rows), with the launch counts set to 0 just before
   and read just after;
5c'. kernel D's other models: the card's tanf (the car's f) and div_rn
   (the quadrotor's divisions) against ``torch.tan`` and torch's ``/``, bit
   for bit (div_rn a gate) on their operand ranges, random bit patterns
   and special values; then D flat and tree for the car (H = 80), the
   quadrotor (60) and the double integrator (40) against the plain steer
   on the card at B = 8192 and 8191, on each model's ``default_problem()``
   (``all_of(control_limits, circles_free)``) and without obstacles,
   x0 and xtar from a seeded ``torch.Generator``, K from the model's lqr
   and a tree of N = 40960 rows: every field bit for bit and every branch
   reached (goal, arrived and infeasible stops, the full horizon, held
   tails), both times; then each model's main path,
   ``exp_steer_kernel.main(model=...)`` at full width, with the launch
   counts set to 0 just before and read just after;
5d. kernel D's repairs: parents outside [0, N), a NaN tree row and NaN x0
   rows give the same NaN rows on the card as in the plain version, bit for
   bit against the plain version on the card (the tree call under
   ``torch.cuda.set_sync_debug_mode("error")``), NaN for NaN against the
   CPU, with the boat's 7 circles and without obstacles;
5e. kernel F: F1 (``make_steer_kernel_dv``, D's kernel in the double-vmap
   layout, batch_tile 512 and 1024) vs the plain steer as in 5c; ragged
   batches: D flat and tree and F1 at B = 8191, F2's twelve stages at
   B = 8191 on the tool's data, F3's six at B = 1027 on all ones and on
   ``branch_inputs``, F4's probes B and C at B = 1027 and from an
   unaligned pointer, each bit for bit against its plain version; D flat
   and tree and F1 at B = 8192 with 0, 10 and 64
   circles, bit for bit; then F1's entry point ``exp_steer_dv.main``; F2, every configuration of the stage
   scaffold (``steer_stages.build``) vs its plain version at B = 8192,
   H = 100, bit for bit, then its entry point ``exp_steer_stages.main``
   (where kernel D's time goes); F3 and F4, the entry points
   ``dbg_steer_kernel.main`` and ``dbg_steer_scaffold.main`` (every stage
   and probe built, launched and equal to its plain version), then their
   times; each main path with its launch counts set to 0 just before and
   read just after;
6. batched CARE on the card for 8192 car and 8192 quadrotor linearizations
   against scipy's float64 CARE on a subsample;
7. round parity, boat and car: one expansion round on the card against the
   same round on the CPU (plain versions) on the same tree and candidates;
8. main paths at full width (batch 8192, capacity 32768) through
   ``Planner.warmup`` and ``update_plan``: the boat (nn_const, 2.0 s), the
   car (nn_general, 2.0 s) and the quadrotor (nn_general, 3.0 s), each
   checked for goal, feasibility, goal box and dynamic consistency, with
   the kernels' launch counts set to 0 just before the replan and read just
   after (A or C, B, and kernel D, the steer, which must launch); then one
   restart chunk of each under ``torch.cuda.set_sync_debug_mode("error")``;
8'. kernel D on the planner's path (``core.steer.make_routed_steer``),
   for the boat's circles and then for its raster: ``steer_selected`` is
   "kernel"; two boat planners at full width from one seed, one on D and
   one on the plain steer: a restart chunk from one generator state gives
   bit-identical trees, the pool and the score, ``_prune`` of its best
   chain the same plan, the prune's and the finish's steers bit for bit
   on 1024 and 8 rows, D's chunk sync-free under sync-debug mode 'error';
   then a 1.0 s replan of each; D's launches set to 0 before the chunk,
   the prune and each replan and read after;
9. the new paths at full width: the grid boat
   (``boat.default_problem(obstacle_model="grid")``, 2.0 s, as 8, its
   raster through D's raster instance, which must launch); the
   boat's host loop (``refine=False``, 1.0 s, which fills the tree and
   stops there; then ``max_nodes=16384`` with one round a chunk, held to
   ``nodes <= max_nodes + batch * rounds_per_chunk``); the double
   integrator with a moving buoy (``circles_free_data``, two 2.0 s replans
   around ``Constraints.set_feasibility_data``: the goal and a clearance >
   0 in each, no new chunk, the data tensors at the same addresses),
   through kernel A with no wrap dim; kernel A alone at the double
   integrator's shapes (n = 4 unwrapped, its S, N = 40960, size 32768,
   B = 8192) against its plain version, with its times and bound; and a
   small replan with an untagged erf, which takes the scan;
9'. past 16 states (fault 22): the double integrator stacked five times
   (n = 20, a constant lqr, ``nn_impl="auto"``) at full width, a 3.0 s
   replan through kernel A's n = 20 instance that reaches the goal; then
   ``tools.exp_quality`` in short form (``hard_problem``, batch 2048, 0.2
   and 1.0 s, 3 seeds);
10. ``refine_mode="leaf_rewire"`` at full width on the double integrator's
   five circles (2.0 s): the grow chunk fills the tree, refine chunks
   (leaf replacement through kernel A at B = 4096, and the rewire) run on
   it; the refine chunk cached, no restart, the goal, the plan's checks,
   an fp64 audit of every row (child counts, edge starts, node times, no
   cycle), ``get_tree``'s best chain equal to the plan, one refine chunk
   under sync-debug mode 'error', and the restart mode's replan beside it;
   one refine round on the card against the CPU (kernel A's ids, the
   integer fields equal, the float fields within 1e-3), then its parts
   timed and its device busy share; the host side: a checkpoint carried
   into a fresh planner, the replan watchdog, the trajectory server;
11. the demos: ``lqrrt_tpu_torch.demos``' boat, car, quadrotor and double
   integrator demos and the boat's replan loop through their ``main``, on
   the card with no figure, at the demos' own width (batch 256, capacity
   8192): each must exit 0 (goal, clearance, tracking error), with its NN
   kernel's launches counted (A or C) and its wall time;
12. the scenario-parallel fleet at full width, its steer kernel D (one
   goal a row): ``portbench``'s ``fleet.plan`` configuration (1024
   boat scenarios, batch 64, capacity 1024, a 2.0 s budget) with its stats,
   the peak memory, the budget, capacity and plan checks, one launch of D
   a round; the fleet's trees after 8 rounds and one steer call on its
   65,536 rows through D bit for bit against the plain loop, and D alone
   there beside its bound; 64 rounds with
   a goal rate > 0.5 and an fp64 audit of 16 trees; a round's parts, its
   busy share and a sync-free round; per-scenario worlds (a circle a
   scenario) and per-scenario grids (the buoy raster moved a scenario,
   with a peak-memory gate against a per-row copy); one round card vs CPU
   at 8 scenarios; the fleet demo;
13. multi-device planning (``lqrrt_tpu_torch/parallel``) on an NCCL
   group of world size 1: a mesh round (gather) bit for bit against the
   plain round, a topk round against the CPU's, the one-shard map round
   against steering under the whole grid; full-width boat replans with
   ``Planner(mesh=...)`` (gather on the restart path, topk on the host
   loop, a sharded grid with the restart stash) beside the replan without
   a mesh, kernels A and B counted; a sync-free mesh chunk; the
   collectives bench at world size 1.

The last two lines are a JSON object with the kernels' checks and times and
``{"ok": true, "device": {...}}``.  In the kernels line every ``ms``,
``plain_ms`` and ``library_ms`` is one clock: CUDA events around one call
of the wrapper, the host's dispatch included (``cuda_ms``); every kernel
adds ``device_ms`` (and F's dicts ``*_device_ms``), the wrapper alone
(``exp_steer_kernel.device_ms``: the stream spins while the host dispatches
the call).  B's ``device_ms`` is taken with L2 cold, beside
``library_device_ms``, ``copy_`` alone; A's, C's and E's include their
prep, and ``launch_device_ms`` is the launch without it.  Without CUDA, or
without the package beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lqrrt_tpu_torch.utils.device import card_name, smi_line  # noqa: E402

TOL_EXCESS = 1e-4      # fp64 relative cost excess allowed for NN picks
TOL_CARE = 2e-3        # max |S - S_scipy| / max |S_scipy| (the CPU tests')
# kernel E vs its plain version: the same rounded operands summed in
# another order (8 or 16 terms, fp32 or tensor-core accumulators), as a
# share of M_b
TOL_SUM = 2.0 ** -16
N_BENCH, B_BENCH, NS, WRAP = 40960, 8192, 6, 2
SIZES = (512, 8704, 32768)
TOL_STEER = 1e-3       # |dx|, |du| of a rollout where lengths agree (the
                       # CPU tests'); lengths, in_goal, reached: >= 0.999
B_REPAIR = 2048        # candidates of kernel D's repair phase (a CPU run)
B_RAGGED = 8191        # the ragged batch of kernel D and F1
B_PROBE_RAGGED = 1027  # and of F3's stages and F4's probes B and C (6B not
                       # a multiple of 4)
N_STAGE_KERNELS = 15   # stage_kernel instances: 14 bodies, identity twice


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median ms of ``fn`` over ``reps`` runs, CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def wrapped_cost64(xr, st, S64, wrap=WRAP):
    """fp64 metric between candidates xr and nodes st under S64, one shared
    (n, n) or one per node (..., n, n), with ``wrap`` the wrapped dim or
    None."""
    e = xr - st
    if wrap is not None:
        e[..., wrap] = torch.remainder(e[..., wrap] + math.pi,
                                       2 * math.pi) - math.pi
    if S64.dim() == 2:
        return ((e @ S64) * e).sum(-1)
    return torch.einsum("...i,...ij,...j->...", e, S64, e)


def rel_excess(c, c_ref):
    return ((c - c_ref) / c_ref.abs().clamp(min=1e-6)).max().item()


A_SIZES = (0, 1, 33, 512, 4097, 8704, 32767, 32768)


def phase_kernel_a():
    """Kernel A at N = 40960, B = 8192 against its plain version and an
    fp64 brute-force anchor: the boat's n = 6 (wrap dim 2) at every size
    of A_SIZES (partial tiles, node partitions with no live row, size 0);
    the root-pad tie at sizes 1024 and 32768; NaN state rows inside and
    past size; n = 4, 12, 16, 17 and 20 (the 64-row tiles, one candidate
    a thread; timed) wrapped at the first and the last dim and unwrapped.
    Gates: id match >= 0.999, fp64 excess and anchors <= TOL_EXCESS.
    Then the times at n = 6, size 32768: the wrapper with its dispatch,
    alone (``device_ms``), its launch alone and its prep alone (the
    candidate mean and the fill of the keys), and the plain version."""
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import (nn_const,
                                                       nn_const_plain)
    from lqrrt_tpu_torch.tools.exp_steer_kernel import device_ms
    from lqrrt_tpu_torch.tools.kernel_times import (const_inputs,
                                                    const_launcher, prep_ms)

    fns = ("kernel A nn_const", nn_const, nn_const_plain)
    states, S, xr = const_inputs(NS, WRAP, "cuda", 3)
    out = {"id_match": {}}
    max_err = 0.0
    for size in A_SIZES:
        _, out["id_match"][size], err = check_nn(
            fns, f"n={NS} wrap={WRAP}", states, S, xr, size, WRAP,
            timed=size == A_SIZES[-1], gate_ids=True)
        max_err = max(max_err, err)
    # root pad: rows 1..511 copy row 0 and must lose to it, also where
    # they span several node partitions (size 1024)
    st_p = states.clone()
    st_p[1:512] = st_p[0]
    xr_p = xr.clone()
    g = torch.Generator(device="cuda").manual_seed(4)
    xr_p[:64] = st_p[0] + 0.01 * (
        torch.rand((64, NS), generator=g, device="cuda") * 2 - 1)
    for sz_p in (1024, 32768):
        ik, _, _ = check_nn(fns, f"n={NS} root pad", st_p, S, xr_p, sz_p,
                            WRAP, gate_ids=True)
        if not bool((ik[:64] == 0).all()):
            raise AssertionError("kernel A: root-pad ties picked "
                                 f"{ik[:64].unique().tolist()}, not row 0")
        log(f"kernel A nn_const n={NS} root pad size={sz_p}: the 64 "
            "candidates by row 0 all pick id 0")
    # NaN state rows inside and past size drop only themselves
    st_nan = states.clone()
    dead = torch.zeros(N_BENCH, dtype=torch.bool, device="cuda")
    dead[::97] = True
    st_nan[dead] = math.nan
    st_nan[32768 + 5:] = math.nan
    check_nn(fns, f"n={NS} NaN rows", st_nan, S, xr, 32768, WRAP,
             dead=dead[:32768], gate_ids=True)
    for n in (4, 12, 16, 17, 20):
        for wrap in (0, n - 1, None):
            st_n, S_n, xr_n = const_inputs(n, wrap, "cuda", 30 + n)
            for size in (4097, 32768):
                check_nn(fns, f"n={n} wrap={wrap}", st_n, S_n, xr_n, size,
                         wrap, timed=n > 16, gate_ids=True)

    size = A_SIZES[-1]
    sz = torch.tensor(size, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: nn_const(states, S, sz, xr, wrap_dim=WRAP))
    plain_ms = cuda_ms(
        lambda: nn_const_plain(states, S, sz, xr, wrap_dim=WRAP), reps=5)
    alone = device_ms(lambda: nn_const(states, S, sz, xr, WRAP), 20)
    launch, refill = const_launcher(states, S, xr, sz, WRAP)
    launch_alone = device_ms(launch, 20, refill)
    prep_alone = prep_ms(xr, 20)
    log(f"kernel A nn_const n={NS} size={size}: kernel_ms={ms:.4f} "
        f"device_ms={alone:.4f} (alone, the prep included) "
        f"launch_device_ms={launch_alone:.4f} prep_device_ms="
        f"{prep_alone:.4f} (2 ops: the candidate mean, the fill of the "
        f"keys) plain_ms={plain_ms:.4f}")
    out.update(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               device_ms=alone, launch_device_ms=launch_alone,
               prep_device_ms=prep_alone)
    return out


def phase_kernel_b():
    """Kernel B bit for bit against its plain version at C = 6 and 3, at
    aligned starts (the planner's), unaligned ones (the scalar path), a
    negative one and the tail; then both times with the dispatch, and
    alone beside ``copy_`` alone, L2 cold and warm
    (``tools.kernel_times.time_write``)."""
    from lqrrt_tpu_torch.ops.kernels.write_kernel import (block_write,
                                                          block_write_plain)
    from lqrrt_tpu_torch.tools.kernel_times import time_write

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    timing = {}
    max_err = 0.0
    for C in (6, 3):
        dst0 = torch.randn((100, C, N_BENCH), generator=g, device=dev)
        src = torch.randn((100, C, B_BENCH), generator=g, device=dev)
        for start in (512, 512 + 8192, 24576 + 512, 1000, 37000, 0, 1001,
                      1003, -3, N_BENCH - 2):
            a, b = dst0.clone(), dst0.clone()
            s = torch.tensor(start, dtype=torch.int32, device=dev)
            block_write(a, src, s)
            block_write_plain(b, src, s)
            torch.cuda.synchronize()
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
            err = (a - b).abs().max().item()
            max_err = max(max_err, err)
            log(f"kernel B block_write (100,{C},{N_BENCH}) start={start}: "
                f"bit_exact={same} max_abs_err={err:.3e}")
            if not same:
                raise AssertionError(f"kernel B differs at start={start}")
        s = torch.tensor(512 + 8192, dtype=torch.int32, device=dev)
        a = dst0.clone()
        ms = cuda_ms(lambda: block_write(a, src, s))
        plain_ms = cuda_ms(lambda: block_write_plain(a, src, s))
        # the library call: the same slice assignment at a host-side start
        library_ms = cuda_ms(
            lambda: a[..., 512 + 8192:512 + 8192 + B_BENCH].copy_(src))
        alone = time_write(C, 20)
        log(f"kernel B block_write (100,{C},{N_BENCH}) B={B_BENCH}: "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (slice copy_); alone, "
            + "; ".join(f"L2 {k}: kernel {alone[k]['kernel_ms']:.4f} "
                        f"copy_ {alone[k]['copy_ms']:.4f}"
                        for k in ("cold", "cold_clean", "warm")))
        timing[C] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         alone=alone)
    t6 = timing[6]
    return dict(max_abs_err=max_err, ms=t6["ms"], plain_ms=t6["plain_ms"],
                library_ms=t6["library_ms"],
                device_ms=t6["alone"]["cold"]["kernel_ms"],
                library_device_ms=t6["alone"]["cold"]["copy_ms"],
                alone={C: {k: t["alone"][k]
                           for k in ("cold", "cold_clean", "warm")}
                       for C, t in timing.items()})


C_SIZES = (0, 1, 33, 512, 4097, 8704, 32767, 32768)


def check_nn(fns, label, states, S, xr, size, wrap, dead=None, timed=False,
             gate_ids=False):
    """A nearest-neighbour kernel (``fns``: its name, wrapper and plain
    version; kernel A with one shared S (n, n), kernel C with S (N, n, n))
    against its plain version and an fp64 brute-force anchor on 256
    candidates at one size; ``dead`` marks rows that must never be picked
    (NaN), left out of the anchor; ``timed`` adds the wrapper's time with
    its dispatch to the line; ``gate_ids`` also requires an id match >=
    0.999.  Raises on a disagreement; returns (the kernel's ids, id_match,
    max |cost| error)."""
    name, kernel, plain = fns
    dev = states.device
    sz = torch.tensor(size, dtype=torch.int32, device=dev)
    ik, ck = kernel(states, S, sz, xr, wrap_dim=wrap)
    ip, cp = plain(states, S, sz, xr, wrap_dim=wrap)
    torch.cuda.synchronize()
    id_match = (ik == ip).double().mean().item()
    if size == 0:
        ok = bool((ik == 0).all() and torch.isinf(ck).all() and (ck > 0).all()
                  and torch.equal(ik, ip) and torch.equal(ck, cp))
        log(f"{name} {label} size=0: (0, +inf) everywhere={ok}")
        if not ok:
            raise AssertionError(f"{name} {label}: size 0 is not (0, inf)")
        return ik, id_match, 0.0
    st64, xr64, S64 = states.double(), xr.double(), S.double()
    anchor = torch.arange(0, len(xr), max(len(xr) // 256, 1),
                          device=dev)[:256]
    shared = S64.dim() == 2

    def metric(rows):
        return S64 if shared else S64[rows]

    c_k = wrapped_cost64(xr64, st64[ik.long()], metric(ik.long()), wrap)
    c_p = wrapped_cost64(xr64, st64[ip.long()], metric(ip.long()), wrap)
    excess = rel_excess(c_k, c_p)
    c_star = torch.full((len(anchor),), math.inf, dtype=torch.float64,
                        device=dev)
    for j0 in range(0, size, 2048):
        j1 = min(j0 + 2048, size)
        c = wrapped_cost64(xr64[anchor, None, :], st64[None, j0:j1],
                           S64 if shared else S64[None, j0:j1], wrap)
        if dead is not None:
            c = torch.where(dead[None, j0:j1], math.inf, c)
        c_star = torch.minimum(c_star, c.min(dim=1).values)
    anchor_k = rel_excess(c_k[anchor], c_star)
    anchor_p = rel_excess(c_p[anchor], c_star)
    max_err = (ck - cp).abs().max().item()
    max_rel = ((ck - cp).abs() / cp.abs().clamp(min=1e-6)).max().item()
    ms = cuda_ms(lambda: kernel(states, S, sz, xr, wrap_dim=wrap)) \
        if timed else None
    picks_ok = bool((ik >= 0).all() and (ik < size).all())
    if dead is not None:
        picks_ok = picks_ok and not bool(dead[ik.long()].any())
    log(f"{name} {label} size={size}: id_match={id_match:.6f} "
        f"fp64_excess={excess:.3e} anchor_kernel={anchor_k:.3e} "
        f"anchor_plain={anchor_p:.3e} max_abs_cost_err={max_err:.3e} "
        f"max_rel_cost_err={max_rel:.3e}"
        + (f" kernel_ms={ms:.4f}" if ms is not None else ""))
    if not (picks_ok and excess <= TOL_EXCESS and anchor_k <= TOL_EXCESS
            and anchor_p <= TOL_EXCESS
            and (id_match >= 0.999 or not gate_ids)):
        raise AssertionError(f"{name} disagrees: {label}, size={size}")
    return ik, id_match, max_err


def phase_kernel_c():
    """Kernel C at N = 40960, B = 8192, n = 4 (wrap dim 2) and n = 12 (wrap
    dim 5) with random SPD S_j, at every size of C_SIZES (partial tiles,
    partitions with no live row, size 0); then the root-pad tie, NaN S rows
    inside and past size, and a non-symmetric S at size 32768; then the
    times: the wrapper with its dispatch, alone (``device_ms``, the fold
    included) and the launch alone on folded rows.  Last, n = 20 (the last
    template instance) and 24 (``nn_general_any_kernel``, n at run time),
    wrapped at dim 0 and unwrapped, at sizes 4097 and 32768."""
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import (
        EMPTY_KEY, _launch, nn_general, nn_general_fold, nn_general_plain)
    from lqrrt_tpu_torch.tools.exp_steer_kernel import device_ms

    fns = ("kernel C nn_general", nn_general, nn_general_plain)
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
    g_skew = torch.Generator(device=dev).manual_seed(11)
    out = {}
    for n, wrap in ((4, 2), (12, 5)):
        scale = torch.full((n,), 10.0, device=dev)
        scale[wrap] = math.pi
        states = (torch.rand((N_BENCH, n), generator=g, device=dev) * 2
                  - 1) * scale
        xr = (torch.rand((B_BENCH, n), generator=g, device=dev) * 2 - 1) \
            * scale
        A = torch.randn((N_BENCH, n, n), generator=g, device=dev) * 0.5
        S = A @ A.mT + 0.1 * torch.eye(n, device=dev)
        match, max_err = {}, 0.0
        for size in C_SIZES:
            _, match[size], err = check_nn(
                fns, f"n={n} wrap={wrap}", states, S, xr, size, wrap,
                timed=True)
            max_err = max(max_err, err)
        size = C_SIZES[-1]
        # root pad: rows 1..511 copy row 0 and must lose to it, also where
        # they span several node partitions (size 1024)
        st_p, S_p = states.clone(), S.clone()
        st_p[1:512] = st_p[0]
        S_p[1:512] = S_p[0]
        xr_p = xr.clone()
        xr_p[:64] = st_p[0] + 0.01 * xr_p[:64] / scale
        for sz_p in (1024, size):
            ik, _, _ = check_nn(fns, f"n={n} root pad", st_p, S_p, xr_p,
                                sz_p, wrap)
            root = ik[:64]
            if not bool((root == 0).all()):
                raise AssertionError(f"kernel C n={n}: root-pad ties picked "
                                     f"{root.unique().tolist()}, not row 0")
            log(f"kernel C nn_general n={n} root pad size={sz_p}: the 64 "
                "candidates by row 0 all pick id 0")
        # NaN S rows inside and past size drop only themselves
        S_nan, st_nan = S.clone(), states.clone()
        dead = torch.zeros(N_BENCH, dtype=torch.bool, device=dev)
        dead[::97] = True
        S_nan[dead] = math.nan
        st_nan[size + 5:] = math.nan
        check_nn(fns, f"n={n} NaN rows", st_nan, S_nan, xr, size, wrap,
                 dead=dead[:size])
        # a non-symmetric S: its skew part adds nothing to e' S e
        K = torch.randn((N_BENCH, n, n), generator=g_skew, device=dev) \
            * 0.5
        check_nn(fns, f"n={n} non-symmetric S", states, S + K - K.mT, xr,
                 size, wrap)

        sz = torch.tensor(size, dtype=torch.int32, device=dev)
        ms = cuda_ms(lambda: nn_general(states, S, sz, xr, wrap_dim=wrap))
        plain_ms = cuda_ms(
            lambda: nn_general_plain(states, S, sz, xr, wrap_dim=wrap),
            reps=5)
        alone = device_ms(lambda: nn_general(states, S, sz, xr, wrap), 20)
        rows, perm = nn_general_fold(states, S, wrap)
        xr_perm = xr.index_select(1, perm).contiguous()
        keys = torch.full((B_BENCH,), EMPTY_KEY, dtype=torch.int64,
                          device=dev)
        launch = device_ms(lambda: _launch(
            "lqrrt_nn_general", rows, xr_perm, sz, keys, N_BENCH, B_BENCH,
            n, 1), 20)
        log(f"kernel C nn_general n={n} size={size}: kernel_ms={ms:.4f} "
            f"device_ms={alone:.4f} (alone, the fold included) "
            f"launch_device_ms={launch:.4f} plain_ms={plain_ms:.4f} "
            f"id_match by size {match}")
        out[n] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                      device_ms=alone, launch_device_ms=launch,
                      id_match=match)
    for n in (20, 24):
        match, max_err = {}, 0.0
        for wrap in (0, None):
            scale = torch.full((n,), 10.0, device=dev)
            if wrap is not None:
                scale[wrap] = math.pi
            states = (torch.rand((N_BENCH, n), generator=g, device=dev) * 2
                      - 1) * scale
            xr = (torch.rand((B_BENCH, n), generator=g, device=dev) * 2
                  - 1) * scale
            A = torch.randn((N_BENCH, n, n), generator=g, device=dev) * 0.3
            S = A @ A.mT + 0.1 * torch.eye(n, device=dev)
            for size in (4097, 32768):
                _, match[f"wrap={wrap} size={size}"], err = check_nn(
                    fns, f"n={n} wrap={wrap}", states, S, xr, size, wrap,
                    timed=True)
                max_err = max(max_err, err)
        out[n] = dict(max_abs_err=max_err, id_match=match)
    return out


def phase_kernel_e():
    """Kernel E (nn_expand) in each mode against its plain version at
    N = 40960, B = 8192, boat S and boat-scale data, wrap dim 2 and
    unwrapped.  The expanded cost cancels, so errors are held as shares of
    M_b (``error_scale``): a pick may exceed the true nearest by twice its
    mode's error (``ERROR``), and the kernel and the plain version, which
    round the same operands and differ only in the fp32 summation order,
    agree within TOL_SUM M_b in cost; picks that differ are equivalent
    when their costs under the mode's operands, in fp64, are that close."""
    from lqrrt_tpu_torch.ops.kernels.nn_hybrid import (
        ERROR, MODES, error_scale, expand_prep, nn_exp, nn_expand_plain,
        nn_hybrid, nn_split3, pick_cost64)
    from lqrrt_tpu_torch.tools.exp_nn_hybrid import problem
    from lqrrt_tpu_torch.tools.exp_steer_kernel import device_ms
    from lqrrt_tpu_torch.tools.kernel_times import (const_launcher,
                                                    expand_launcher)

    wrappers = {"fma": nn_exp, "bf16x3": nn_split3,
                "bf16": lambda *a, **k: nn_hybrid(*a, prec="default", **k)}
    states, S, _, xr = problem("cuda", N_BENCH, B_BENCH, 0, 17)
    st64, xr64, S64 = states.double(), xr.double(), S[0].double()
    out = {}
    for wrap in (WRAP, None):
        p = expand_prep(states, S, xr, wrap)
        for size in SIZES:
            sz = torch.tensor(size, dtype=torch.int32, device="cuda")
            M = error_scale(p, sz).double()
            anchor = torch.arange(0, B_BENCH, B_BENCH // 256,
                                  device="cuda")[:256]
            c_star = wrapped_cost64(xr64[anchor, None, :],
                                    st64[None, :size, :], S64,
                                    wrap).min(1).values
            for mode in MODES:
                t_cfg = time.perf_counter()

                def kernel():
                    return wrappers[mode](states, S, sz, xr, wrap_dim=wrap)

                def plain():
                    return nn_expand_plain(states, S, sz, xr, wrap, mode)

                ik, ck = kernel()
                ip, cp = plain()
                torch.cuda.synchronize()
                wrapped = wrap is not None
                gap = (pick_cost64(p, ik, mode, wrapped)
                       - pick_cost64(p, ip, mode, wrapped)).abs()
                id_match = ((ik == ip) | (gap <= 2 * TOL_SUM * M)) \
                    .double().mean().item()
                bound = 2 * ERROR[mode] * M
                t_k = wrapped_cost64(xr64, st64[ik.long()], S64, wrap)
                t_p = wrapped_cost64(xr64, st64[ip.long()], S64, wrap)
                excess = ((t_k - t_p) / bound).max().item()
                anchor_k = ((t_k[anchor] - c_star)
                            / bound[anchor]).max().item()
                anchor_p = ((t_p[anchor] - c_star)
                            / bound[anchor]).max().item()
                err = (ck - cp).abs()
                cost_err = (err / M).max().item()
                max_err = err.max().item()
                live_ok = bool((ik < size).all().item())
                # the launch alone, and the wrapper (prep and launch) alone
                # and with its dispatch
                launch, refill = expand_launcher(states, S[0].contiguous(),
                                                 xr, sz, wrap, mode)
                ms = device_ms(launch, 20, refill)
                wrapper_device_ms = device_ms(kernel, 20)
                wrapper_ms = cuda_ms(kernel)
                top = wrap is not None and size == SIZES[-1]
                plain_ms = cuda_ms(plain, reps=3 if top else 1)
                log(f"kernel E nn_expand[{mode}] wrap={wrap} size={size}: "
                    f"id_match={id_match:.6f} (equal, or equivalent within "
                    f"2*2^-16 M_b) exact_id_match="
                    f"{(ik == ip).double().mean().item():.6f} "
                    f"fp64_excess/bound={excess:.3e} "
                    f"anchor_kernel/bound={anchor_k:.3e} "
                    f"anchor_plain/bound={anchor_p:.3e} "
                    f"max_abs_cost_err={max_err:.3e} "
                    f"cost_err/M={cost_err:.3e} launch_device_ms={ms:.4f} "
                    f"wrapper_device_ms={wrapper_device_ms:.4f} "
                    f"wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} "
                    "(no single PyTorch call computes this function) "
                    f"t={time.perf_counter() - t_cfg:.2f} s")
                if not (live_ok and id_match >= 0.999 and excess <= 1.0
                        and anchor_k <= 1.0 and anchor_p <= 1.0
                        and cost_err <= TOL_SUM):
                    raise AssertionError(f"kernel E disagrees in mode {mode} "
                                         f"at wrap={wrap}, size={size}")
                out[(mode, wrap, size)] = dict(
                    max_abs_err=max_err, ms=wrapper_ms,
                    device_ms=wrapper_device_ms, launch_device_ms=ms,
                    plain_ms=plain_ms)
    # kernel A's launch alone on the same inputs, for the like-for-like
    # comparison
    sz = torch.tensor(SIZES[-1], dtype=torch.int32, device="cuda")
    launch, refill = const_launcher(states, S[0].contiguous(), xr, sz, WRAP)
    a_ms = device_ms(launch, 20, refill)
    log(f"kernel A nn_const launch alone, same inputs, wrap={WRAP} "
        f"size={SIZES[-1]}: launch_device_ms={a_ms:.4f}")
    return out


def phase_exp_nn_hybrid(smi):
    """The experiment's entry point at full width, with the launch counts
    set to 0 just before and read just after."""
    from lqrrt_tpu_torch.ops.kernels import nn_hybrid as E
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const
    from lqrrt_tpu_torch.tools import exp_nn_hybrid

    nn_const.launches = 0
    for mode in E.MODES:
        E.LAUNCHES[mode] = 0
    res = exp_nn_hybrid.main(device="cuda")
    launches = dict(E.LAUNCHES)
    log(f"exp_nn_hybrid main [{smi}]: nn_expand launches by mode "
        f"{launches}, nn_const {nn_const.launches}")
    for label, c in res["checks"].items():
        if not (c["live"] and c["excess_over_bound"] <= 1.0):
            raise AssertionError(f"exp_nn_hybrid: {label} fails: {c}")
    if min(launches.values()) < 1:
        raise AssertionError(f"exp_nn_hybrid: a mode was not launched: "
                             f"{launches}")
    return res, launches


def torch_sum_order(a):
    """The sum over the last dim of a (rows, n) tensor in the order of
    ``torch_sum<n>`` (csrc/boat_device.cuh): W = last_pow2(n) lanes, lane l
    adds a[l] and a[l + W], then a tree by offsets W / 2, ..., 1."""
    n = a.shape[-1]
    w = 1 << (n.bit_length() - 1)
    v = [a[:, i] + a[:, i + w] if i + w < n else a[:, i] for i in range(w)]
    while w > 1:
        w //= 2
        v = [v[i] + v[i + w] for i in range(w)]
    return v[0]


def phase_kernel_d():
    """Kernel D (steer_rollout), flat and tree-gather, against its plain
    version at B = 8192, H = 100 on the boat's operating point, on
    ``branch_batch`` (every branch of the step reached), with the boat's
    circles and then with its raster (the grid boat's predicate: D's
    ``Raster<Boat>`` instance).  The tree holds N_BENCH rows, with the
    batch's x0 at distinct random rows and a gain of its own in each row
    (the boat's K scaled by 0.5-1.5), so that the in-kernel gather of K is
    checked too.  Returns per variant ("flat", "tree", "flat[grid]",
    "tree[grid]") the numbers of the kernels line."""
    from lqrrt_tpu_torch.models import boat
    from lqrrt_tpu_torch.tools.exp_steer_kernel import (agreement,
                                                        branch_counts,
                                                        device_ms)
    from lqrrt_tpu_torch.tools.kernel_times import (same_result, steer_bound,
                                                    steer_calls, steer_inputs)

    dev = "cuda"
    cases = {}
    for tag, prob in (("", None),
                      ("[grid]", boat.default_problem(obstacle_model="grid"))):
        t = steer_inputs(dev, B_BENCH, 19, N_BENCH, prob=prob)
        calls = steer_calls(t)
        cases.update({v + tag: (*calls[v], t) for v in ("flat", "tree")})
    # the kernel sums n terms in the order of PyTorch's CUDA reduction
    # (torch_sum in csrc/boat_device.cuh): the share of rows where it is
    # torch.sum's order for each model's n, printed since bit-for-bit
    # agreement rests on it
    for n in (4, 6, 12):
        a = torch.randn((65536, n), generator=torch.Generator(device=dev)
                        .manual_seed(29), device=dev) * 100.0
        log(f"kernel D: torch.sum of {n} in torch_sum's order on "
            f"{(torch_sum_order(a) == a.sum(-1)).double().mean().item():.6f}"
            " of rows")
    out = {}
    for variant, (kernel, plain_fn, t) in cases.items():
        x0_np, xtar_np, pids = t["x0_np"], t["xtar_np"], t["pids"]
        tree = variant.startswith("tree")
        res, ref = kernel(), plain_fn()
        torch.cuda.synchronize()
        a = agreement(res, ref)
        same = same_result(res, ref)
        counts = branch_counts(res, x0_np, xtar_np)
        counts_plain = branch_counts(ref, x0_np, xtar_np)
        finite = bool(torch.isfinite(res.x_seq).all()
                      and torch.isfinite(res.u_seq).all())
        ms = cuda_ms(kernel)
        alone_ms = device_ms(kernel, 20)
        # the plain steer is a Python loop of ~100 small ops a step: few
        # repetitions (script time)
        plain_ms = cuda_ms(plain_fn, reps=3)
        rows_read = int(torch.unique(pids).numel()) if tree else B_BENCH
        bound_ms, bound_by, flops, nbytes = steer_bound(
            res, rows_read, t["ncirc"], tree, grid_words=t["grid_words"])
        log(f"kernel D steer_rollout[{variant}] B={B_BENCH} "
            f"H={res.x_seq.shape[0]}: bit_exact={same} "
            f"len_eq={a['len_eq']:.6f} in_goal_eq={a['in_goal_eq']:.6f} "
            f"reached_eq={a['reached_eq']:.6f} max_abs_dx={a['max_dx']:.3e} "
            f"max_abs_du={a['max_du']:.3e} max_abs_dxnew={a['max_dxnew']:.3e} "
            f"(where lengths agree) branches={counts} "
            f"plain_branches={counts_plain} kernel_ms={ms:.4f} "
            f"device_ms={alone_ms:.4f} (alone) "
            f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}; "
            f"{flops:.4g} fp32 flops, {nbytes:.4g} bytes) "
            "(no PyTorch call computes a closed-loop rollout)")
        if not (same and finite and min(a["len_eq"], a["in_goal_eq"],
                                        a["reached_eq"]) >= 0.999
                and max(a["max_dx"], a["max_du"], a["max_dxnew"])
                <= TOL_STEER and min(counts.values()) > 0):
            raise AssertionError(f"kernel D [{variant}] disagrees with its "
                                 "plain version (every field bit for bit) "
                                 "or misses a branch")
        out[variant] = dict(max_abs_err=max(a["max_dx"], a["max_du"]),
                            ms=ms, device_ms=alone_ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    return out


def phase_exp_steer_kernel(smi):
    """Kernel D's main path: the experiment's entry point at full width,
    with the launch counts set to 0 just before and read just after."""
    from lqrrt_tpu_torch.ops.kernels import steer_kernel as D
    from lqrrt_tpu_torch.tools import exp_steer_kernel

    for v in D.VARIANTS:
        D.LAUNCHES[v] = 0
    res = exp_steer_kernel.main(device="cuda")
    launches = {v: D.LAUNCHES[v] for v in ("flat", "tree")}
    log(f"exp_steer_kernel main [{smi}]: steer_rollout launches by variant "
        f"{launches}")
    for label, c in [(f"block={k}", v) for k, v in res["kernel"].items()] \
            + [("tree", res["tree"])]:
        if not (c["len_eq"] >= 0.999 and c["max_dx"] <= TOL_STEER):
            raise AssertionError(f"exp_steer_kernel: {label} fails: {c}")
    if min(launches.values()) < 1:
        raise AssertionError(f"exp_steer_kernel: a variant was not "
                             f"launched: {launches}")
    return res, launches


D_MODELS = ("car", "quadrotor", "double_integrator")
# nn_const_kernel (n = 1-20, wrapped or not), nn_expand_kernel (6),
# nn_general_kernel (n = 1-20, wrapped or not), nn_general_any_kernel (2)
N_ACE_INSTANCES = 40 + 6 + 40 + 2
N_D_INSTANCES = 8      # steer_rollout_kernel: boat, car, quadrotor, double
                       # integrator, each with and without a raster
# D's registers by instance (ptxas): the goal's load, one for every row or
# one a row, sits before the step loop and must cost it none
D_REGISTERS = {"Boat": 147, "Car": 100, "Quadrotor": 230,
               "DoubleIntegrator": 96, "Raster<Boat>": 148}


def bits_equal(a, b):
    """Elementwise: the same float32 bits, or both NaN."""
    return ((a.view(torch.int32) == b.view(torch.int32))
            | (a.isnan() & b.isnan()))


def phase_math_probes():
    """The card's tanf (the car's f) and div_rn (the quadrotor's divisions)
    as kernel D computes them (``steer_kernel.math_probe``) against
    ``torch.tan`` and torch's ``/`` on the card: the share of equal bits
    (NaN equal to NaN) over the car's steering angles, a wide range and
    2^20 random bit patterns for tan; for the division over sin and cos
    over the clamped pitch cosine [0.2, 1], torques over the inertia (0.01,
    0.02), random bit patterns (subnormals, infinities and NaN among them)
    and every pair of 16 special values.  div_rn must agree everywhere (a
    gate); tanf's share is printed (kernel D's bit-for-bit gates on the car
    rest on it)."""
    from lqrrt_tpu_torch.ops.kernels.steer_kernel import math_probe

    dev, k = "cuda", 1 << 20
    g = torch.Generator(device=dev).manual_seed(31)

    def uni(lo, hi):
        return lo + (hi - lo) * torch.rand(k, generator=g, device=dev)

    def bits():
        return torch.randint(-2 ** 31, 2 ** 31, (k,), generator=g,
                             device=dev).to(torch.int32).view(torch.float32)

    tiny = torch.tensor([1], dtype=torch.int32).view(torch.float32).item()
    special = torch.tensor(
        [0.0, -0.0, math.inf, -math.inf, math.nan, tiny, -tiny, 1.1754942e-38,
         1.1754944e-38, 3.4028235e38, -3.4028235e38, 1.0, -1.0, 3.0, 0.2,
         1e-30], device=dev)
    tan_in = torch.cat([uni(-0.6, 0.6), uni(-100.0, 100.0), bits()])
    tan_eq = bits_equal(math_probe("tan", tan_in), torch.tan(tan_in))
    num = torch.cat([torch.sin(uni(-0.6, 0.6)), torch.cos(uni(-0.6, 0.6)),
                     uni(-50.0, 50.0), uni(-1e-3, 1e-3), bits(),
                     special.repeat_interleave(len(special))])
    den = torch.cat([uni(0.2, 1.0), uni(0.2, 1.0),
                     torch.tensor([0.01, 0.01, 0.02], device=dev).repeat(
                         -(-k // 3))[:k],
                     torch.full((k,), 0.01, device=dev), bits(),
                     special.repeat(len(special))])
    div_eq = bits_equal(math_probe("div", num, den), num / den)
    torch.cuda.synchronize()
    out = dict(tan_share=tan_eq.double().mean().item(),
               div_share=div_eq.double().mean().item())
    log(f"kernel D math: tanf equal to torch.tan on {out['tan_share']:.6f} "
        f"of {len(tan_in)} arguments; div_rn equal to torch's / on "
        f"{out['div_share']:.6f} of {len(num)} operand pairs (bits, NaN "
        "equal)")
    if out["div_share"] != 1.0:
        bad = (~div_eq).nonzero()[:5, 0]
        raise AssertionError(f"div_rn differs from torch's / at "
                             f"{list(zip(num[bad].tolist(), den[bad].tolist()))}")
    return out


def phase_kernel_d_models():
    """Kernel D, flat and tree-gather, for the car (H = 80), the quadrotor
    (60) and the double integrator (40) against the plain steer on the
    card at B = 8192 and at the ragged B_RAGGED, on each model's
    ``default_problem()`` predicate (``all_of(control_limits,
    circles_free)``) and without obstacles (``control_limits`` alone):
    ``kernel_times.model_steer_inputs`` (x0 and xtar from a seeded
    ``torch.Generator`` in the sample space, K from the model's own lqr: the
    batched CARE for the car and the quadrotor; a tree of N_BENCH rows).
    Every field bit for bit, NaN equal (a gate), and every branch reached:
    the goal stop, the arrived stop, the full horizon, held tails and, with
    circles, the infeasible stop.  Returns per model and variant the
    numbers of the kernels line, timed at B = 8192 with circles."""
    import importlib

    from lqrrt_tpu_torch.core.steer import make_steer
    from lqrrt_tpu_torch.ops.kernels.steer_kernel import (
        make_steer_kernel, make_steer_kernel_tree)
    from lqrrt_tpu_torch.tools.exp_steer_kernel import agreement, device_ms
    from lqrrt_tpu_torch.tools.kernel_times import (model_branch_counts,
                                                    model_steer_inputs,
                                                    same_result_nan,
                                                    steer_bound)

    out = {}
    for name in D_MODELS:
        mod = importlib.import_module(f"lqrrt_tpu_torch.models.{name}")
        out[name] = {}
        for label, obstacles in (("circles", True), ("0 circles", False)):
            t = model_steer_inputs(mod.default_problem(obstacles=obstacles),
                                   "cuda", B_BENCH, 23, N_BENCH)
            plain = make_steer(*t["args"], **t["kw"])
            flat = make_steer_kernel(*t["args"], **t["kw"])
            tree = make_steer_kernel_tree(*t["args"], **t["kw"])
            x0, KB, xtar, goal = t["x0"], t["KB"], t["xtar"], t["goal"]
            states, KN, pids = t["states"], t["KN"], t["pids"]
            idx = pids.long()
            calls = {
                "flat": (lambda b: flat(x0[:b], KB[:b], xtar[:b], goal),
                         lambda b: plain(x0[:b], KB[:b], xtar[:b], goal)),
                "tree": (lambda b: tree(states, KN, pids[:b], xtar[:b],
                                        goal),
                         lambda b: plain(states[idx[:b]], KN[idx[:b]],
                                         xtar[:b], goal))}
            for variant, (kernel, plain_fn) in calls.items():
                for b in (B_BENCH, B_RAGGED):
                    res, ref = kernel(b), plain_fn(b)
                    torch.cuda.synchronize()
                    same = same_result_nan(res, ref)
                    counts = model_branch_counts(res)
                    need = {k: v for k, v in counts.items()
                            if obstacles or k != "infeasible stop"}
                    log(f"kernel D steer_rollout[{name}, {variant}, {label}]"
                        f" B={b} H={res.x_seq.shape[0]}: bit_exact={same} "
                        f"branches={counts}")
                    if not (same and min(need.values()) > 0):
                        raise AssertionError(
                            f"kernel D [{name}, {variant}, {label}, B={b}] "
                            "disagrees with its plain version (every field "
                            "bit for bit) or misses a branch")
                if not obstacles:
                    continue
                res, ref = kernel(B_BENCH), plain_fn(B_BENCH)
                a = agreement(res, ref)
                ms = cuda_ms(lambda: kernel(B_BENCH))
                alone_ms = device_ms(lambda: kernel(B_BENCH), 20)
                plain_ms = cuda_ms(lambda: plain_fn(B_BENCH), reps=3)
                rows_read = (int(torch.unique(pids).numel())
                             if variant == "tree" else B_BENCH)
                bound_ms, bound_by, flops, nbytes = steer_bound(
                    res, rows_read, t["ncirc"], variant == "tree", name,
                    t["limits"])
                log(f"kernel D steer_rollout[{name}, {variant}] B={B_BENCH}: "
                    f"kernel_ms={ms:.4f} device_ms={alone_ms:.4f} (alone) "
                    f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} "
                    f"({bound_by}; {flops:.4g} fp32 flops, {nbytes:.4g} "
                    "bytes) (no PyTorch call computes a closed-loop "
                    "rollout)")
                out[name][variant] = dict(
                    max_abs_err=max(a["max_dx"], a["max_du"]), ms=ms,
                    device_ms=alone_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
    return out


def phase_exp_steer_models(smi):
    """Kernel D's main path for each model of D_MODELS: the experiment's
    entry point ``exp_steer_kernel.main(model=...)`` at full width, with
    the launch counts set to 0 just before and read just after."""
    from lqrrt_tpu_torch.ops.kernels import steer_kernel as D
    from lqrrt_tpu_torch.tools import exp_steer_kernel

    out = {}
    for name in D_MODELS:
        for v in D.VARIANTS:
            D.LAUNCHES[v] = 0
        res = exp_steer_kernel.main(device="cuda", model=name)
        launches = {v: D.LAUNCHES[v] for v in ("flat", "tree")}
        log(f"exp_steer_kernel main [{name}, {smi}]: steer_rollout launches "
            f"by variant {launches}")
        for label, c in [(f"block={k}", v) for k, v in res["kernel"].items()] \
                + [("tree", res["tree"])]:
            if not (c["len_eq"] == 1.0 and c["max_dx"] == 0.0):
                raise AssertionError(f"exp_steer_kernel [{name}]: {label} "
                                     f"fails: {c}")
        if min(launches.values()) < 1:
            raise AssertionError(f"exp_steer_kernel [{name}]: a variant was "
                                 f"not launched: {launches}")
        out[name] = launches
    return out


# (label, demo module, its arguments, the NN kernel its planner takes)
DEMOS = (("boat", "boat_demo", [], "nn_const"),
         ("car", "car_demo", [], "nn_general"),
         ("quadrotor", "quadrotor_demo", [], "nn_general"),
         ("double integrator", "double_integrator_demo", [], "nn_const"),
         ("boat replan loop", "boat_demo", ["--replan"], "nn_const"))


def phase_demos(smi):
    """The four demos and the boat's replan loop through their entry
    points (``lqrrt_tpu_torch.demos.<model>_demo.main``) on the card, at the
    demos' own width (batch 256, capacity 8192; the quadrotor 128 and 4096)
    with no figure: each must return 0 (the goal reached, clearance > 0,
    the tracked position within the demo's tolerance; the replan loop's
    within 1 m).  The kernels' counts are set to 0 just before each demo
    and read just after: its NN kernel (A for a constant lqr, C for a
    re-linearized one) must have launched.  Returns {label: launches}."""
    import importlib

    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const, nn_general
    from lqrrt_tpu_torch.ops.kernels.write_kernel import block_write

    counters = {"nn_const": nn_const, "nn_general": nn_general,
                "block_write": block_write, "steer_rollout": SteerLaunches()}
    out = {}
    for label, module, argv, nn in DEMOS:
        demo = importlib.import_module(f"lqrrt_tpu_torch.demos.{module}")
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        rc = demo.main(argv + ["--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        log(f"demo {label} [{smi}]: exit {rc}, wall {wall:.2f} s (warm-up, "
            f"plan, tracking), launches {launches}")
        if rc != 0 or launches[nn] < 1:
            raise AssertionError(f"demo {label}: exit {rc}, {nn} launches "
                                 f"{launches[nn]}")
        out[label] = launches
    return out


def pick(res, sel):
    """The candidates ``sel`` of a SteerResult."""
    from lqrrt_tpu_torch.core.steer import SteerResult

    return SteerResult(res.x_seq[..., sel], res.u_seq[..., sel],
                       res.mask[:, sel], res.length[sel], res.xnew[sel],
                       res.reached[sel], res.in_goal[sel])


def phase_d_repairs():
    """Kernel D's repairs: a parent outside [0, N) or a NaN row gives a NaN
    start row, and the saturation keeps NaN as torch.clamp does, so the
    card and the plain version give the same NaN rows.  Tree (N_BENCH
    rows, B_REPAIR candidates of ``branch_batch``): pids -1, -N, N and
    N + 7, and one pid at a NaN row of the states; flat: two NaN rows of
    x0.  On the boat's default problem (7 circles) and without obstacles
    (0 circles: the all-true predicate passes a NaN state).  The kernel is
    held bit for bit, NaN equal to NaN, against the plain version on the
    card (``gather_rows`` and ``make_steer`` on CUDA tensors: the CPU
    path's code), the tree call under sync-debug mode 'error'; and against
    the wrapper on the CPU: the bad rows bit for bit (NaN x, u and xnew,
    not reached, not in the goal; length 0 with circles, H without), the
    same NaN entries everywhere, and the finite rows with the round-parity
    phase's share (0.99) and TOL_STEER on x; u within TOL_STEER plus |K|'s
    row sum times x's difference (the CPU sums and rounds sin and cos in
    its own way)."""
    from lqrrt_tpu_torch.models import boat

    for label, prob in (("7 circles", boat.default_problem()),
                        ("0 circles", boat.default_problem(obstacles=False))):
        d_repairs(label, prob)


def d_repairs(label, prob):
    """``phase_d_repairs`` on one problem."""
    from lqrrt_tpu_torch.core.steer import make_steer
    from lqrrt_tpu_torch.ops.kernels.steer_kernel import (
        gather_rows, make_steer_kernel, make_steer_kernel_tree)
    from lqrrt_tpu_torch.tools.exp_steer_kernel import (H, agreement,
                                                        boat_K, branch_batch,
                                                        steer_args)

    args, kw = steer_args(prob)
    B, N = B_REPAIR, N_BENCH
    x0_np, xtar_np, _ = branch_batch(B, 37, prob)
    rng = np.random.default_rng(41)
    states_np = rng.uniform(-1.0, 1.0, (N, NS)).astype(np.float32)
    pids_np = rng.permutation(N)[:B].astype(np.int32)
    states_np[pids_np] = x0_np
    pids_np[:4] = (-1, -N, N, N + 7)
    states_np[pids_np[4]] = np.nan
    x0_np[[5, 6]] = np.nan
    KN_np = (boat_K(prob) * rng.uniform(0.5, 1.5, (N, 1, 1))).astype(
        np.float32)
    KB_np = np.broadcast_to(boat_K(prob), (B, 3, NS)).copy()
    ksum = float(np.abs(KN_np).sum(-1).max())
    plain = make_steer(*args, **kw)
    tree = make_steer_kernel_tree(*args, **kw)
    flat = make_steer_kernel(*args, **kw)
    # a NaN state fails every circle and passes the all-true predicate
    bad_length = 0 if len(prob["constraints"].is_feasible.circles[1]) else H

    def inputs(dev):
        return [torch.as_tensor(a, device=dev) for a in
                (states_np, KN_np, pids_np, x0_np, KB_np, xtar_np,
                 prob["goal"])]

    cases = {
        "tree": (lambda s, KN, p, x0, KB, xt, g: tree(s, KN, p, xt, g),
                 lambda s, KN, p, x0, KB, xt, g: plain(
                     *gather_rows(s, KN, p), xt, g), [0, 1, 2, 3, 4]),
        "flat": (lambda s, KN, p, x0, KB, xt, g: flat(x0, KB, xt, g),
                 lambda s, KN, p, x0, KB, xt, g: plain(x0, KB, xt, g),
                 [5, 6]),
    }
    gpu, cpu = inputs("cuda"), inputs("cpu")
    floats, exact = ("x_seq", "u_seq", "xnew"), ("length", "reached",
                                                 "in_goal")
    for variant, (kernel, plain_fn, bad) in cases.items():
        what = f"kernel D repairs [{variant}, {label}]"
        kernel(*gpu)             # the constants' first copy to the card
        torch.cuda.synchronize()
        if variant == "tree":
            torch.cuda.set_sync_debug_mode("error")
        try:
            res = kernel(*gpu)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref = plain_fn(*gpu)
        torch.cuda.synchronize()
        for f in floats:
            torch.testing.assert_close(getattr(res, f), getattr(ref, f),
                                       rtol=0, atol=0, equal_nan=True,
                                       msg=f"{what} {f} vs the plain "
                                       "version")
        for f in exact:
            if not torch.equal(getattr(res, f), getattr(ref, f)):
                raise AssertionError(f"{what}: {f} differs from the plain "
                                     "version")
        res = type(res)(*(t.cpu() for t in res))
        ref_cpu = kernel(*cpu)
        for f in floats:
            if not torch.equal(getattr(res, f).isnan(),
                               getattr(ref_cpu, f).isnan()):
                raise AssertionError(f"{what}: {f} is NaN elsewhere than "
                                     "on the CPU")
        sel = torch.tensor(bad)
        for r in (res, ref_cpu):
            r = pick(r, sel)
            if not (bool((r.length == bad_length).all())
                    and not r.reached.any() and not r.in_goal.any()
                    and all(bool(getattr(r, f).isnan().all())
                            for f in floats)):
                raise AssertionError(f"{what}: a bad row is not a NaN "
                                     f"rollout of length {bad_length}")
        bad_card, bad_cpu = pick(res, sel), pick(ref_cpu, sel)
        for f in floats + exact:
            torch.testing.assert_close(getattr(bad_card, f),
                                       getattr(bad_cpu, f), rtol=0, atol=0,
                                       equal_nan=True)
        good = torch.ones(B, dtype=torch.bool)
        good[sel] = False
        a = agreement(pick(res, good), pick(ref_cpu, good))
        log(f"{what} B={B} bad rows {bad}: card vs the plain version on "
            "the card bit for bit, NaN equal: ok; card vs the CPU: the "
            f"same NaN entries, bad rows NaN rollouts of length {bad_length}"
            f" on both; finite rows len_eq={a['len_eq']:.6f} "
            f"in_goal_eq={a['in_goal_eq']:.6f} "
            f"reached_eq={a['reached_eq']:.6f} max_abs_dx={a['max_dx']:.3e} "
            f"max_abs_du={a['max_du']:.3e} (u carries x's difference times "
            f"|K|'s row sum, up to {ksum:.0f})")
        if not (min(a["len_eq"], a["in_goal_eq"], a["reached_eq"]) >= 0.99
                and max(a["max_dx"], a["max_dxnew"]) <= TOL_STEER
                and a["max_du"] <= TOL_STEER + ksum * a["max_dx"]):
            raise AssertionError(f"{what}: the finite rows disagree with "
                                 "the CPU")


def phase_f1():
    """F1, ``make_steer_kernel_dv`` (kernel D with ``batch_tile`` threads
    a block), against the plain steer on
    ``branch_batch`` at B = 8192, H = 100, batch_tile 512 and 1024, with
    phase D's gates."""
    from lqrrt_tpu_torch.ops.kernels.steer_kernel import make_steer_kernel_dv
    from lqrrt_tpu_torch.tools.exp_steer_dv import BATCH_TILES
    from lqrrt_tpu_torch.tools.exp_steer_kernel import (agreement,
                                                        branch_counts,
                                                        device_ms)
    from lqrrt_tpu_torch.tools.kernel_times import (same_result, steer_bound,
                                                    steer_calls, steer_inputs)

    dev = "cuda"
    t = steer_inputs(dev, B_BENCH, 19, N_BENCH)
    x0_np, xtar_np, ncirc = t["x0_np"], t["xtar_np"], t["ncirc"]
    x0, xtar, KB, goal, args, kw = (t[k] for k in ("x0", "xtar", "KB",
                                                  "goal", "args", "kw"))
    plain = steer_calls(t)["flat"][1]
    ref = plain()
    plain_ms = cuda_ms(plain, reps=3)
    out = dict(batch_tile_ms={}, batch_tile_device_ms={}, max_abs_err=0.0,
               plain_ms=plain_ms)
    for bt in BATCH_TILES:
        dv = make_steer_kernel_dv(*args, batch_tile=bt, **kw)
        res = dv(x0, KB, xtar, goal)
        torch.cuda.synchronize()
        a = agreement(res, ref)
        counts = branch_counts(res, x0_np, xtar_np)
        same = same_result(res, ref)
        finite = bool(torch.isfinite(res.x_seq).all()
                      and torch.isfinite(res.u_seq).all())
        alone_ms = device_ms(lambda: dv(x0, KB, xtar, goal), 20)
        ms = cuda_ms(lambda: dv(x0, KB, xtar, goal))
        bound_ms, bound_by, flops, nbytes = steer_bound(res, B_BENCH, ncirc,
                                                        False)
        log(f"F1 steer_rollout_dv batch_tile={bt} B={B_BENCH} "
            f"H={res.x_seq.shape[0]}: bit_exact={same} "
            f"len_eq={a['len_eq']:.6f} in_goal_eq={a['in_goal_eq']:.6f} "
            f"reached_eq={a['reached_eq']:.6f} max_abs_dx={a['max_dx']:.3e} "
            f"max_abs_du={a['max_du']:.3e} branches={counts} "
            f"kernel_ms={ms:.4f} device_ms={alone_ms:.4f} (alone) "
            f"plain_ms={plain_ms:.3f} bound_ms={bound_ms:.4f} ({bound_by}; "
            f"{flops:.4g} fp32 flops, {nbytes:.4g} bytes)")
        if not (same and finite and min(a["len_eq"], a["in_goal_eq"],
                                        a["reached_eq"]) >= 0.999
                and max(a["max_dx"], a["max_du"], a["max_dxnew"])
                <= TOL_STEER and min(counts.values()) > 0):
            raise AssertionError(f"F1 [batch_tile={bt}] disagrees with the "
                                 "plain steer (every field bit for bit) or "
                                 "misses a branch")
        out["batch_tile_ms"][bt] = ms
        out["batch_tile_device_ms"][bt] = alone_ms
        out["max_abs_err"] = max(out["max_abs_err"], a["max_dx"],
                                 a["max_du"])
    out.update(ms=out["batch_tile_ms"][BATCH_TILES[0]],
               device_ms=out["batch_tile_device_ms"][BATCH_TILES[0]],
               bound_ms=bound_ms, bound_by=bound_by)
    return out


def phase_ragged():
    """A ragged batch: kernel D flat and tree and F1 at batch tiles 512 and
    1024 at B = B_RAGGED (``kernel_times.steer_inputs``, seed 19, a tree of
    N_BENCH rows) against the plain steer on the card, every field bit for
    bit; and F4's probes B and C at B = B_PROBE_RAGGED, and at the tool's
    B = 1024 from a pointer 4 bytes past 16-byte alignment (no float4
    path), against their plain versions, bit for bit; F2's twelve stages
    at B = B_RAGGED on the tool's data and F3's six at B = B_PROBE_RAGGED
    on all ones and on ``branch_inputs`` against their plain versions on
    the card, bit for bit.  These launches check; they are not the main
    paths'."""
    from lqrrt_tpu_torch.ops.kernels import scaffold_probes as P
    from lqrrt_tpu_torch.ops.kernels import steer_stages as S
    from lqrrt_tpu_torch.tools.dbg_steer_kernel import branch_inputs
    from lqrrt_tpu_torch.tools.exp_steer_stages import stage_inputs
    from lqrrt_tpu_torch.tools.kernel_times import (same_result, stage_exact,
                                                    steer_calls, steer_inputs)

    t = steer_inputs("cuda", B_RAGGED, 19, N_BENCH)
    failed = []
    for label, (call, plain) in steer_calls(t).items():
        res, ref = call(), plain()
        torch.cuda.synchronize()
        same = same_result(res, ref)
        log(f"ragged steer_rollout[{label}] B={B_RAGGED}: bit_exact={same} "
            f"lengths {int(res.length.min())}-{int(res.length.max())}, "
            f"in_goal {int(res.in_goal.sum())}, reached "
            f"{int(res.reached.sum())}")
        if not same:
            failed.append(label)
    g = torch.Generator(device="cuda").manual_seed(43)
    flat = torch.randn(NS * 1024 + 1, generator=g, device="cuda")
    xs = {f"B={B_PROBE_RAGGED}": torch.randn(
              (NS, B_PROBE_RAGGED), generator=g, device="cuda"),
          "B=1024 unaligned": flat[1:].view(NS, 1024)}
    for label, x in xs.items():
        for name in ("B", "C"):
            same = torch.equal(P.probe(name, x), P.plain(name, x))
            log(f"ragged scaffold_probe[{P.NAMES[name]}] {label}: "
                f"bit_exact={same}")
            if not same:
                failed.append(f"probe {name} {label}")
    b3 = B_PROBE_RAGGED
    stage_ins = [(S.build, S.F2, "tool data", stage_inputs(B_RAGGED, 0,
                                                          "cuda")),
                 (S.run_stage, S.F3, "ones", [
                     torch.ones(sh, device="cuda")
                     for sh in ((NS, b3), (3, NS, b3), (NS, b3))]),
                 (S.run_stage, S.F3, "branches", branch_inputs(b3, 0,
                                                                "cuda"))]
    for wrap, stages, what, ins in stage_ins:
        bad = [st for st in stages
               if not stage_exact(st, wrap(st)(*ins), S.plain(st, *ins))]
        log(f"ragged steer_stage B={ins[0].shape[1]} on {what}: "
            f"{len(stages) - len(bad)} of {len(stages)} stages bit for bit"
            + (f", differing: {bad}" if bad else ""))
        failed += [f"stage {st} B={ins[0].shape[1]} {what}" for st in bad]
    if failed:
        raise AssertionError(f"ragged batches differ from their plain "
                             f"versions: {failed}")


def phase_circle_counts():
    """Kernel D flat and tree and F1 at batch tiles 512 and 1024 at
    B = B_BENCH against the plain steer on the card, every field bit for
    bit, at the circle counts that take the other paths of the circles
    test: 0 (no obstacles), 10 (``hard_problem``) and 64 (the most the
    rollout takes), from ``kernel_times.circle_problems``.  These launches
    check; they are not the main paths'."""
    from lqrrt_tpu_torch.tools.kernel_times import (circle_problems,
                                                    same_result, steer_calls,
                                                    steer_inputs)

    failed = []
    for label, prob in circle_problems().items():
        if label == "7 circles":   # phases D and F1
            continue
        t = steer_inputs("cuda", B_BENCH, 19, N_BENCH, prob)
        for variant, (call, plain) in steer_calls(t).items():
            res, ref = call(), plain()
            torch.cuda.synchronize()
            same = same_result(res, ref)
            stops = int((~res.in_goal & ~res.reached
                         & (res.length < res.x_seq.shape[0])).sum())
            log(f"{label} steer_rollout[{variant}] B={B_BENCH}: "
                f"bit_exact={same} lengths {int(res.length.min())}-"
                f"{int(res.length.max())}, infeasible stops {stops}, "
                f"in_goal {int(res.in_goal.sum())}")
            if not same:
                failed.append(f"{label} {variant}")
    if failed:
        raise AssertionError(f"the rollout differs from the plain steer: "
                             f"{failed}")


def phase_exp_steer_dv(smi):
    """F1's main path: the experiment's entry point at full width, with
    the launch counts set to 0 just before and read just after."""
    from lqrrt_tpu_torch.ops.kernels import steer_kernel as D
    from lqrrt_tpu_torch.tools import exp_steer_dv

    for v in D.VARIANTS:
        D.LAUNCHES[v] = 0
    res = exp_steer_dv.main(device="cuda")
    launches = dict(D.LAUNCHES)
    log(f"exp_steer_dv main [{smi}]: steer_rollout launches by variant "
        f"{launches}")
    for bt, c in res["kernel"].items():
        if not (c["len_eq"] >= 0.999 and c["max_dx"] <= TOL_STEER):
            raise AssertionError(f"exp_steer_dv: batch_tile={bt} fails: {c}")
    if launches["dv"] < 1:
        raise AssertionError("exp_steer_dv: the dv variant was not launched")
    return launches["dv"]


def phase_f2():
    """Every configuration of the stage scaffold (F2,
    ``steer_stages.build``) against its plain version on the card at
    B = 8192, H = 100 on the tool's data (x0 ~ N(0, 1), K ~ 0.1 N(0, 1),
    xtar ~ 5 N(0, 1)): length equal, xs and us bit for bit (only xs[0]
    and us[0] for identity_nostore, which stores nothing else), since the
    kernel rounds every operation alone in the plain version's order.
    ``full`` sums e * e over the 6 state rows as torch.sum over dim 0 does
    on the card (``sum6_rows``); the share of columns on which that order
    is torch's is printed.  Returns, per stage, the largest difference,
    the plain version's ms and the bound of this data's work
    (``kernel_times.stage_bound`` over ``stage_steps``)."""
    from lqrrt_tpu_torch.ops.kernels import steer_stages as S
    from lqrrt_tpu_torch.tools.exp_steer_stages import stage_inputs
    from lqrrt_tpu_torch.tools.kernel_times import stage_bound, stage_steps

    x0T, KT, tarT = stage_inputs(B_BENCH, 0, "cuda")
    a = torch.randn((6, 65536), generator=torch.Generator(device="cuda")
                    .manual_seed(31), device="cuda") * 100.0
    rows = (((a[0] + a[4]) + (a[1] + a[5])) + a[2]) + a[3]
    log(f"F2: torch.sum over dim 0 of (6, B) in sum6_rows' order on "
        f"{(rows == a.sum(0)).double().mean().item():.6f} of columns")
    out, failed = {}, []
    for stage in S.F2:
        xs, us, length = S.build(stage)(x0T, KT, tarT)
        rxs, rus, rlength = S.plain(stage, x0T, KT, tarT)
        torch.cuda.synchronize()
        bound = stage_bound(stage, B_BENCH, S.H, stage_steps(stage, x0T, xs))
        sl = slice(0, 1) if stage == "identity_nostore" else slice(None)
        xs, us, rxs, rus = xs[sl], us[sl], rxs[sl], rus[sl]
        len_eq = torch.equal(length, rlength)
        same = torch.equal(xs, rxs) and torch.equal(us, rus)
        err = max((xs - rxs).abs().max().item(),
                  (us - rus).abs().max().item())
        finite = bool(torch.isfinite(xs).all() and torch.isfinite(us).all())
        plain_ms = cuda_ms(lambda: S.plain(stage, x0T, KT, tarT), reps=1)
        ok = len_eq and finite and same
        log(f"F2 steer_stages[{stage}] B={B_BENCH} H={S.H}: "
            f"len_eq={len_eq} bit_exact={same} max_abs_d={err:.3e} "
            f"finite={finite} plain_ms={plain_ms:.3f}"
            + ("" if ok else " FAILED"))
        if not ok:
            failed.append(stage)
        out[stage] = dict(max_abs_err=err, plain_ms=plain_ms, bound=bound)
    if failed:
        raise AssertionError(f"F2: stages disagree with their plain "
                             f"versions: {failed}")
    return out


def phase_exp_steer_stages(smi):
    """F2's main path: the experiment's entry point at full width (B =
    8192, H = 100, D's geometry), with the launch counts set to 0 just
    before and read just after.  Returns its stage times and the
    launches."""
    from lqrrt_tpu_torch.ops.kernels import steer_stages as S
    from lqrrt_tpu_torch.tools import exp_steer_stages

    for k in S.LAUNCHES:
        S.LAUNCHES[k] = 0
    res = exp_steer_stages.main(device="cuda")
    launches = {k: S.LAUNCHES[k] for k in S.F2}
    log(f"exp_steer_stages main [{smi}]: steer_stage launches by stage "
        f"{launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"exp_steer_stages: a stage was not launched: "
                             f"{launches}")
    return res, launches


def phase_f3_f4(smi):
    """F3 and F4's main paths, ``dbg_steer_kernel.main`` and
    ``dbg_steer_scaffold.main`` (every stage and probe built, launched and
    equal to its plain version; F3's on the tool's all-ones inputs and on
    ``branch_inputs``), with the launch counts set to 0 just before and
    read just after.  Then F3's stages on ``branch_inputs`` (B = 1024)
    against their plain versions on the card, bit for bit, with the
    branches full must take there: the goal group stops at the goal box
    (which feasibility alone does not), the near group arrives at once
    (length 0) and the buoy group stops at the circles.  Then each stage's
    and probe's time at the tools' shapes (B = 1024, H = 100) beside its
    plain version's (for the probes, the library call)."""
    from lqrrt_tpu_torch.ops.kernels import scaffold_probes as P
    from lqrrt_tpu_torch.ops.kernels import steer_stages as S
    from lqrrt_tpu_torch.tools import dbg_steer_kernel, dbg_steer_scaffold
    from lqrrt_tpu_torch.tools.dbg_steer_kernel import branch_inputs, same
    from lqrrt_tpu_torch.tools.dbg_steer_scaffold import probe_args
    from lqrrt_tpu_torch.tools.kernel_times import (bound, probe_work,
                                                    stage_bound, stage_steps)
    from lqrrt_tpu_torch.tools.exp_steer_kernel import (GROUPS, branch_batch,
                                                        device_ms)

    for k in S.LAUNCHES:
        S.LAUNCHES[k] = 0
    for k in P.PROBES:
        P.LAUNCHES[k] = 0
    failed = (dbg_steer_kernel.main(device="cuda"),
              dbg_steer_scaffold.main(device="cuda"))
    l3, l4 = {k: S.LAUNCHES[k] for k in S.F3}, dict(P.LAUNCHES)
    log(f"dbg_steer_kernel / dbg_steer_scaffold main [{smi}]: failed "
        f"{failed}, launches by stage {l3}, by probe {l4}")
    if any(failed) or min(l3.values()) < 1 or min(l4.values()) < 1:
        raise AssertionError("F3/F4: a stage or probe failed or was not "
                             "launched")
    B, dev = dbg_steer_scaffold.B, "cuda"
    ones = [torch.ones(s, device=dev) for s in ((NS, B), (3, NS, B),
                                                (NS, B))]
    branches = branch_inputs(B, 0, dev)
    group = torch.as_tensor(branch_batch(B, 0)[2], device=dev)
    stages, lengths = {}, {}
    for stage in S.F3:
        fn = S.run_stage(stage)
        xs, length = fn(*branches)
        ref, _, ref_len = S.plain(stage, *branches)
        if not (same(xs, ref) and same(length, ref_len)
                and bool(torch.isfinite(xs).all())):
            raise AssertionError(f"F3 [{stage}] differs from its plain "
                                 "version on branch_inputs")
        lengths[stage] = {g: (int((length[group == i] == 0).sum()),
                              int(((length[group == i] > 0)
                                   & (length[group == i] < S.H)).sum()),
                              int((length[group == i] == S.H).sum()))
                          for i, g in enumerate(GROUPS)}
        ms = cuda_ms(lambda: fn(*ones))
        alone_ms = device_ms(lambda: fn(*ones), 20)
        plain_ms = cuda_ms(lambda: S.plain(stage, *ones), reps=1)
        steps = stage_steps(stage, ones[0], fn(*ones)[0])
        stages[stage] = dict(max_abs_err=(xs - ref).abs().max().item(),
                             ms=ms, device_ms=alone_ms, plain_ms=plain_ms,
                             bound=stage_bound(stage, B, S.H, steps))
        log(f"F3 steer_stage[{stage}] B={B} H={S.H}: bit_exact=True on "
            f"branch_inputs, (length 0, stopped, H) by group "
            f"{lengths[stage]}; kernel_ms={ms:.4f} device_ms={alone_ms:.4f} "
            f"(alone) plain_ms={plain_ms:.3f} "
            f"bound_ms={stages[stage]['bound'][0]:.5f} "
            f"({stages[stage]['bound'][1]})")
    full, feas = lengths["dbg_full"], lengths["dbg_feasibility"]
    if not (full["goal"][1] == sum(full["goal"]) > feas["goal"][1]
            and full["near"][0] == sum(full["near"])
            and full["buoy"][1] == feas["buoy"][1] == sum(full["buoy"])):
        raise AssertionError("F3: branch_inputs missed a branch of full "
                             "(goal box, arrived, circles)")
    probes = {}
    for name in P.PROBES:
        args = probe_args(name, dev)
        y, ref = P.probe(name, *args), P.plain(name, *args)
        ms = cuda_ms(lambda: P.probe(name, *args))
        alone_ms = device_ms(lambda: P.probe(name, *args), 20)
        library_ms = cuda_ms(lambda: P.plain(name, *args))
        library_alone = device_ms(lambda: P.plain(name, *args), 20)
        flops, nbytes = probe_work(name, B, P.H)
        probes[name] = dict(
            max_abs_err=(y - ref).abs().max().item(), ms=ms,
            device_ms=alone_ms, library_ms=library_ms,
            library_device_ms=library_alone,
            bound=bound({"fp32": flops}, nbytes), flops=flops, nbytes=nbytes)
        log(f"F4 scaffold_probe[{P.NAMES[name]}] B={B} H={P.H}: "
            f"kernel_ms={ms:.4f} device_ms={alone_ms:.4f} (alone) "
            f"library_ms={library_ms:.4f} library_device_ms="
            f"{library_alone:.4f} (its plain version) "
            f"bound_ms={probes[name]['bound'][0]:.6f} "
            f"({probes[name]['bound'][1]})")
    return l3, l4, stages, probes


def f_kernels(f1, f1_launches, f2, f2_res, f2_launches, f3, f3_launches,
              f4, f4_launches, f_ptxas):
    """The kernels line's entries of kernel F's four functions (F1-F4),
    from their phases' results and their main paths' launches; F2's and
    F3's with their launch geometry (threads, blocks) and the ptxas lines
    of the stage kernel's instances."""
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import sm_count
    from lqrrt_tpu_torch.ops.kernels.steer_kernel import rollout_geometry
    from lqrrt_tpu_torch.tools.dbg_steer_scaffold import B as F3_B
    from lqrrt_tpu_torch.tools.kernel_times import bound

    sms = sm_count(torch.device("cuda"))

    out = []
    out.append(dict(
        name="steer_rollout_dv", route="cuda",
        source="lqrrt_tpu_torch/csrc/steer_rollout.cu",
        replaces="tools/exp_steer_dv_v5.py:29", launches=f1_launches,
        **f1, library_ms=None))
    # F2: the full stage (kernel D's step without its done carry) is the
    # row's time; every stage's beside it, from the experiment's run (its
    # ``ms`` is the kernel alone, its ``wall_ms`` the call)
    stages = f2_res["stages"]
    full_bound = f2["full"]["bound"]
    out.append(dict(
        name="steer_stages", route="cuda",
        source="lqrrt_tpu_torch/csrc/steer_stages.cu",
        replaces="tools/exp_steer_stages_v5.py:54",
        launches=sum(f2_launches.values()),
        max_abs_err=max(v["max_abs_err"] for v in f2.values()),
        ms=stages["full"]["wall_ms"], device_ms=stages["full"]["ms"],
        stages_ms={k: v["wall_ms"] for k, v in stages.items()},
        stages_device_ms={k: v["ms"] for k, v in stages.items()},
        plain_ms=f2["full"]["plain_ms"],
        stages_plain_ms={k: v["plain_ms"] for k, v in f2.items()},
        bound_ms=full_bound[0], bound_by=full_bound[1],
        stages_bound_ms={k: v["bound"][0] for k, v in f2.items()},
        stages_of_bound={k: f2[k]["bound"][0] / v["ms"]
                         for k, v in stages.items()},
        geometry=rollout_geometry(B_BENCH, sms),
        steer_rollout_ms=f2_res["steer_rollout_wall_ms"],
        steer_rollout_device_ms=f2_res["steer_rollout_ms"], library_ms=None,
        ptxas=f_ptxas))
    out.append(dict(
        name="steer_stage_dbg", route="cuda",
        source="lqrrt_tpu_torch/csrc/steer_stages.cu",
        replaces="tools/dbg_steer_kernel.py:40",
        launches=sum(f3_launches.values()),
        max_abs_err=max(v["max_abs_err"] for v in f3.values()),
        ms=f3["dbg_full"]["ms"], device_ms=f3["dbg_full"]["device_ms"],
        stages_ms={k: v["ms"] for k, v in f3.items()},
        stages_device_ms={k: v["device_ms"] for k, v in f3.items()},
        plain_ms=f3["dbg_full"]["plain_ms"],
        bound_ms=f3["dbg_full"]["bound"][0],
        bound_by=f3["dbg_full"]["bound"][1],
        stages_bound_ms={k: v["bound"][0] for k, v in f3.items()},
        stages_of_bound={k: v["bound"][0] / v["device_ms"]
                         for k, v in f3.items()},
        geometry=rollout_geometry(F3_B, sms),
        library_ms=None))
    # F4: the seven probes one after another; each probe's plain version is
    # the library call itself
    p_bound = bound({"fp32": sum(v["flops"] for v in f4.values())},
                    sum(v["nbytes"] for v in f4.values()))
    out.append(dict(
        name="scaffold_probes", route="cuda",
        source="lqrrt_tpu_torch/csrc/scaffold_probes.cu",
        replaces="tools/dbg_steer_scaffold.py:18",
        launches=sum(f4_launches.values()),
        max_abs_err=max(v["max_abs_err"] for v in f4.values()),
        ms=sum(v["ms"] for v in f4.values()),
        device_ms=sum(v["device_ms"] for v in f4.values()),
        plain_ms=sum(v["library_ms"] for v in f4.values()),
        bound_ms=p_bound[0], bound_by=p_bound[1],
        library_ms=sum(v["library_ms"] for v in f4.values()),
        library_device_ms=sum(v["library_device_ms"] for v in f4.values()),
        probes={k: dict(ms=v["ms"], device_ms=v["device_ms"],
                        library_ms=v["library_ms"],
                        library_device_ms=v["library_device_ms"],
                        bound_ms=v["bound"][0], launches=f4_launches[k])
                for k, v in f4.items()}))
    return out


def phase_care(models):
    """Batched care_lqr on the card for 8192 linearizations drawn from each
    model's sample space, in fp64 as the per-node lqr solves it, against
    scipy's float64 CARE on a subsample."""
    import scipy.linalg

    from lqrrt_tpu_torch.ops import riccati

    dev = "cuda"
    for name, model in models:
        prob = model.default_problem()
        ss = torch.as_tensor(prob["sample_space"], device=dev)
        g = torch.Generator(device=dev).manual_seed(13)
        x = ss[:, 0] + torch.rand((B_BENCH, len(ss)), generator=g,
                                  device=dev) * (ss[:, 1] - ss[:, 0])
        xlin = model.x_map(x) if hasattr(model, "x_map") else x
        u = torch.zeros((B_BENCH, model.NCONTROLS), device=dev)
        A, B = riccati.linearize(model.f, xlin, u)
        q, r = lqr_weights(model)
        Q = torch.diag(torch.tensor(q, device=dev))
        R = torch.diag(torch.tensor(r, device=dev))
        # the per-node lqr solves the CARE in fp64 (ops/riccati.py)
        A, B, Q, R = (t.double() for t in (A, B, Q, R))
        S, K = riccati.care_lqr(A, B, Q, R)
        S, K = S.float(), K.float()
        lqr = model.make_lqr()
        S_cb, _ = lqr(x, u)              # the planner's callback: same math
        torch.cuda.synchronize()
        if not torch.allclose(S_cb, S, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"{name} lqr callback differs from care_lqr")
        nonfinite = int((~torch.isfinite(S)).any((-1, -2)).sum().item()
                        + (~torch.isfinite(K)).any((-1, -2)).sum().item())
        sub = torch.arange(0, B_BENCH, B_BENCH // 64)
        A64, B64 = A[sub].double().cpu().numpy(), B[sub].double().cpu().numpy()
        S_sub = S[sub].double().cpu().numpy()
        Qn, Rn = (t.double().cpu().numpy() for t in (Q, R))
        rel = 0.0
        for i in range(len(sub)):
            P = scipy.linalg.solve_continuous_are(A64[i], B64[i], Qn, Rn)
            rel = max(rel, float(np.abs(S_sub[i] - P).max()
                                 / np.abs(P).max()))
        care_ms = cuda_ms(lambda: riccati.care_lqr(A, B, Q, R), reps=5)
        lqr_ms = cuda_ms(lambda: lqr(x, u), reps=5)
        log(f"batched CARE {name} x{B_BENCH} (n={A.shape[-1]}, "
            f"m={B.shape[-1]}): max_rel_err_vs_scipy={rel:.3e} "
            f"(64 systems, float64) nonfinite={nonfinite} "
            f"care_lqr_ms={care_ms:.3f} lqr_ms={lqr_ms:.3f} "
            f"(Jacobians + CARE)")
        if nonfinite or not rel <= TOL_CARE:
            raise AssertionError(f"batched CARE fails for the {name}")


def lqr_weights(model):
    """(Q, R) diagonals of the model's default make_lqr."""
    import inspect

    d = inspect.signature(model.make_lqr).parameters
    return d["q"].default, d["r"].default


def phase_round_parity(name, prob, nearest_fn):
    """One round at B=512, capacity=4096 on the card vs on the CPU."""
    from lqrrt_tpu_torch.core.rounds import (RoundSpec, commit_candidates,
                                             make_expand)
    from lqrrt_tpu_torch.core.tree import init_tree

    n, m = prob["constraints"].nstates, prob["constraints"].ncontrols
    B, cap = 512, 4096
    H = int(round(prob["horizon"] / prob["dt"]))
    spec = RoundSpec(nstates=n, ncontrols=m, batch=B, horizon_steps=H,
                     capacity=cap, dt=prob["dt"], nn_block=1024, slack=1024)
    rng = np.random.default_rng(11)
    lo, hi = prob["sample_space"][:, 0], prob["sample_space"][:, 1]
    xrands = [rng.uniform(lo, hi, (B, n)).astype(np.float32)
              for _ in range(4)]
    wrap_mask = np.zeros(n, bool)
    wrap_mask[list(prob["wrap_dims"])] = True

    def run(device, tree=None):
        expand = make_expand(spec, prob["dynamics"], prob["lqr"],
                             prob["erf"], prob["constraints"].is_feasible,
                             0.05, prob["constraints"].goal_buffer,
                             wrap_mask=wrap_mask, saturate=prob["saturate"],
                             nearest_fn=nearest_fn)
        goal = torch.as_tensor(prob["goal"], device=device)
        if tree is None:
            x0 = torch.as_tensor(prob["x0"], device=device)
            S0, K0 = prob["lqr"](x0, torch.zeros(m, device=device))
            tree = init_tree(cap, H, n, m, x0, S0, K0,
                             torch.tensor(1.0, device=device),
                             torch.tensor(False, device=device),
                             slack=1024, root_pad=512)
            for xr in xrands[:3]:
                commit_candidates(spec, tree, expand(
                    tree, torch.as_tensor(xr, device=device), goal))
        c = expand(tree, torch.as_tensor(xrands[3], device=device), goal)
        return tree, c

    tree_cpu, _ = run("cpu")
    tree_gpu = type(tree_cpu)(*[t.to("cuda") for t in tree_cpu])
    _, c_cpu = run("cpu", tree_cpu)
    _, c_gpu = run("cuda", tree_gpu)
    pid_cpu, pid_gpu = c_cpu.pids.long(), c_gpu.pids.cpu().long()
    pid_match = (pid_cpu == pid_gpu).double().mean().item()
    # with a per-node S an empty-rollout row (a copy of its parent's state)
    # no longer ties its parent exactly: a pick of the same state, bit for
    # bit, is an equivalent pick
    equiv = (tree_cpu.state[pid_cpu] == tree_cpu.state[pid_gpu]).all(1)
    equiv_match = equiv.double().mean().item()
    xr64 = torch.as_tensor(xrands[3], dtype=torch.float64)
    st64, S64 = tree_cpu.state.double(), tree_cpu.S.double()
    wrap = prob["wrap_dims"][0]
    excess = rel_excess(
        wrapped_cost64(xr64, st64[pid_gpu], S64[pid_gpu], wrap),
        wrapped_cost64(xr64, st64[pid_cpu], S64[pid_cpu], wrap))
    len_match = (c_cpu.length == c_gpu.length.cpu()).double().mean().item()
    same = (c_cpu.length == c_gpu.length.cpu()) & equiv
    dx = (c_cpu.x_seq - c_gpu.x_seq.cpu()).abs()[:, :, same]
    max_dx = float(dx.max()) if dx.numel() else 0.0
    dS = ((c_cpu.S_new - c_gpu.S_new.cpu()).abs()[same].amax((-1, -2))
          / c_cpu.S_new[same].abs().amax((-1, -2)).clamp(min=1e-6))
    max_dS = float(dS.max()) if dS.numel() else 0.0
    log(f"round parity {name} card vs cpu (B={B}, capacity={cap}): "
        f"pid_match={pid_match:.4f} equivalent_pick_match={equiv_match:.4f} "
        f"nn_fp64_excess={excess:.3e} length_match={len_match:.4f} "
        f"max_abs_x_seq_err={max_dx:.3e} max_rel_S_new_err={max_dS:.3e}")
    if not (equiv_match >= 0.99 and excess <= TOL_EXCESS
            and len_match >= 0.99 and max_dx <= 1e-3
            and max_dS <= TOL_CARE
            and bool(torch.isfinite(c_gpu.x_seq).all())):
        raise AssertionError(f"the card's {name} round disagrees with the "
                             "CPU's")


def check_plan(prob, planner, feas=None, goal_box=True):
    """Finite, of the right shapes, from x0, feasible under ``feas`` (the
    problem's predicate by default) at every state, in the goal box when
    ``goal_box``, and dynamically consistent."""
    n, m = prob["constraints"].nstates, prob["constraints"].ncontrols
    x_seq, u_seq = planner.x_seq, planner.u_seq
    if not (np.all(np.isfinite(x_seq)) and np.all(np.isfinite(u_seq))
            and x_seq.shape[1] == n and u_seq.shape == (len(x_seq) - 1, m)):
        raise AssertionError("plan has the wrong shape or non-finite values")
    if not np.allclose(x_seq[0], prob["x0"], atol=1e-5):
        raise AssertionError("plan does not start at x0")
    feas = feas or prob["constraints"].is_feasible
    if not bool(feas(torch.as_tensor(x_seq[1:]),
                     torch.as_tensor(u_seq)).all()):
        raise AssertionError("plan infeasible at some step")
    wrap = list(prob["wrap_dims"])
    e = prob["goal"] - x_seq[-1]
    e[wrap] = (e[wrap] + np.pi) % (2 * np.pi) - np.pi
    if goal_box and not np.all(
            np.abs(e) <= prob["constraints"].goal_buffer + 0.1):
        raise AssertionError(f"plan ends outside the goal box: {e}")
    xn = prob["dynamics"](torch.as_tensor(x_seq[:-1]), torch.as_tensor(u_seq),
                          prob["dt"]).numpy()
    d = xn - x_seq[1:]
    d[:, wrap] = (d[:, wrap] + np.pi) % (2 * np.pi) - np.pi
    err = np.max(np.abs(d), axis=1)
    if not (np.median(err) < 1e-3 and np.max(err) < 0.2):
        raise AssertionError(f"plan not dynamically consistent: median "
                             f"{np.median(err)}, max {np.max(err)}")


class SteerLaunches:
    """Kernel D's flat launches (``steer_kernel.LAUNCHES["flat"]``, counted
    where D launches), read and set as ``.launches`` as the other kernels'
    counters are."""

    @property
    def launches(self):
        from lqrrt_tpu_torch.ops.kernels import steer_kernel
        return steer_kernel.LAUNCHES["flat"]

    @launches.setter
    def launches(self, value):
        from lqrrt_tpu_torch.ops.kernels import steer_kernel
        steer_kernel.LAUNCHES["flat"] = value


def replan(name, prob, planner, bias, budget, smi, counters):
    """One timed update_plan with the kernels' counts set to 0 just before
    and read just after; returns (goal reached, launches)."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=bias, specific_time=budget,
                                  pruning=True)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = planner.stats
    log(f"{name} replan {budget} s [{smi}]: goal={reached} "
        f"nn={planner.nn_selected} "
        f"expansions_per_s={st['expansions_per_s']:.1f} "
        f"rounds={st['rounds']} restarts={st['restarts']} "
        f"elapsed_s={st['elapsed_s']:.4f} total_s={st['total_s']:.4f} "
        f"plan_duration_s={st['plan_duration_s']:.2f} "
        f"nodes={st['nodes']} tree_rows={st['tree_rows']} "
        f"peak_mem_GiB={peak:.2f} launches={launches}")
    return reached, launches


def phase_main_path(name, prob, smi, bias, budget, nn, extra_budgets=()):
    """The replan at full width through nn (the kernel the planner must
    pick) and kernel D, the steer it must select and launch, then one chunk
    under sync-debug mode 'error'."""
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const, nn_general
    from lqrrt_tpu_torch.ops.kernels.write_kernel import block_write

    counters = {nn: {"nn_const": nn_const, "nn_general": nn_general}[nn],
                "block_write": block_write, "steer_rollout": SteerLaunches()}
    planner = full_width_planner(prob)
    t0 = time.perf_counter()
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=bias)
    torch.cuda.synchronize()
    log(f"{name} warmup: {time.perf_counter() - t0:.3f} s")
    if planner.nn_selected != nn or planner.steer_selected != "kernel":
        raise AssertionError(f"{name}: NN is {planner.nn_selected}, not "
                             f"{nn}, or the steer {planner.steer_selected},"
                             " not kernel")

    reached, launches = replan(name, prob, planner, bias, budget, smi,
                               counters)
    if not reached:
        raise AssertionError(f"{name}: goal not reached: {planner.stats}")
    check_plan(prob, planner)
    if min(launches[nn], launches["block_write"],
           launches["steer_rollout"]) < 1:
        raise AssertionError(f"{name}: a kernel was not launched: "
                             f"{launches}")
    log(f"{name} plan checks: starts at x0, feasible, ends in goal box, "
        "dynamically consistent")
    for b in extra_budgets:
        replan(name, prob, planner, bias, b, smi, counters)

    # one restart chunk with every host sync turned into an error
    chunk = planner._get_restart_chunk(None, 0)
    x0 = planner._tensor(prob["x0"])
    cur = planner._seed_tree(x0, planner.goal)
    best = planner._seed_tree(x0, planner.goal)
    pool = planner._tensor(np.linspace(prob["x0"], prob["goal"], 256))
    score = planner._tensor(planner._RSCORE0)
    ss = planner._tensor(prob["sample_space"])
    gb = planner._tensor(bias)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk(cur, best, pool, score, 0, planner.goal, ss, gb, planner.goal)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    n_cycles, F = planner._restart_chunk_shape
    log(f"{name} sync-free chunk ({n_cycles}x{F} rounds) under "
        f"sync_debug_mode='error': ok, enqueue_s={enqueue:.3f} "
        f"total_s={total:.3f}")
    return launches


def same_bits(a, b):
    """Two tensors of one shape hold the same values: float32 bit for bit
    (NaN for NaN), any other dtype equal."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return bool(bits_equal(a, b).all())
    return bool(torch.equal(a, b))


def phase_steer_route(name, prob, smi, bias):
    """Kernel D under the planner's steer (phase 8') on problem ``name``
    (the boat's circles, then its raster): what each planner selects, D
    against the plain steer inside the restart chunk (bit for bit), in the
    prune and in the finish, the chunk sync-free, and a replan of each.
    The plain planner is built while D's factory refuses every problem, so
    its router keeps the plain steer.  D's launches are
    ``steer_kernel.LAUNCHES["flat"]``, set to 0 before each step and read
    after it."""
    from lqrrt_tpu_torch.core.tree import best_node
    from lqrrt_tpu_torch.ops.kernels import steer_kernel

    launches = SteerLaunches()
    kern = full_width_planner(prob)
    kern_chunk = kern._get_restart_chunk(None, 0)
    real = steer_kernel.make_steer_kernel

    def refuse(*args, **kw):
        raise NotImplementedError("the plain steer, for the comparison")

    steer_kernel.make_steer_kernel = refuse
    try:
        plain = full_width_planner(prob)
        plain_chunk = plain._get_restart_chunk(None, 0)
        H = plain.horizon_steps
        plain_steers = (plain._get_steer(), plain._get_steer(3 * H))
        plain_selected = plain.steer_selected
    finally:
        steer_kernel.make_steer_kernel = real
    selected = (kern.steer_selected, plain_selected)
    log(f"steer route {name}: selected {selected[0]} (plain-built "
        f"{selected[1]})")
    if selected != ("kernel", "scan"):
        raise AssertionError(f"steer route {name}: selected {selected}, "
                             "not ('kernel', 'scan')")

    def inputs(p, seed):
        p._gen.manual_seed(seed)
        x0 = p._tensor(prob["x0"])
        return (p._seed_tree(x0, p.goal), p._seed_tree(x0, p.goal),
                p._tensor(np.linspace(prob["x0"], prob["goal"], 256)),
                p._tensor(p._RSCORE0), 0, p.goal,
                p._tensor(prob["sample_space"]), p._tensor(bias), p.goal)

    def run(p, chunk, seed):
        args = inputs(p, seed)
        launches.launches = 0
        t0 = time.perf_counter()
        chunk(*args)
        torch.cuda.synchronize()
        return args, launches.launches, time.perf_counter() - t0

    for p, chunk in ((kern, kern_chunk), (plain, plain_chunk)):
        run(p, chunk, 1)                              # warm-up
    (kc, kb, kpool, ksc, *_), k_launch, k_s = run(kern, kern_chunk, 2)
    (pc, pb, ppool, psc, *_), p_launch, p_s = run(plain, plain_chunk, 2)
    rounds = int(np.prod(kern._restart_chunk_shape))
    fields = {f"{which}.{name}": (a, b)
              for which, (ta, tb) in (("cur", (kc, pc)), ("best", (kb, pb)))
              for name, a, b in zip(ta._fields, ta, tb)}
    fields.update(pool=(kpool, ppool), score=(ksc, psc))
    differ = [k for k, (a, b) in fields.items() if not same_bits(a, b)]
    log(f"steer route {name} chunk ({rounds} rounds, seed 2): D {k_s:.3f} s, "
        f"{k_launch} launches; plain {p_s:.3f} s, {p_launch} launches; "
        f"size {int(kb.size)}, goal_found {bool(kb.goal_found)}; "
        f"{len(fields)} fields, differing: {differ}")
    if differ or k_launch != rounds or p_launch != 0:
        raise AssertionError(f"steer route {name} chunk: fields {differ} "
                             f"differ, or D launched {k_launch} times (want "
                             f"{rounds}) and the plain chunk {p_launch}")

    # the prune of the best chain, both ways
    bid = int(best_node(kb))
    xk, uk = kern._extract(kb, bid)
    xp, up = plain._extract(pb, bid)
    chain = len(kern._last_edges[0])
    launches.launches = 0
    pk = kern._prune(xk, uk)
    torch.cuda.synchronize()
    k_launch = launches.launches
    launches.launches = 0
    pp = plain._prune(xp, up)
    torch.cuda.synchronize()
    prune_launches = (k_launch, launches.launches)
    same = all(np.array_equal(a, b) for a, b in
               ((xk, xp), (uk, up), (pk[0], pp[0]), (pk[1], pp[1])))
    log(f"steer route {name} prune: chain {chain} nodes, plan {len(xk)} -> "
        f"{len(pk[0])} states, same plan {same}, D launches (D, plain) "
        f"{prune_launches}")
    want = (int(chain > 3), 0)
    if not same or prune_launches != want:
        raise AssertionError(f"steer route {name} prune: same plan {same}, "
                             f"D launches {prune_launches} (want {want})")

    # the prune's (1024 rows) and the finish's (3H steps, 8 rows) steers
    live = int(kb.size)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for label, steer_k, steer_p, rows in (
            ("prune", kern._get_steer(), plain_steers[0], 1024),
            ("finish", kern._get_steer(3 * H), plain_steers[1], 8)):
        src = torch.randint(0, live, (rows,), generator=gen, device="cuda")
        dst = torch.randint(0, live, (rows,), generator=gen, device="cuda")
        x0, K, xtar = kb.state[src], kb.K[src], kb.state[dst]
        launches.launches = 0
        rk = steer_k(x0, K, xtar)
        k_launch = launches.launches
        rp = steer_p(x0, K, xtar)
        routes = (k_launch, launches.launches - k_launch)
        differ = [name for name, a, b in zip(rk._fields, rk, rp)
                  if not same_bits(a, b)]
        log(f"steer route {name} {label} steer: {rows} rows, D launches (D, "
            f"plain) {routes}, mean length "
            f"{float(rk.length.float().mean()):.2f}, differing: {differ}")
        if differ or routes != (1, 0):
            raise AssertionError(f"steer route {name} {label}: {differ} "
                                 f"differ, or D launches {routes} (want "
                                 "(1, 0))")

    # D's chunk with every host sync an error
    args = inputs(kern, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        kern_chunk(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    log(f"steer route {name} sync-free D chunk under sync_debug_mode="
        f"'error': ok, enqueue_s={enqueue:.4f} "
        f"total_s={time.perf_counter() - t0:.4f}")

    # a 1.0 s replan each way
    replan_launches = {}
    for label, p in (("D", kern), ("plain", plain)):
        p.warmup(prob["x0"], prob["sample_space"], goal_bias=bias)
        launches.launches = 0
        p.update_plan(prob["x0"], prob["sample_space"], goal_bias=bias,
                      specific_time=1.0, pruning=True)
        torch.cuda.synchronize()
        replan_launches[label] = launches.launches
        st = p.stats
        log(f"steer route {name} replan 1.0 s, {label} [{smi}]: "
            f"goal={st['goal_found']} rounds={st['rounds']} "
            f"expansions_per_s={st['expansions_per_s']:.1f} "
            f"elapsed_s={st['elapsed_s']:.4f} "
            f"post_s={st['overhead_total_s']:.4f} "
            f"total_s={st['total_s']:.4f} "
            f"plan_duration_s={st['plan_duration_s']:.2f} "
            f"D launches={replan_launches[label]} "
            f"steer calls kernel={st['tallies'].get('steer.kernel', 0)} "
            f"scan={st['tallies'].get('steer.scan', 0)}")
        check_plan(prob, p)
    if replan_launches["D"] < kern.stats["rounds"] or \
            replan_launches["plain"] or \
            kern.stats["tallies"].get("steer.scan", 0):
        raise AssertionError(f"steer route {name} replans: D launches "
                             f"{replan_launches}, fewer than the D "
                             f"planner's {kern.stats['rounds']} rounds, or "
                             "a steer call took the other route")


def full_width_planner(prob, constraints=None, **kw):
    import lqrrt_tpu_torch

    args = dict(horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=True, batch_size=8192,
                capacity=32768, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], device="cuda", seed=0)
    args.update(kw)
    return lqrrt_tpu_torch.Planner(prob["dynamics"], prob["lqr"],
                                   constraints or prob["constraints"], **args)


def planner_counters():
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const
    from lqrrt_tpu_torch.ops.kernels.write_kernel import block_write

    return {"nn_const": nn_const, "block_write": block_write,
            "steer_rollout": SteerLaunches()}


def phase_host_loop(prob, smi, bias):
    """The boat through the host loop (grow chunks on one tree) at full
    width: ``refine=False``, a 1.0 s replan, whose first chunk of 8 rounds
    fills the 32768 rows, so the loop stops at capacity; then
    ``max_nodes=16384`` with one round a chunk, so that the bound ``nodes
    <= max_nodes + batch * rounds_per_chunk`` (stats one chunk stale)
    bites.  Each: no restart, a grow chunk, a plan from x0, feasible and
    dynamically consistent (in the goal box if the goal was reached),
    kernels A and B launched.  Returns each replan's launches."""
    counters = planner_counters()
    out = {}
    for label, kw in (("refine=False", dict(refine=False)),
                      ("max_nodes=16384", dict(max_nodes=16384,
                                               rounds_per_chunk=1))):
        planner = full_width_planner(prob, **kw)
        planner.warmup(prob["x0"], prob["sample_space"], goal_bias=bias)
        name = f"boat host loop {label}"
        reached, launches = replan(name, prob, planner, bias, 1.0, smi,
                                   counters)
        st = planner.stats
        kinds = [k[3] for k in planner._chunk_cache]
        bound = planner.max_nodes + planner.batch_size * \
            planner.rounds_per_chunk
        if st["restarts"] or kinds != ["grow"]:
            raise AssertionError(f"{name}: not the host loop: {kinds}, "
                                 f"{st['restarts']} restarts")
        if "refine" in kw and st["tree_rows"] != planner.capacity:
            raise AssertionError(f"{name}: stopped at {st['tree_rows']} "
                                 f"rows, not at capacity {planner.capacity}")
        if "max_nodes" in kw and not st["nodes"] <= bound:
            raise AssertionError(f"{name}: {st['nodes']} nodes > {bound}")
        check_plan(prob, planner, goal_box=reached)
        if min(launches["nn_const"], launches["block_write"]) < 1:
            raise AssertionError(f"{name}: a kernel was not launched: "
                                 f"{launches}")
        log(f"{name} checks: host loop (grow chunk, no restart), "
            f"tree_rows={st['tree_rows']} nodes={st['nodes']} (bound "
            f"{bound}), plan from x0, feasible, dynamically consistent, "
            f"goal={reached}")
        out[label] = launches
    return out


def phase_dynamic_obstacles(smi):
    """The double integrator with a moving buoy at full width, the shapes of
    tests/test_planner_e2e.py:334-381: ``circles_free_data(margin=0.05)``
    over one circle, a 2.0 s replan, ``set_feasibility_data`` with the buoy
    moved, a second 2.0 s replan.  Each replan: the goal, a plan clear of
    the field then in force (feasible under it, clearance > 0), dynamically
    consistent, kernels A (no wrap dim: the erf is ``torch.subtract``) and
    B launched; between them the chunk cache gains no entry and the data
    tensors keep their addresses.  Returns both replans' launches."""
    from lqrrt_tpu_torch import Constraints
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.ops.collision import circles_free_data

    prob = di.default_problem(obstacles=False)
    fields = [{"centers": np.array([[1.5, 0.0]], np.float32),
               "radii": np.array([0.6], np.float32)},
              {"centers": np.array([[1.5, 0.35]], np.float32),
               "radii": np.array([0.7], np.float32)}]
    pred = circles_free_data(margin=0.05)
    cons = Constraints(nstates=4, ncontrols=2,
                       goal_buffer=prob["constraints"].goal_buffer,
                       is_feasible=pred, feasibility_data=fields[0])
    planner = full_width_planner(prob, cons)
    if planner.erf is not torch.subtract:
        raise AssertionError("the double integrator's erf is not subtract")
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=0.2)
    counters = planner_counters()
    out, keys, ptrs = [], None, None
    for i, data in enumerate(fields):
        cons.set_feasibility_data(data)
        name = f"double integrator moving buoy, field {i}"
        reached, launches = replan(name, prob, planner, 0.2, 2.0, smi,
                                   counters)
        bufs = planner._feas_bufs[planner._feas_sig]
        now = {k: v.data_ptr() for k, v in bufs.items()}
        if keys is not None and (list(planner._chunk_cache) != keys
                                 or now != ptrs):
            raise AssertionError(f"{name}: the data update built a chunk "
                                 f"or moved a tensor: "
                                 f"{list(planner._chunk_cache)}")
        keys, ptrs = list(planner._chunk_cache), now
        c, r = data["centers"][0], float(data["radii"][0])
        clearance = float((np.linalg.norm(planner.x_seq[:, :2] - c, axis=1)
                           - r).min())
        field = {k: torch.as_tensor(v) for k, v in data.items()}
        if not reached or clearance <= 0.0 or planner.nn_selected != \
                "nn_const" or min(launches["nn_const"],
                                  launches["block_write"]) < 1:
            raise AssertionError(f"{name}: goal={reached} clearance="
                                 f"{clearance} nn={planner.nn_selected} "
                                 f"launches={launches}")
        check_plan(prob, planner, lambda x, u: pred(x, u, field))
        log(f"{name} checks: goal, clearance={clearance:.4f} m, feasible "
            f"under the field, dynamically consistent, nn_const unwrapped, "
            f"chunks={len(keys)}, data tensors in place")
        out.append(launches)
    return out


def phase_kernel_a_unwrapped():
    """Kernel A at the double integrator's full-width shapes: n = 4 with no
    wrap dim, its constant S, N = 40960 rows uniform in its sample space,
    B = 8192 candidates from the same box, at sizes 1, 4097 and 32768,
    against its plain version with ``check_nn``'s gates (id match >= 0.999,
    fp64 excess, anchors); then at size 32768 the wrapper's time with its
    dispatch and alone, the launch alone and the plain version's time."""
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import (nn_const,
                                                       nn_const_plain)
    from lqrrt_tpu_torch.tools.exp_steer_kernel import device_ms
    from lqrrt_tpu_torch.tools.kernel_times import const_launcher

    prob = di.default_problem()
    ss = torch.as_tensor(prob["sample_space"], device="cuda")
    g = torch.Generator(device="cuda").manual_seed(41)

    def uniform(rows):
        return ss[:, 0] + torch.rand((rows, 4), generator=g,
                                     device="cuda") * (ss[:, 1] - ss[:, 0])

    states, xr = uniform(N_BENCH), uniform(B_BENCH)
    S = prob["lqr"](states[0], torch.zeros(2, device="cuda"))[0]
    S = S.contiguous()
    fns = ("kernel A nn_const", nn_const, nn_const_plain)
    out = {"id_match": {}}
    max_err = 0.0
    for size in (1, 4097, 32768):
        _, out["id_match"][size], err = check_nn(
            fns, "double integrator n=4 unwrapped", states, S, xr, size,
            None, gate_ids=True)
        max_err = max(max_err, err)
    sz = torch.tensor(32768, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: nn_const(states, S, sz, xr, wrap_dim=None))
    plain_ms = cuda_ms(lambda: nn_const_plain(states, S, sz, xr,
                                              wrap_dim=None), reps=5)
    alone = device_ms(lambda: nn_const(states, S, sz, xr, None), 20)
    launch, refill = const_launcher(states, S, xr, sz, None)
    launch_alone = device_ms(launch, 20, refill)
    log(f"kernel A nn_const double integrator n=4 unwrapped size=32768: "
        f"kernel_ms={ms:.4f} device_ms={alone:.4f} (alone, the prep "
        f"included) launch_device_ms={launch_alone:.4f} "
        f"plain_ms={plain_ms:.4f}")
    out.update(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               device_ms=alone, launch_device_ms=launch_alone)
    return out


def phase_untagged_erf(smi):
    """Fault 18 on the card: the double integrator with an erf that is
    neither ``torch.subtract`` nor tagged by ``make_erf`` under
    ``nn_impl="auto"`` takes the plain blocked scan, as the JAX planner
    does; a small replan (B = 512, capacity 4096, 1.0 s) reaches the goal
    with a checked plan and launches no kernel A."""
    from lqrrt_tpu_torch.models import double_integrator as di

    prob = di.default_problem()
    planner = full_width_planner(prob, erf=lambda a, b: a - b,
                                 batch_size=512, capacity=4096)
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=0.2)
    counters = planner_counters()
    reached, launches = replan("double integrator untagged erf", prob,
                               planner, 0.2, 1.0, smi, counters)
    if not reached or planner.nn_selected != "scan" or \
            launches["nn_const"] != 0:
        raise AssertionError(f"untagged erf: goal={reached} "
                             f"nn={planner.nn_selected} launches={launches}")
    check_plan(prob, planner)
    log("double integrator untagged erf checks: nn=scan, goal, plan from "
        "x0, feasible, in the goal box, dynamically consistent")


def phase_stacked(smi):
    """Fault 22 on the card: the double integrator stacked five times
    (``double_integrator.stacked_problem()``: n = 20, m = 10, one
    constant lqr) under ``nn_impl="auto"`` at full width (batch 8192,
    capacity 32768), goal bias 0.5, a 3.0 s replan.  n = 20 is past the
    16 states of the package's other models and at the JAX constant-metric
    kernel's own limit: the planner takes kernel A's n = 20 instance
    (``nn_selected == "nn_const"``) where it raised before; kernel B
    commits.  Gates: the replan does not raise, launches A and B and not
    C, reaches the goal, and its plan passes ``check_plan``."""
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_general

    prob = di.stacked_problem()
    planner = full_width_planner(prob)
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=0.5)
    counters = {**planner_counters(), "nn_general": nn_general}
    reached, launches = replan("double integrator x5 (n = 20)", prob,
                               planner, 0.5, 3.0, smi, counters)
    if (not reached or planner.nn_selected != "nn_const"
            or launches["nn_const"] < 1 or launches["nn_general"]
            or launches["block_write"] < 1):
        raise AssertionError(f"n = 20: goal={reached} "
                             f"nn={planner.nn_selected} launches={launches}")
    check_plan(prob, planner)
    log("double integrator x5 (n = 20) checks: nn=nn_const, A and B "
        "launched, no C launch, goal, plan from x0, feasible, in the goal "
        "box, dynamically consistent")
    return launches


def phase_exp_quality(smi):
    """``lqrrt_tpu_torch.tools.exp_quality`` in short form:
    ``boat.hard_problem`` at batch 2048, budgets 0.2 and 1.0 s, seeds 777,
    101 and 202.  Gates: every replan returns, every reached plan has a
    finite positive duration, and at 1.0 s at least one seed reaches the
    goal."""
    from lqrrt_tpu_torch.tools import exp_quality

    rec = exp_quality.main(["--instances", "hard", "--budgets", "0.2,1.0",
                            "--seeds", "777,101,202"])
    hard = rec["instances"]["hard"]
    curve = hard["curve"]
    log(f"exp_quality hard_problem, batch {hard['batch']} [{smi}]: "
        + " ".join(f"{b} s: mean {v['mean']} goal {v['goal']} seeds "
                   f"{v['seeds']};" for b, v in curve.items())
        + f" gain 0.2 -> 1.0 s {hard['gain_0p2_to_1p0_pct']} %")
    durs = [d for v in curve.values() for d in v["seeds"] if d is not None]
    if (not all(math.isfinite(d) and d > 0 for d in durs)
            or all(d is None for d in curve["1.0"]["seeds"])):
        raise AssertionError(f"exp_quality: {curve}")


TOL_TIME = 1e-4        # |node_time - the fp64 chain sum| (s)


def tree_audit(tree, dynamics, dt, wrap=()):
    """Host fp64 checks over every live row of a device tree: n_children
    equals the real child count (children with ``edge_len >= 1``), every
    real edge starts at its parent's state (``dynamics(state[parent],
    edge_u[0]) == edge_x[0]`` within 1e-4, angle dims ``wrap`` compared
    modulo 2 pi), ``node_time`` equals the chain's sum of ``edge_len * dt``
    within TOL_TIME, the parent pointers have no cycle, and every
    zero-length row holds its parent's state exactly.  Returns the counts
    of rows failing each."""
    t = {f: getattr(tree, f).cpu() for f in tree._fields}
    size = int(t["size"])
    parent = t["parent"][:size].long().numpy()
    edge_len = t["edge_len"][:size].long().numpy()
    real = (edge_len >= 1) & (parent >= 0) & (np.arange(size) >= 1)
    counts = np.bincount(parent[real], minlength=size)[:size]
    bad_count = int((t["n_children"][:size].numpy() != counts).sum())
    rows = torch.from_numpy(np.flatnonzero(real))
    x1 = dynamics(t["state"][parent[rows]].double(),
                  t["edge_u"][0][:, rows].T.double(), dt)
    dx = x1 - t["edge_x"][0][:, rows].T.double()
    for d in wrap:
        dx[:, d] = torch.remainder(dx[:, d] + math.pi, 2 * math.pi) - math.pi
    bad_edge = int((dx.abs().amax(1) > 1e-4).sum())
    # pointer doubling in fp64 on the host: the chain sums and, with the
    # same jumps, whether every row reaches the root
    d = np.where(parent >= 0, edge_len * dt, 0.0)
    p = parent.copy()
    for _ in range(int(math.ceil(math.log2(max(size, 2)))) + 1):
        up = p >= 0
        d = d + np.where(up, d[np.maximum(p, 0)], 0.0)
        p = np.where(up, p[np.maximum(p, 0)], -1)
    cycles = int((p >= 0).sum())
    bad_time = int((np.abs(t["node_time"][:size].double().numpy() - d)
                    > TOL_TIME).sum())
    dup = np.flatnonzero((edge_len == 0) & (parent >= 0)
                         & (np.arange(size) >= 1))
    state = t["state"][:size].numpy()
    stale = int((state[dup] != state[parent[dup]]).any(1).sum())
    return dict(n_children=bad_count, edge_start=bad_edge,
                node_time=bad_time, cycles=cycles, zero_length_state=stale,
                rows=size)


def phase_leaf_rewire(smi):
    """``refine_mode="leaf_rewire"`` at full width on the double
    integrator's ``default_problem()`` (five circles): batch 8192, capacity
    32768, goal bias 0.2, a 2.0 s replan.  The first chunk of 8 grow rounds
    fills the tree; the rest of the budget runs refine chunks on it (each
    round 4096 leaf-replacement candidates through kernel A, and 4096
    rewire targets).  Gates: the refine chunk is cached, no restart, the
    goal, the plan's checks, ``tree_audit`` clean, and ``get_tree``'s
    climb and trajectory of the best node equal to the plan before
    pruning; then one refine chunk under sync-debug mode 'error'.  Prints
    the rows replaced and re-parented against the tree saved before the
    refine chunks and kernel A's launches at B = 4096; then the same
    problem's replan under ``refine_mode="restart"`` beside it, for the
    plan duration (not a gate).  Returns (launches, planner)."""
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const

    prob = di.default_problem()
    planner = full_width_planner(prob, refine_mode="leaf_rewire")
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=0.2)
    saved = {}
    get_chunk = planner._get_chunk

    def spy(xrand_gen, n_fpr, commit="grow"):
        chunk = get_chunk(xrand_gen, n_fpr, commit)
        if commit != "refine":
            return chunk

        def first_refine(tree, *args, **kw):
            if not saved:          # the grown tree, before any refinement
                saved.update(parent=tree.parent.clone(),
                             state=tree.state.clone(),
                             a_launches=nn_const.launches)
            return chunk(tree, *args, **kw)
        return first_refine

    planner._get_chunk = spy
    counters = planner_counters()
    name = "double integrator leaf_rewire"
    try:
        reached, launches = replan(name, prob, planner, 0.2, 2.0, smi,
                                   counters)
    finally:
        del planner._get_chunk
    st = planner.stats
    kinds = [k[3] for k in planner._chunk_cache]
    if "refine" not in kinds or st["restarts"] != 0 or not saved:
        raise AssertionError(f"{name}: no refine chunk ran: {kinds}, "
                             f"restarts {st['restarts']}")
    if not reached:
        raise AssertionError(f"{name}: goal not reached: {st}")
    check_plan(prob, planner)
    a_refine = nn_const.launches - saved["a_launches"]
    if min(launches["nn_const"], launches["block_write"]) < 1 or \
            a_refine < 1:
        raise AssertionError(f"{name}: a kernel was not launched: "
                             f"{launches}, A in the refine chunks "
                             f"{a_refine}")
    tree = planner._device_tree
    audit = tree_audit(tree, prob["dynamics"], prob["dt"])
    if any(audit[k] for k in ("n_children", "edge_start", "node_time",
                              "cycles", "zero_length_state")):
        raise AssertionError(f"{name}: tree audit failed: {audit}")
    replaced = (tree.state != saved["state"]).any(1)
    moved = (tree.parent != saved["parent"]) & ~replaced
    # the best node's chain in the host snapshot against the plan before
    # pruning (a fresh extraction of the same node)
    best = planner._last_chain[-1]
    x_full, u_full = planner._extract(tree, best)
    size = int(tree.size)
    keep = (tree.edge_len[:size] > 0).cpu().numpy()
    keep[0] = True
    parent = tree.parent[:size].cpu().numpy()
    while not keep[best]:
        best = int(parent[best])
    host = planner.get_tree()
    xs, us = host.trajectory(host.climb(int(np.cumsum(keep)[best] - 1)))
    if not (np.array_equal(xs, x_full[1:]) and np.array_equal(us, u_full)):
        raise AssertionError(f"{name}: get_tree's best chain is not the "
                             "plan")
    log(f"{name} checks: refine chunk cached ({kinds}), restarts=0, goal, "
        f"plan from x0, feasible, in the goal box, dynamically consistent; "
        f"tree audit over {audit['rows']} rows in fp64: n_children = real "
        f"counts, real edges start at their parent's state, node_time = "
        f"chain sums within {TOL_TIME} s, no cycle, zero-length rows hold "
        f"their parent's state; get_tree's best chain "
        f"= the plan before pruning ({len(x_full)} states)")
    log(f"{name}: rounds={st['rounds']} "
        f"expansions_per_s={st['expansions_per_s']:.1f} "
        f"plan_duration_s={st['plan_duration_s']:.2f} "
        f"rows_replaced={int(replaced.sum())} "
        f"rows_reparented={int(moved.sum())} "
        f"kernel_A_launches_at_B4096={a_refine}")
    chunk = planner._get_chunk(None, 0, commit="refine")
    args = (planner.goal, planner._tensor(prob["sample_space"]),
            planner._tensor([0.2] * 4), planner.goal)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        chunk(tree, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    log(f"{name} sync-free refine chunk ({planner.rounds_per_chunk} rounds) "
        f"under sync_debug_mode='error': ok, enqueue_s={enqueue:.3f} "
        f"total_s={time.perf_counter() - t0:.3f}")

    restart = full_width_planner(prob)
    restart.warmup(prob["x0"], prob["sample_space"], goal_bias=0.2)
    replan("double integrator restart (beside leaf_rewire)", prob, restart,
           0.2, 2.0, smi, counters)
    return launches, planner


def refine_parts(planner, prob, nearest_fn, device, xr, start):
    """The planner's refine round for ``device`` (``make_refine_round``, as
    ``Planner._get_chunk`` builds it) with its half batch fixed to ``xr``
    and its rewire window to ``start``: (spec, expand, round) where
    round(tree, goal) runs it in place."""
    from lqrrt_tpu_torch.core.rounds import make_expand, make_refine_round

    spec = planner._spec()
    xr_d = torch.as_tensor(xr, device=device)
    common = (spec, prob["dynamics"], prob["lqr"], prob["erf"],
              prob["constraints"].is_feasible, planner.error_tol,
              prob["constraints"].goal_buffer)
    expand = make_expand(*common, saturate=prob["saturate"],
                         nearest_fn=nearest_fn)
    round_fn = make_refine_round(
        *common, saturate=prob["saturate"], nearest_fn=nearest_fn,
        xrand_gen=lambda gen, nb: xr_d[:nb])
    st = torch.tensor(start, device=device)
    return spec, expand, lambda tree, goal: round_fn(
        tree, None, goal, None, None, None, start=st)


def phase_refine_round_parity(planner, smi):
    """One refine round on the card against the same round on the CPU:
    the full tree of ``phase_leaf_rewire``'s replan, 4096 candidates from a
    seed, the same rewire window start.  Gates: kernel A's ids equal to its
    plain version's at B = 4096; after the round the integer fields
    (parent, edge_len, n_children, in_goal, size) equal, the float fields
    within TOL_STEER.  Then the card's round in its parts, synchronised,
    median of 5 on copies of the tree, and one round under
    ``torch.profiler`` for the device's busy share."""
    from lqrrt_tpu_torch.core.rounds import commit_candidates
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import make_nearest_const
    from lqrrt_tpu_torch.utils import timing

    prob = di.default_problem()
    half = planner.batch_size // 2
    rng = np.random.default_rng(23)
    lo, hi = prob["sample_space"][:, 0], prob["sample_space"][:, 1]
    xr = rng.uniform(lo, hi, (half, 4)).astype(np.float32)
    goal = prob["goal"]
    start = 12345
    base = type(planner._device_tree)(
        *[t.clone() for t in planner._device_tree])
    out = {}
    nearest_fn = make_nearest_const(None)
    for dev in ("cpu", "cuda"):
        _, _, round_fn = refine_parts(planner, prob, nearest_fn, dev, xr,
                                      start)
        tree = type(base)(*[t.to(dev, copy=True) for t in base])
        pids, _ = nearest_fn(tree.state, tree.S, tree.size,
                             torch.as_tensor(xr, device=dev))
        round_fn(tree, torch.as_tensor(goal, device=dev))
        out[dev] = (pids.cpu(), type(tree)(*[t.cpu() for t in tree]))
    (pid_cpu, t_cpu), (pid_gpu, t_gpu) = out["cpu"], out["cuda"]
    ids_equal = bool(torch.equal(pid_cpu, pid_gpu))
    ints = {f: int((getattr(t_cpu, f) != getattr(t_gpu, f)).sum())
            for f in ("parent", "edge_len", "n_children", "in_goal", "size")}
    floats = {f: float((getattr(t_cpu, f) - getattr(t_gpu, f)).abs()
                       .nan_to_num(0.0).max())
              for f in ("state", "edge_x", "edge_u", "node_time",
                        "goal_cost")}
    replaced = (t_gpu.state != base.state.cpu()).any(1)
    moved = int(((t_gpu.parent != base.parent.cpu()) & ~replaced).sum())
    log(f"refine round parity card vs cpu (B={planner.batch_size}: {half} "
        f"candidates, {half} rewire targets; capacity {planner.capacity}): "
        f"kernel_A_ids_equal={ids_equal} integer_mismatches={ints} "
        f"max_abs_float_err={floats} rows_replaced={int(replaced.sum())} "
        f"rows_reparented={moved}")
    if not ids_equal or any(ints.values()) or \
            max(floats.values()) > TOL_STEER:
        raise AssertionError("the card's refine round disagrees with the "
                             "CPU's")
    if not bool(replaced.any()) and moved == 0:
        raise AssertionError("the refine round changed no row: the parity "
                             "compared nothing")

    # the card's round in parts
    spec, expand, round_fn = refine_parts(planner, prob, nearest_fn, "cuda",
                                          xr, start)
    from lqrrt_tpu_torch.core.rewire import (make_nearest_pred,
                                             recompute_node_times)
    from lqrrt_tpu_torch.core.steer import make_steer
    nearest = make_nearest_pred(prob["erf"], block=spec.nn_block)
    steer = make_steer(prob["dynamics"], prob["erf"],
                       prob["constraints"].is_feasible, spec.horizon_steps,
                       spec.dt, planner.error_tol, saturate=prob["saturate"])
    xr_d = torch.as_tensor(xr, device="cuda")
    goal_d = torch.as_tensor(goal, device="cuda")
    ar = torch.arange(half, device="cuda")

    def parts(tree):
        times = {}

        def timed(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
            return r

        c = timed("expand", lambda: expand(tree, xr_d, goal_d))
        timed("refine_commit",
              lambda: commit_candidates(spec, tree, c, mode="refine"))
        live = torch.clamp(tree.size, max=spec.capacity)
        t_idx = 1 + (start + ar) % torch.clamp(live - 1, min=1)
        src, _ = timed("rewire_nn", lambda: nearest(
            tree.state, tree.S, tree.node_time, live, tree.state[t_idx],
            tree.node_time[t_idx], tree.parent[t_idx], spec.dt))
        timed("rewire_steer", lambda: steer(
            tree.state[src.long()], tree.K[src.long()], tree.state[t_idx]))
        timed("doubling", lambda: recompute_node_times(
            tree.parent, tree.edge_len, spec.dt))
        timed("whole_round", lambda: round_fn(tree, goal_d))
        return times

    runs = [parts(type(base)(*[t.clone() for t in base])) for _ in range(6)]
    med = {k: statistics.median(r[k] for r in runs[1:]) for k in runs[0]}
    tree = type(base)(*[t.clone() for t in base])
    busy_ms, kernels = timing.device_busy(lambda: round_fn(tree, goal_d))
    share = busy_ms / med["whole_round"]
    log(f"refine round parts on the card [{smi}] (ms, synchronised, median "
        f"of 5): " + " ".join(f"{k}={v:.3f}" for k, v in med.items())
        + f"; device kernel time in one round {busy_ms:.3f} ms in "
        f"{kernels} kernels (torch.profiler), busy share "
        f"{share:.3f} of the unprofiled round")
    return med


def phase_host_surface(planner, smi):
    """The host side on the card: a checkpoint of the leaf_rewire planner
    with its tree loaded into a fresh card planner (the same plan and
    get_state, equal tree arrays); a ReplanWatchdog armed at 1.0 s kills a
    60 s replan, whose salvaged plan is committed and checked; the
    TrajectoryServer, built from the repo's C source, answers get_state
    and get_effort as the planner does at 16 times."""
    import tempfile

    from lqrrt_tpu_torch.interop import tree_to_numpy
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.runtime import TrajectoryServer
    from lqrrt_tpu_torch.utils import ReplanWatchdog, checkpoint

    prob = di.default_problem()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ckpt.npz")
        checkpoint.save(planner, path, include_tree=True)
        fresh = full_width_planner(prob, seed=99,
                                   refine_mode="leaf_rewire")
        checkpoint.load(fresh, path)
    a, b = tree_to_numpy(planner._device_tree), tree_to_numpy(
        fresh._device_tree)
    same_tree = all(np.array_equal(a[f], b[f]) for f in a)
    times = np.linspace(-0.5, planner.T + 0.5, 16)
    same_plan = (np.array_equal(fresh.x_seq, planner.x_seq)
                 and np.array_equal(fresh.u_seq, planner.u_seq)
                 and all(np.array_equal(fresh.get_state(t),
                                        planner.get_state(t))
                         for t in times)
                 and fresh.plan_reached_goal == planner.plan_reached_goal)
    if not (same_tree and same_plan
            and fresh._device_tree.state.device.type == "cuda"):
        raise AssertionError(f"checkpoint: tree equal {same_tree}, plan "
                             f"equal {same_plan}")
    log(f"checkpoint on the card: tree of {int(a['size'])} rows and plan "
        f"of {len(planner.x_seq)} states carried into a fresh planner, "
        "equal; get_state equal at 16 times")

    wd_planner = full_width_planner(prob, min_time=60.0, max_time=60.0)
    wd_planner.warmup(prob["x0"], prob["sample_space"], goal_bias=0.2)
    wd = ReplanWatchdog(wd_planner, grace=0.0)
    t0 = time.perf_counter()
    with wd.guard(budget_s=1.0):
        reached = wd_planner.update_plan(prob["x0"], prob["sample_space"],
                                         goal_bias=0.2)
    took = time.perf_counter() - t0
    if not (wd.fired and wd.fire_count == 1 and took < 30.0):
        raise AssertionError(f"watchdog: fired {wd.fired}, {took:.1f} s")
    check_plan(prob, wd_planner, goal_box=reached)
    log(f"watchdog on the card: armed at 1.0 s under a 60 s budget, fired "
        f"once, replan ended after {took:.3f} s with "
        f"{wd_planner.stats['rounds']} rounds, salvaged plan committed "
        f"(goal={reached}, {len(wd_planner.x_seq)} states, checked)")

    ts = TrajectoryServer(4, 2).attach(planner)
    err = max(max(float(np.abs(ts.get_state(t) - planner.get_state(t))
                        .max()),
                  float(np.abs(ts.get_effort(t) - planner.get_effort(t))
                        .max())) for t in times)
    if err > 1e-5 or abs(ts.T - planner.T) > 1e-6:
        raise AssertionError(f"trajectory server: max err {err}")
    log(f"trajectory server (libtrajserver from runtime/native/"
        f"trajserver.c): get_state and get_effort at 16 times equal the "
        f"planner's within {err:.2e}")


FLEET_AUDIT = 16       # scenarios of the 1024-boat fleet audited in fp64
FLEET_ROUTE_ROUNDS = 8  # rounds of the fleet's D-against-plain tree gate


def fleet_steer_route(prob, make_fleet, fleet, x0s, goals, smi):
    """Kernel D under the fleet's steer at full width (phase 12 (a')):
    ``fleet``'s 1024 x 64 rows (the boat's circles, one goal a row)
    through D against a fleet built while D's factory refuses every
    problem, so that its router keeps the plain loop: every field of the
    trees after FLEET_ROUTE_ROUNDS rounds from one generator state, bit for
    bit, with one launch of D and one ``steer.kernel`` tally a round (none
    through the plain fleet); then one steer call on the grown trees' rows
    toward each row's goal, every field of its ``SteerResult`` bit for bit;
    then D alone at those 65,536 rows and with its dispatch, beside its
    bound (``kernel_times.steer_bound`` with the goals' rows added to its
    bytes)."""
    from lqrrt_tpu_torch.core.sampling import sample_batch
    from lqrrt_tpu_torch.core.steer import make_routed_steer, make_steer
    from lqrrt_tpu_torch.core.tree import TreeArrays
    from lqrrt_tpu_torch.ops.kernels import steer_kernel
    from lqrrt_tpu_torch.tools.exp_steer_kernel import device_ms
    from lqrrt_tpu_torch.tools.kernel_times import bound, steer_bound
    from lqrrt_tpu_torch.utils.timing import PhaseTimer

    real = steer_kernel.make_steer_kernel

    def refuse(*args, **kw):
        raise NotImplementedError("the plain steer, for the comparison")

    steer_kernel.make_steer_kernel = refuse
    try:
        plain = make_fleet()
        plain._build(*fleet.spec[:2])
    finally:
        steer_kernel.make_steer_kernel = real
    launches = SteerLaunches()
    S, n = x0s.shape
    batch, m = fleet.spec.batch, fleet.spec.ncontrols
    ss = fleet._tensor(prob["sample_space"]).expand(S, n, 2)
    gb = fleet._tensor(0.25).expand(n)
    g = fleet._tensor(goals)
    goal_rows = g[:, None, :].expand(S, batch, n).reshape(-1, n)
    grown, counts, secs = {}, {}, {}
    for label, f in (("D", fleet), ("plain", plain)):
        trees = f._seed(fleet._tensor(x0s), g)
        f._gen.manual_seed(5)
        f._spans.reset()
        launches.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f._run_rounds(trees, FLEET_ROUTE_ROUNDS, ss, gb, g, goal_rows)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
        counts[label] = (launches.launches, f._spans.tallies())
        grown[label] = trees
    differ = [name for name, a, b in zip(TreeArrays._fields, grown["D"],
                                         grown["plain"])
              if not same_bits(a, b)]
    want = {"D": (FLEET_ROUTE_ROUNDS, {"steer.kernel": FLEET_ROUTE_ROUNDS}),
            "plain": (0, {"steer.scan": FLEET_ROUTE_ROUNDS})}
    log(f"fleet steer route [{smi}]: {FLEET_ROUTE_ROUNDS} rounds of {S} x "
        f"{batch} rows from one generator state: D {secs['D']:.3f} s, "
        f"plain {secs['plain']:.3f} s; (D launches, tallies) {counts}; "
        f"mean nodes {float(grown['D'].size.float().mean()):.1f}, goals "
        f"found {int(grown['D'].goal_found.sum())}; "
        f"{len(TreeArrays._fields)} tree fields, differing: {differ}")
    if differ or counts != want:
        raise AssertionError(f"fleet steer route: tree fields {differ} "
                             f"differ, or (D launches, tallies) {counts} "
                             f"are not {want}")
    del plain, grown["plain"]

    # one steer call on the grown trees' rows, each toward its goal
    trees, dev = grown.pop("D"), fleet.device
    gen = torch.Generator(device=dev).manual_seed(7)
    pl = (torch.rand((S, batch), generator=gen, device=dev)
          * trees.size[:, None]).long()
    sc = torch.arange(S, device=dev)[:, None]
    x0 = trees.state[sc, pl].reshape(-1, n)
    K0 = trees.K[sc, pl].reshape(-1, m, n)
    xtar = sample_batch(fleet._gen, batch, ss, gb, g).reshape(-1, n)
    args = (prob["dynamics"], prob["erf"], prob["constraints"].is_feasible,
            fleet.horizon_steps, fleet.dt, 0.05)
    kw = dict(saturate=prob["saturate"],
              goal_buffer=prob["constraints"].goal_buffer)
    timer = PhaseTimer()
    routed = make_routed_steer(*args, spans=timer, **kw)
    launches.launches = 0
    rk = routed(x0, K0, xtar, goal_rows)
    torch.cuda.synchronize()
    k_launch = launches.launches
    rp = make_steer(*args, **kw)(x0, K0, xtar, goal_rows)
    differ = [name for name, a, b in zip(rk._fields, rk, rp)
              if not same_bits(a, b)]
    log(f"fleet steer call, {len(xtar)} rows: D launches {k_launch}, "
        f"tallies {timer.tallies()}, mean length "
        f"{float(rk.length.float().mean()):.2f}, in goal "
        f"{int(rk.in_goal.sum())}, differing: {differ}")
    if differ or k_launch != 1 or timer.tallies() != {"steer.kernel": 1}:
        raise AssertionError(f"fleet steer call: {differ} differ, or D "
                             f"launched {k_launch} times")

    # D alone on those rows and with its dispatch, beside its bound
    kern = real(*args, **kw)

    def call():
        return kern(x0, K0, xtar, goal_rows)

    res = call()
    ms = cuda_ms(call)
    alone_ms = device_ms(call, 20)
    _, _, flops, nbytes = steer_bound(res, len(xtar), 7, False)
    nbytes += 4 * len(xtar) * n          # the goals' rows, one a candidate
    bound_ms, bound_by = bound({"fp32": flops}, nbytes)
    log(f"kernel D steer_rollout[fleet] B={len(xtar)} H={fleet.horizon_steps}"
        f" [{smi}]: device_ms={alone_ms:.4f} (alone) kernel_ms={ms:.4f} "
        f"(with dispatch) bound_ms={bound_ms:.4f} ({bound_by}; {flops:.4g} "
        f"fp32 flops, {nbytes:.4g} bytes), {100 * bound_ms / alone_ms:.1f}%"
        " of the bound reached alone")
    return dict(device_ms=alone_ms, ms=ms, bound_ms=bound_ms)


def phase_fleet(smi):
    """The scenario-parallel fleet (``lqrrt_tpu_torch/parallel/fleet.py``;
    its steer kernel D, its NN scan and commit plain PyTorch) at full
    width.

    (a) The configuration of ``portbench``'s cell ``fleet.plan``: 1024
    boat scenarios (goals from ``fleet_demo.perturbed_goals``), batch 64,
    capacity 1024, ``nn_block=256``, H = 100, goal bias 0.25, a 2.0 s
    budget in chunks of 8 rounds after a 1-round warm-up, then every
    scenario's plan extracted; the stats, the peak memory; gates:
    ``elapsed_s`` within the budget plus one measured round, every size
    <= capacity, every plan from its x0 and feasible under the boat's
    circles, one launch of D and one ``steer.kernel`` tally a round.
    (a') ``fleet_steer_route``: D against the plain loop, bit for bit.
    Then 64 rounds at ``max_time=None`` (the budgeted run's round cap):
    goal rate > 0.5, every steer call on D's route, and the fp64
    ``tree_audit`` of 16 scenarios; one round in its parts (NN scan,
    steer through D, the rest of the expand, commit), synchronised,
    median of 3, its busy share (``torch.profiler``), and one round under
    ``torch.cuda.set_sync_debug_mode("error")``.
    (b) Per-scenario worlds: a circle of its own for each of the 1024
    scenarios (``circles_free_data``, ``per_scenario_data=True``), 16
    rounds; no scenario's node inside its own circle plus margin, and
    some inside another scenario's.  Then a grid of its own for each
    (``grid_free_data`` over (1024, 96, 200) grids: the boat's buoy field
    at 0.25 m, moved by U(-3, 3) m a scenario), 16 rounds: no node in its
    own scenario's occupied cells, some in the next scenario's, and the
    peak memory less the circles run's below twice the grids' bytes (a
    grid copied to each steered row would be 1.26 GB).  Both keep the
    plain loop (their predicate is the fleet's 3-arg closure, which D's
    factory refuses): every steer call tallied ``steer.scan``.
    (c) One round at S = 8, batch 64, capacity 1024 on the card and on the
    CPU from the same trees and (S, B, n) candidates: the trees equal
    within the round-parity phase's tolerances.
    (d) ``lqrrt_tpu_torch.demos.fleet_demo`` with its defaults exits 0.
    Returns D's launches in the 2.0 s plan and ``fleet_steer_route``'s
    times."""
    from lqrrt_tpu_torch.core.commit import commit_batch_dense
    from lqrrt_tpu_torch.core.nearest import make_nearest
    from lqrrt_tpu_torch.core.rounds import make_extend, scenario_leading
    from lqrrt_tpu_torch.core.sampling import sample_batch
    from lqrrt_tpu_torch.core.steer import make_routed_steer
    from lqrrt_tpu_torch.core.tree import TreeArrays
    from lqrrt_tpu_torch.demos import fleet_demo
    from lqrrt_tpu_torch.models import boat
    from lqrrt_tpu_torch.ops.collision import (circles_free_data,
                                               grid_free_data)
    from lqrrt_tpu_torch.parallel import FleetPlanner
    from lqrrt_tpu_torch.utils import timing

    # (a) the 1024-boat fleet
    dev = "cuda"
    S, batch, cap, rounds, budget = 1024, 64, 1024, 64, 2.0
    prob = boat.default_problem()
    torch.cuda.reset_peak_memory_stats()

    def make_fleet():
        return FleetPlanner(
            prob["dynamics"], prob["lqr"], prob["erf"],
            prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
            horizon=prob["horizon"], dt=prob["dt"], n_scenarios=S,
            batch_size=batch, capacity=cap, nn_block=256,
            saturate=prob["saturate"], wrap_dims=prob["wrap_dims"],
            device=dev)

    fleet = make_fleet()
    launches = SteerLaunches()
    x0s = np.tile(np.asarray(prob["x0"]), (S, 1))
    goals = fleet_demo.perturbed_goals(prob, S)
    # warm-up: one 1-round chunk (the callbacks' constants reach the
    # device, and the per-round time seeds the budgeted run's first clamp)
    fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25, rounds=1,
               max_time=1e9, rounds_per_chunk=1)
    launches.launches = 0
    st = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                    rounds=rounds, max_time=budget, rounds_per_chunk=8)
    d_launches = launches.launches
    plans = fleet.extract_plans()
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_round = fleet._per_round_s
    log(f"fleet {S} boats, {budget} s budget [{smi}]: rounds={st['rounds']} "
        f"elapsed_s={st['elapsed_s']:.4f} per_round_s={per_round:.4f} "
        f"expansions_per_s={st['expansions_per_s']:.1f} goal_rate="
        f"{float(st['goal_found'].mean()):.4f} mean_nodes="
        f"{st['sizes'].mean():.1f} D launches={d_launches} "
        f"tallies={st['tallies']} extract={fleet.last_extract_timings}")
    log(f"fleet peak_mem_GiB={peak:.3f} (max_memory_allocated)")
    if st["elapsed_s"] > budget + per_round:
        raise AssertionError(f"fleet: elapsed {st['elapsed_s']} s past the "
                             f"{budget} s budget plus one round "
                             f"({per_round:.4f} s)")
    if d_launches != st["rounds"] or \
            st["tallies"] != {"steer.kernel": st["rounds"]}:
        raise AssertionError(f"fleet: D launched {d_launches} times and "
                             f"the tallies read {st['tallies']} in "
                             f"{st['rounds']} rounds: a steer call off D")
    sizes = fleet.trees.size.cpu().numpy()
    starts = np.stack([plans[s][0] for s in range(S)])
    states = torch.as_tensor(np.concatenate([plans[s] for s in range(S)]))
    feas = prob["constraints"].is_feasible(
        states, torch.zeros(len(states), 3))
    if (sizes > cap).any() or not np.allclose(starts, x0s, atol=1e-5):
        raise AssertionError("fleet: a tree past capacity or a plan not "
                             "from its x0")
    if not bool(feas.all()):
        raise AssertionError(f"fleet: {int((~feas).sum())} plan states "
                             "inside the buoys")
    log(f"fleet plan checks: {S} plans ({len(states)} states) from their "
        f"x0, feasible; sizes <= {cap}; elapsed_s {st['elapsed_s']:.4f} "
        f"<= {budget} + one round ({per_round:.4f} s)")

    d_fleet = fleet_steer_route(prob, make_fleet, fleet, x0s, goals, smi)

    t0 = time.perf_counter()
    st = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                    rounds=rounds)
    rate = float(st["goal_found"].mean())
    log(f"fleet {rounds} rounds (max_time=None) [{smi}]: goal_rate="
        f"{rate:.4f} elapsed_s={st['elapsed_s']:.4f} expansions_per_s="
        f"{st['expansions_per_s']:.1f} mean_nodes={st['sizes'].mean():.1f} "
        f"tallies={st['tallies']} wall_s={time.perf_counter() - t0:.3f}")
    if not rate > 0.5 or st["tallies"] != {"steer.kernel": rounds}:
        raise AssertionError(f"fleet: goal rate {rate} at {rounds} "
                             f"rounds, or a steer call off D: "
                             f"{st['tallies']}")
    bad = {}
    for s in range(0, S, S // FLEET_AUDIT):
        t = TreeArrays(*[f[s] for f in fleet.trees])
        res = tree_audit(t, prob["dynamics"], prob["dt"],
                         wrap=prob["wrap_dims"])
        for k, v in res.items():
            bad[k] = bad.get(k, 0) + v
    rows = bad.pop("rows")
    log(f"fleet fp64 audit of {FLEET_AUDIT} scenarios ({rows} rows): "
        f"failing rows {bad}")
    if any(bad.values()):
        raise AssertionError(f"fleet: audit failed: {bad}")

    # one round in its parts, its busy share, and sync-free
    n, m = 6, 3
    spec = fleet.spec
    sc = torch.arange(S, device=dev)[:, None]
    ss = fleet._tensor(prob["sample_space"]).expand(S, n, 2)
    gb = fleet._tensor(0.25).expand(n)
    g = fleet._tensor(goals)
    goal_rows = g[:, None, :].expand(S, spec.batch, n).reshape(-1, n)
    common = (prob["dynamics"], prob["erf"],
              prob["constraints"].is_feasible)
    nearest = make_nearest(prob["erf"], min(spec.nn_block, cap))
    steer = make_routed_steer(*common, spec.horizon_steps, spec.dt, 0.05,
                              saturate=prob["saturate"],
                              goal_buffer=prob["constraints"].goal_buffer)
    wrap_mask = np.zeros(n, bool)
    wrap_mask[list(prob["wrap_dims"])] = True
    extend = make_extend(spec, prob["dynamics"], prob["lqr"], prob["erf"],
                         prob["constraints"].is_feasible, 0.05,
                         prob["constraints"].goal_buffer,
                         wrap_mask=wrap_mask, saturate=prob["saturate"])
    trees = fleet.trees

    def parts():
        times = {}

        def part(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
            return r

        xr = part("sample", lambda: sample_batch(fleet._gen, spec.batch, ss,
                                                 gb, g))
        pids, _ = part("nn_scan", lambda: nearest(trees.state, trees.S,
                                                  trees.size, xr))
        x0, K0 = part("gather", lambda: (
            trees.state[sc, pids.long()].reshape(-1, n),
            trees.K[sc, pids.long()].reshape(-1, m, n)))
        part("steer", lambda: steer(x0, K0, xr.reshape(-1, n), goal_rows))
        c = part("expand_after_nn", lambda: extend(
            pids.reshape(-1), x0, K0, xr.reshape(-1, n), goal_rows))
        part("commit", lambda: commit_batch_dense(
            trees, spec.dt, cap, *scenario_leading(c, S, spec.batch)))
        part("whole_round", lambda: fleet._run_rounds(
            trees, 1, ss, gb, g, goal_rows))
        return times

    runs = [parts() for _ in range(4)]
    med = {k: statistics.median(r[k] for r in runs[1:]) for k in runs[0]}
    busy_ms, kernels = timing.device_busy(
        lambda: fleet._run_rounds(trees, 1, ss, gb, g, goal_rows))
    log(f"fleet round parts on the card [{smi}] (ms, synchronised, median "
        f"of 3; 'steer' alone through D, 'expand_after_nn' is steer + lqr "
        f"+ wrap + goal cost): "
        + " ".join(f"{k}={v:.3f}" for k, v in med.items())
        + f"; device kernel time in one round {busy_ms:.3f} ms in {kernels} "
        f"kernels (torch.profiler), busy share "
        f"{busy_ms / med['whole_round']:.3f} of the unprofiled round")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fleet._run_rounds(trees, 1, ss, gb, g, goal_rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    enqueue = time.perf_counter() - t0
    torch.cuda.synchronize()
    log(f"fleet sync-free round under sync_debug_mode='error': ok, "
        f"enqueue_s={enqueue:.3f} total_s={time.perf_counter() - t0:.3f}")
    del fleet, trees, plans

    # (b) a world of its own for each scenario
    rng = np.random.default_rng(29)
    centers = np.stack([rng.uniform(8.0, 32.0, S), rng.uniform(-6.0, 6.0, S)],
                       1).astype(np.float32)[:, None, :]
    radii = rng.uniform(1.5, 3.0, (S, 1)).astype(np.float32)
    margin = 1.0
    pred = circles_free_data(margin=margin)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wf = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"], pred,
        prob["constraints"].goal_buffer, horizon=prob["horizon"],
        dt=prob["dt"], n_scenarios=S, batch_size=batch, capacity=cap,
        nn_block=256, saturate=prob["saturate"], wrap_dims=prob["wrap_dims"],
        per_scenario_data=True, device=dev)
    st = wf.plan(x0s, goals, prob["sample_space"], goal_bias=0.25, rounds=16,
                 feasibility_data={"centers": centers, "radii": radii})
    live = (torch.arange(wf.trees.state.shape[1], device=dev)
            < wf.trees.size[:, None])

    def inside(c, r):
        data = {"centers": torch.as_tensor(c[:, None], device=dev),
                "radii": torch.as_tensor(r[:, None], device=dev)}
        return int((~pred(wf.trees.state, None, data) & live).sum())

    own = inside(centers, radii)
    other = inside(np.roll(centers, 1, 0), np.roll(radii, 1, 0))
    log(f"fleet per-scenario worlds [{smi}]: {S} scenarios, 16 rounds, "
        f"elapsed_s={st['elapsed_s']:.4f} goal_rate="
        f"{st['goal_found'].mean():.4f} mean_nodes={st['sizes'].mean():.1f};"
        f" nodes inside their own circle + {margin} m: {own}, inside the "
        f"next scenario's: {other}; tallies {st['tallies']}")
    if own or not other:
        raise AssertionError("fleet: per-scenario worlds not kept apart")
    if st["tallies"] != {"steer.scan": 16}:
        raise AssertionError(f"fleet: per-scenario worlds' steer calls "
                             f"{st['tallies']}, not the plain loop's")
    torch.cuda.synchronize()
    peak_circles = torch.cuda.max_memory_allocated()
    del wf

    # (b2) a grid of its own for each scenario: the buoy field moved
    centers0, radii0 = prob["obstacles"]
    shift = rng.uniform(-3.0, 3.0, (S, 1, 2)).astype(np.float32)
    g0 = boat.buoy_grid(centers0, radii0)
    Hg, Wg = g0.occ.shape
    gx = g0.origin[0] + (np.arange(Wg) + 0.5) * g0.resolution
    gy = g0.origin[1] + (np.arange(Hg) + 0.5) * g0.resolution
    occ = np.zeros((S, Hg, Wg), bool)
    for k in range(len(radii0)):
        cx = centers0[k, 0] + shift[:, 0, 0]
        cy = centers0[k, 1] + shift[:, 0, 1]
        occ |= ((gx[None, None, :] - cx[:, None, None]) ** 2
                + (gy[None, :, None] - cy[:, None, None]) ** 2
                <= (radii0[k] + 1.0) ** 2)
    gpred = grid_free_data(g0.origin, g0.resolution)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gf = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"], gpred,
        prob["constraints"].goal_buffer, horizon=prob["horizon"],
        dt=prob["dt"], n_scenarios=S, batch_size=batch, capacity=cap,
        nn_block=256, saturate=prob["saturate"], wrap_dims=prob["wrap_dims"],
        per_scenario_data=True, device=dev)
    st = gf.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                 rounds=16, feasibility_data=occ)
    torch.cuda.synchronize()
    peak_grids = torch.cuda.max_memory_allocated()
    live = (torch.arange(gf.trees.state.shape[1], device=dev)
            < gf.trees.size[:, None])
    occ_d = torch.as_tensor(occ, device=dev)
    own = int((~gpred(gf.trees.state, None, occ_d) & live).sum())
    other = int((~gpred(gf.trees.state, None, occ_d.roll(1, 0))
                 & live).sum())
    grid_bytes = occ.nbytes
    log(f"fleet per-scenario grids [{smi}]: {S} scenarios, ({S}, {Hg}, "
        f"{Wg}) grids ({grid_bytes / 2**20:.1f} MiB on the device), 16 "
        f"rounds, elapsed_s={st['elapsed_s']:.4f} goal_rate="
        f"{st['goal_found'].mean():.4f} mean_nodes={st['sizes'].mean():.1f};"
        f" nodes in their own occupied cells: {own}, in the next "
        f"scenario's: {other}; peak memory {peak_grids / 2**30:.3f} GiB "
        f"against {peak_circles / 2**30:.3f} GiB with circles (difference "
        f"{(peak_grids - peak_circles) / 2**20:.1f} MiB, gate < 2 x the "
        f"grids' {grid_bytes / 2**20:.1f} MiB; one grid a steered row "
        f"would be {S * batch * Hg * Wg / 2**30:.2f} GiB); tallies "
        f"{st['tallies']}")
    if own or not other:
        raise AssertionError("fleet: per-scenario grids not kept apart")
    if st["tallies"] != {"steer.scan": 16}:
        raise AssertionError(f"fleet: per-scenario grids' steer calls "
                             f"{st['tallies']}, not the plain loop's")
    if peak_grids - peak_circles >= 2 * grid_bytes:
        raise AssertionError("fleet: per-scenario grids took "
                             f"{peak_grids - peak_circles} B past the "
                             "circles run: a copy of the grids")
    del gf

    # (c) one round on the card against the CPU
    Sc = 8
    sub = np.arange(Sc) * (S // Sc)
    small = {}
    for d in ("cpu", dev):
        f = FleetPlanner(
            prob["dynamics"], prob["lqr"], prob["erf"],
            prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
            horizon=prob["horizon"], dt=prob["dt"], n_scenarios=Sc,
            batch_size=batch, capacity=cap, nn_block=256,
            saturate=prob["saturate"], wrap_dims=prob["wrap_dims"],
            device=d)
        f._build(n, m)
        small[d] = f
    rng = np.random.default_rng(31)
    lo, hi = prob["sample_space"][:, 0], prob["sample_space"][:, 1]
    xrs = [rng.uniform(lo, hi, (Sc, batch, n)).astype(np.float32)
           for _ in range(4)]
    g8 = torch.as_tensor(goals[sub])
    rows8 = g8.repeat_interleave(batch, 0)
    cpu = small["cpu"]
    t_cpu = cpu._seed(torch.as_tensor(x0s[sub]), g8)
    for xr in xrs[:3]:
        cpu._round(t_cpu, torch.as_tensor(xr), rows8)
    t_gpu = TreeArrays(*[t.to(dev) for t in t_cpu])
    cpu._round(t_cpu, torch.as_tensor(xrs[3]), rows8)
    small[dev]._round(t_gpu, torch.as_tensor(xrs[3], device=dev),
                      rows8.to(dev))
    a = {k: v.cpu() for k, v in t_cpu._asdict().items()}
    b = {k: v.cpu() for k, v in t_gpu._asdict().items()}
    live = torch.arange(a["state"].shape[1]) < a["size"][:, None]
    match = ((a["parent"] == b["parent"]) & (a["edge_len"] == b["edge_len"])
             & live)
    row_match = float(match.sum() / live.sum())
    dx = (a["state"] - b["state"]).abs().amax(-1)[match]
    de = (a["edge_x"] - b["edge_x"]).abs().amax((1, 2))[match]
    same = {k: bool(torch.equal(a[k], b[k]))
            for k in ("size", "goal_found", "in_goal", "n_children")}
    log(f"fleet round card vs cpu (S={Sc}, B={batch}, capacity={cap}):"
        f" equal {same}, row_match={row_match:.4f} max_abs_state_err="
        f"{float(dx.max()):.3e} max_abs_edge_x_err={float(de.max()):.3e}")
    if not (same["size"] and same["goal_found"] and row_match >= 0.99
            and float(dx.max()) <= TOL_STEER
            and float(de.max()) <= TOL_STEER):
        raise AssertionError("fleet: the card's round disagrees with the "
                             "CPU's")

    # (d) the fleet demo
    t0 = time.perf_counter()
    rc = fleet_demo.main([])
    log(f"fleet demo: exit {rc} in {time.perf_counter() - t0:.2f} s")
    if rc != 0:
        raise AssertionError(f"fleet demo exited {rc}")
    return dict(launches=d_launches, **d_fleet)


MESH_B, MESH_CAP, MESH_TOPK = 8192, 32768, 1024
MESH_SPLIT_REPS = 5


def tree_clone(tree):
    return type(tree)(*[t.clone() for t in tree])


def trees_agree(a, b, label):
    """The round-parity tolerances on two trees (any devices): size and
    goal_found equal, >= 99% of the live rows with the same parent and
    edge length, states and the edges' committed steps within TOL_STEER
    there (the steps past an edge's length are padding)."""
    a = {k: v.cpu() for k, v in a._asdict().items()}
    b = {k: v.cpu() for k, v in b._asdict().items()}
    live = torch.arange(a["state"].shape[0]) < a["size"]
    rows = (a["parent"] == b["parent"]) & (a["edge_len"] == b["edge_len"])
    match = float((rows & live).sum() / live.sum())
    dx = float((a["state"] - b["state"]).abs()[rows & live].max())
    steps = (torch.arange(a["edge_x"].shape[0])[:, None, None]
             < a["edge_len"][None, None, :])
    de = float(torch.where(steps, (a["edge_x"] - b["edge_x"]).abs(),
                           0.0).amax((0, 1))[rows & live].max())
    ok = (bool(torch.equal(a["size"], b["size"]))
          and bool(torch.equal(a["goal_found"], b["goal_found"]))
          and match >= 0.99 and dx <= TOL_STEER and de <= TOL_STEER)
    log(f"{label}: size {int(a['size'])} / {int(b['size'])}, "
        f"row_match={match:.4f} max_abs_state_err={dx:.3e} "
        f"max_abs_edge_x_err={de:.3e}")
    if not ok:
        raise AssertionError(f"{label}: the trees disagree")


def phase_mesh(smi):
    """Multi-device planning (``lqrrt_tpu_torch/parallel``) on this one
    card: an NCCL process group of world size 1 (a ``FileStore`` in a
    temporary directory), meshes from ``init_device_mesh``, the group
    destroyed at the end.  At world size 1 every collective is a copy on
    the device; the multi-rank behaviour is held against JAX on the CPU.

    (1) gather parity: one mesh round (gather) and one plain round from
    the same grown tree and the same (B, n) candidates, the boat at batch
    8192, capacity 32768, kernels A and B on both: the trees equal bit for
    bit; then each round timed from clones of that tree, and the gather
    alone.  (2) topk parity: a topk round (k = 1024) on the card against the
    same round on the CPU (plain versions; the k best by a stable sort of
    the scores), batch 8192, capacity 16384: the round-parity tolerances.
    (3) exact truncation: ``make_map_sharded_round`` with one shard (no
    predicate while steering, the boat's buoy raster at 0.25 m after)
    against the plain round steering under ``grid_free_data`` on the whole
    grid, the same candidates, batch 8192, capacity 32768: the same
    tolerances.  (4) full-width replans (batch 8192, capacity 32768, 2.0
    s) of the boat's ``default_problem()``: without a mesh (seeds 0 and
    1: the spread another random stream gives), then
    ``Planner(mesh=...)`` with ``collective="gather"`` (the fused restart
    path), ``collective="topk"`` with k = 1024 and ``refine=False`` (the
    host loop, where topk takes effect), and a one-shard
    ``feasibility_grid`` (the buoy field rasterised at 0.05 m, no other
    predicate; the host loop with the restart stash): the goal, the plan's
    checks (off every occupied cell of the full grid), kernel A launched in
    each, kernel B in the first two (the grid round takes the sorted
    commit).  (5) one mesh restart chunk under sync-debug mode 'error'.
    (6) ``tools/bench_collectives.py``'s port at world size 1.  Returns
    each mesh replan's launches."""
    import tempfile

    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group("nccl", store=store, world_size=1, rank=0)
    try:
        return mesh_steps(smi, "cuda")
    finally:
        dist.destroy_process_group()


def mesh_steps(smi, dev):
    from lqrrt_tpu_torch.core.rounds import (Candidates, RoundSpec,
                                             commit_candidates, make_expand,
                                             make_round)
    from lqrrt_tpu_torch.core.sampling import sample_batch
    from lqrrt_tpu_torch.core.tree import init_tree
    from lqrrt_tpu_torch.models import boat
    from lqrrt_tpu_torch.ops.collision import grid_free_data
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import make_nearest_const
    from lqrrt_tpu_torch.parallel import mesh as meshlib
    from lqrrt_tpu_torch.parallel.map_sharded import (ShardedGrid,
                                                      make_map_sharded_round)
    from lqrrt_tpu_torch.parallel.sharded import (candidate_scores,
                                                  gather_candidates,
                                                  make_sharded_round)
    from lqrrt_tpu_torch.tools import bench_collectives

    mesh = meshlib.make_mesh(1, device_type=dev)
    prob = boat.default_problem()
    n, m, B = 6, 3, MESH_B
    H = int(round(prob["horizon"] / prob["dt"]))
    wrap_mask = np.zeros(n, bool)
    wrap_mask[list(prob["wrap_dims"])] = True
    gbuf = prob["constraints"].goal_buffer
    args = (prob["dynamics"], prob["lqr"], prob["erf"])
    common = dict(wrap_mask=wrap_mask, saturate=prob["saturate"])
    nn_a = make_nearest_const(WRAP)
    rng = np.random.default_rng(41)
    lo, hi = prob["sample_space"][:, 0], prob["sample_space"][:, 1]

    def candidates(device=dev):
        x = rng.uniform(lo, hi, (B, n)).astype(np.float32)
        x[:, 0] *= 0.4                 # near the young tree
        return torch.as_tensor(x, device=device)

    def seed_tree(cap, device=dev):
        spec = RoundSpec(n, m, B, H, cap, prob["dt"], nn_block=1024,
                         slack=B)
        x0 = torch.as_tensor(prob["x0"], device=device)
        S0, K0 = prob["lqr"](x0, torch.zeros(m, device=device))
        tree = init_tree(cap, H, n, m, x0, S0, K0,
                         torch.tensor(1e9, device=device),
                         torch.tensor(False, device=device), slack=B,
                         root_pad=512)
        return spec, tree

    goal = torch.as_tensor(prob["goal"], device=dev)
    feas = prob["constraints"].is_feasible

    # (1) gather parity, bit for bit
    spec, tree = seed_tree(MESH_CAP)
    xr = candidates()
    make_round(spec, *args, feas, 0.05, gbuf, xrand_gen=lambda g, b: xr,
               nearest_fn=nn_a, **common)(tree, None, goal, None, None, None)
    xr = candidates()
    rounds = {
        "plain": make_round(spec, *args, feas, 0.05, gbuf,
                            xrand_gen=lambda g, b: xr, nearest_fn=nn_a,
                            **common),
        "mesh": make_sharded_round(spec, mesh, *args, feas, 0.05, gbuf,
                                   xrand_gen=lambda g, b: xr,
                                   nearest_fn=nn_a, **common)}
    plain, meshed = tree_clone(tree), tree_clone(tree)
    rounds["plain"](plain, None, goal, None, None, None)
    rounds["mesh"](meshed, None, goal, None, None, None)
    torch.cuda.synchronize()
    same = {f: bool(torch.equal(a, b))
            for f, a, b in zip(plain._fields, plain, meshed)}
    log(f"mesh gather parity (B={B}, capacity={MESH_CAP}, world size 1): "
        f"size {int(meshed.size)}, bit for bit {all(same.values())}")
    if not all(same.values()):
        raise AssertionError(f"mesh gather round differs: {same}")
    # the round's split: each round from a clone of the same tree with the
    # same candidates, alternated, CUDA events; the gather alone
    cand = make_expand(spec, *args, feas, 0.05, gbuf, nearest_fn=nn_a,
                       **common)(tree, xr, goal)
    gather_ms = cuda_ms(lambda: gather_candidates(cand, mesh, "dp"))
    del cand
    round_ms = {k: [] for k in rounds}
    for _ in range(MESH_SPLIT_REPS):
        for k, rf in rounds.items():
            t = tree_clone(tree)
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            rf(t, None, goal, None, None, None)
            e.record()
            e.synchronize()
            round_ms[k].append(s.elapsed_time(e))
            del t
    med = {k: statistics.median(v) for k, v in round_ms.items()}
    log(f"mesh round split [{smi}] (B={B}, capacity {MESH_CAP}, world size "
        f"1, median of {MESH_SPLIT_REPS}): plain round {med['plain']:.3f} "
        f"ms, mesh gather round {med['mesh']:.3f} ms (difference "
        f"{med['mesh'] - med['plain']:+.3f} ms), the gather alone "
        f"{gather_ms:.3f} ms; plain {[round(v, 3) for v in round_ms['plain']]}"
        f", mesh {[round(v, 3) for v in round_ms['mesh']]}")

    # (2) topk parity: the card's mesh round against the CPU's plain one
    spec2, t2 = seed_tree(MESH_CAP // 2)
    make_round(spec2, *args, feas, 0.05, gbuf,
               xrand_gen=lambda g, b: candidates(), nearest_fn=nn_a,
               **common)(t2, None, goal, None, None, None)
    xr = candidates()
    t_cpu = type(t2)(*[t.cpu() for t in t2])
    make_sharded_round(spec2, mesh, *args, feas, 0.05, gbuf,
                       xrand_gen=lambda g, b: xr, nearest_fn=nn_a,
                       collective="topk", topk=MESH_TOPK, **common)(
        t2, None, goal, None, None, None)
    c = make_expand(spec2, *args, feas, 0.05, gbuf, **common)(
        t_cpu, xr.cpu(), goal.cpu())
    score = candidate_scores(t_cpu, c, spec2.dt)
    order = torch.sort(score, stable=True).indices[:MESH_TOPK]
    win = Candidates(**{f: (v[..., order] if f in ("x_seq", "u_seq")
                            else v[order]) for f, v in c._asdict().items()})
    win = win._replace(length=torch.where(score[order] < torch.inf,
                                          win.length, 0))
    commit_candidates(spec2, t_cpu, win)
    trees_agree(t2, t_cpu, f"mesh topk parity card vs cpu (B={B}, "
                f"k={MESH_TOPK}, capacity {MESH_CAP // 2})")

    # (3) exact truncation on one map shard
    centers, radii = prob["obstacles"]
    g = boat.buoy_grid(centers, radii, 0.25)
    map_mesh = meshlib.make_mesh(1, axis="map", device_type=dev)
    grid = ShardedGrid(g.occ, g.origin, g.resolution, 1)
    free = lambda x, u: torch.ones(x.shape[:-1], dtype=torch.bool,  # noqa
                                   device=x.device)
    ss = torch.as_tensor(prob["sample_space"], device=dev)
    gb = torch.tensor([0.3, 0.3, 0, 0, 0, 0], device=dev)
    gen_a = torch.Generator(device=dev).manual_seed(7)
    gen_b = torch.Generator(device=dev).manual_seed(7)
    cut, whole = tree_clone(tree), tree_clone(tree)
    make_map_sharded_round(spec, map_mesh, grid, *args, free, 0.05, gbuf,
                           nearest_fn=nn_a, **common)(
        cut, grid.slab(0, dev), gen_a, goal, ss, gb, goal)
    occ = torch.as_tensor(g.occ, device=dev)
    pred = grid_free_data(g.origin, g.resolution)
    c = make_expand(spec, *args, lambda x, u: pred(x, u, occ), 0.05, gbuf,
                    nearest_fn=nn_a, **common)(
        whole, sample_batch(gen_b, B, ss, gb, goal), goal)
    commit_candidates(spec, whole, c, commit_all=False)
    trees_agree(cut, whole, "mesh exact truncation, one map shard vs the "
                f"whole grid while steering (B={B}, capacity {MESH_CAP})")

    # (4) full-width replans, beside the replan without a mesh
    bias = [0.3, 0.3, 0, 0, 0, 0]
    counters = planner_counters()
    rates, out = {}, {}
    # the mesh planner draws its candidates from ``rank_generator``, the
    # plain one from its seed's generator: a second seed shows the spread
    # that another stream alone gives
    for seed in (0, 1):
        base = full_width_planner(prob, seed=seed)
        base.warmup(prob["x0"], prob["sample_space"], goal_bias=bias)
        replan(f"mesh phase: boat without a mesh, seed {seed}", prob, base,
               bias, 2.0, smi, counters)
        rates[f"no mesh seed {seed}"] = base.stats["expansions_per_s"]
        del base
    fine = boat.buoy_grid(centers, radii, 0.05)
    dp_map = meshlib.make_mesh_dp_map(1, 1, device_type=dev)
    free_prob = boat.default_problem(obstacles=False)
    for label, pr, kw in (
            ("gather", prob, dict(mesh=mesh)),
            ("topk", prob, dict(mesh=mesh, collective="topk",
                                topk=MESH_TOPK, refine=False)),
            ("grid", free_prob, dict(mesh=dp_map, feasibility_grid=ShardedGrid(
                fine.occ, fine.origin, fine.resolution, 1)))):
        planner = full_width_planner(pr, **kw)
        planner.warmup(pr["x0"], pr["sample_space"], goal_bias=bias)
        name = f"mesh {label} boat"
        reached, launches = replan(name, pr, planner, bias, 2.0, smi,
                                   counters)
        st = planner.stats
        rates[label] = st["expansions_per_s"]
        if not reached:
            raise AssertionError(f"{name}: goal not reached: {st}")
        check_plan(pr, planner)
        if label == "grid":
            if kw["feasibility_grid"].occupied_host(
                    planner.x_seq[:, :2]).any():
                raise AssertionError(f"{name}: a plan state on the grid")
        need = ("nn_const",) if label == "grid" else ("nn_const",
                                                      "block_write")
        if min(launches[k] for k in need) < 1:
            raise AssertionError(f"{name}: a kernel was not launched: "
                                 f"{launches}")
        kinds = sorted({k[3] for k in planner._chunk_cache})
        log(f"{name} checks: goal, plan from x0, feasible, in the goal box, "
            f"dynamically consistent{', off the grid' * (label == 'grid')};"
            f" chunks {kinds}, restarts {st['restarts']}, launches "
            f"{launches}")
        out[f"mesh {label}"] = launches
        if label == "gather":
            chunk = planner._get_restart_chunk(None, 0)
            x0 = planner._tensor(prob["x0"])
            cur = planner._seed_tree(x0, planner.goal)
            best = planner._seed_tree(x0, planner.goal)
            pool = planner._tensor(np.linspace(prob["x0"], prob["goal"],
                                               256))
            score = planner._tensor(planner._RSCORE0)
            gbt = planner._tensor(bias)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                chunk(cur, best, pool, score, 0, planner.goal, ss, gbt,
                      planner.goal)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            enqueue = time.perf_counter() - t0
            torch.cuda.synchronize()
            n_cycles, F = planner._restart_chunk_shape
            log(f"mesh sync-free chunk ({n_cycles}x{F} rounds, gather "
                f"each round) under sync_debug_mode='error': ok, "
                f"enqueue_s={enqueue:.3f} total_s="
                f"{time.perf_counter() - t0:.3f}")
        del planner
    log(f"mesh replans [{smi}], expansions/s at 2.0 s, world size 1: "
        + " ".join(f"{k}={v:.1f}" for k, v in rates.items()))

    # (6) the collectives bench, one rank
    bargs = bench_collectives.parse_args(["--device", dev])
    for rec in bench_collectives.bench(bargs, mesh):
        log(f"bench_collectives (world size 1: local copies, not "
            f"interconnect numbers) [{smi}]: {json.dumps(rec)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from lqrrt_tpu_torch.models import boat, car, quadrotor
    from lqrrt_tpu_torch.ops.kernels import _build
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import (make_nearest_const,
                                                       make_nearest_general)
    from lqrrt_tpu_torch.ops.kernels.steer_stages import BODIES
    from lqrrt_tpu_torch.tools.kernel_times import ptxas_summary

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = card_name(torch.device("cuda", 0))
    smi = smi_line()
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t_start = t0 = time.perf_counter()
    _build.lib()
    log(f"build: {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s")
    ptxas = ptxas_summary(BODIES)
    for line in ptxas:
        log(f"  ptxas {line}")
    # kernels A, C, D and E: every instance without spills
    ace_ptxas = [line for line in ptxas
                if line.startswith(("nn_const_kernel", "nn_expand_kernel",
                                    "nn_general_kernel",
                                    "nn_general_any_kernel"))]
    d_ptxas = [line for line in ptxas
               if line.startswith("steer_rollout_kernel")]
    # and the stage scaffold (F2, F3): every stage_kernel instance
    f_ptxas = [line for line in ptxas if line.startswith("stage_kernel")]
    spilled = [line for line in ace_ptxas + d_ptxas + f_ptxas
               if "spill 0/0 B" not in line]
    d_regs = {line.split("<", 1)[1].rsplit(">", 1)[0]:
              int(line.split(": ")[1].split()[0]) for line in d_ptxas}
    moved = {k: (d_regs.get(k), v) for k, v in D_REGISTERS.items()
             if d_regs.get(k) != v}
    log(f"ptxas: D's registers {d_regs}; moved from {D_REGISTERS}: {moved}")
    if (len(ace_ptxas) != N_ACE_INSTANCES or len(d_ptxas) != N_D_INSTANCES
            or len(f_ptxas) != N_STAGE_KERNELS or spilled or moved):
        raise AssertionError(f"ptxas: kernels A, C and E: {len(ace_ptxas)} "
                             f"instances ({N_ACE_INSTANCES} expected), D: "
                             f"{len(d_ptxas)} "
                             f"({N_D_INSTANCES} expected, each model with "
                             "and without a raster), "
                             f"stage_kernel: {len(f_ptxas)} "
                             f"({N_STAGE_KERNELS} expected), spilling "
                             f"{spilled}, D's registers moved {moved}")

    def timed(label, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        log(f"phase {label}: {time.perf_counter() - t:.1f} s")
        return out

    a = timed("kernel A", phase_kernel_a)
    b = timed("kernel B", phase_kernel_b)
    c = timed("kernel C", phase_kernel_c)
    e = timed("kernel E", phase_kernel_e)
    _, e_launches = timed("exp_nn_hybrid main", phase_exp_nn_hybrid, smi)
    d = timed("kernel D", phase_kernel_d)
    _, d_launches = timed("exp_steer_kernel main", phase_exp_steer_kernel,
                          smi)
    timed("kernel D math", phase_math_probes)
    dm = timed("kernel D models", phase_kernel_d_models)
    dm_launches = timed("exp_steer_kernel models main",
                        phase_exp_steer_models, smi)
    timed("kernel D repairs", phase_d_repairs)
    f1 = timed("F1", phase_f1)
    timed("ragged batches", phase_ragged)
    timed("circle counts", phase_circle_counts)
    f1_launches = timed("exp_steer_dv main", phase_exp_steer_dv, smi)
    f2 = timed("F2", phase_f2)
    f2_res, f2_launches = timed("exp_steer_stages main",
                                phase_exp_steer_stages, smi)
    f3_launches, f4_launches, f3, f4 = timed("F3/F4", phase_f3_f4, smi)
    timed("batched CARE", phase_care, [("car", car), ("quadrotor", quadrotor)])
    boat_p, car_p, quad_p = (boat.default_problem(), car.default_problem(),
                             quadrotor.default_problem())
    timed("round parity boat", phase_round_parity, "boat", boat_p,
          make_nearest_const(WRAP))
    timed("round parity car", phase_round_parity, "car", car_p,
          make_nearest_general(2))
    l_boat = timed("boat main path", phase_main_path, "boat", boat_p, smi,
                   [0.3, 0.3, 0, 0, 0, 0], 2.0, "nn_const",
                   extra_budgets=(1.0,))
    boat_bias = [0.3, 0.3, 0, 0, 0, 0]
    grid_p = boat.default_problem(obstacle_model="grid")
    timed("steer route", phase_steer_route, "boat", boat_p, smi, boat_bias)
    timed("steer route grid", phase_steer_route, "grid boat", grid_p, smi,
          boat_bias)
    l_car = timed("car main path", phase_main_path, "car", car_p, smi,
                  [0.3, 0.3, 0, 0], 2.0, "nn_general")
    l_quad = timed("quadrotor main path", phase_main_path, "quadrotor",
                   quad_p, smi, [0.3] * 3 + [0.0] * 9, 3.0, "nn_general")
    l_grid = timed("grid boat main path", phase_main_path, "grid boat",
                   grid_p, smi, boat_bias, 2.0, "nn_const")
    l_host = timed("boat host loop", phase_host_loop, boat_p, smi, boat_bias)
    l_dyn = timed("double integrator moving buoy", phase_dynamic_obstacles,
                  smi)
    a4 = timed("kernel A unwrapped", phase_kernel_a_unwrapped)
    timed("untagged erf", phase_untagged_erf, smi)
    l_stacked = timed("double integrator x5 (n = 20)", phase_stacked, smi)
    timed("exp_quality short", phase_exp_quality, smi)
    l_rewire, rewire_planner = timed("double integrator leaf_rewire",
                                     phase_leaf_rewire, smi)
    timed("refine round parity", phase_refine_round_parity, rewire_planner,
          smi)
    timed("host surface", phase_host_surface, rewire_planner, smi)
    l_demos = timed("demos", phase_demos, smi)
    d_fleet = timed("fleet", phase_fleet, smi)
    l_mesh = timed("mesh", phase_mesh, smi)
    # every planner path's launches of A and B, the paths of 8, 9 and 10
    paths = {"boat": l_boat, "car": l_car, "quadrotor": l_quad,
             "grid boat": l_grid,
             **{f"boat host loop {k}": v for k, v in l_host.items()},
             **{f"double integrator field {i}": v
                for i, v in enumerate(l_dyn)},
             "double integrator leaf_rewire": l_rewire,
             "double integrator x5 (n = 20)": l_stacked,
             **{f"demo {k}": v for k, v in l_demos.items()}, **l_mesh}
    a_paths = {k: v["nn_const"] for k, v in paths.items()
               if v.get("nn_const")}
    c_paths = {"car": l_car["nn_general"], "quadrotor": l_quad["nn_general"],
               **{f"demo {k}": v["nn_general"] for k, v in l_demos.items()
                  if v["nn_general"]}}
    b_paths = {k: v["block_write"] for k, v in paths.items()}
    d_paths = {k: v["steer_rollout"] for k, v in paths.items()
               if v.get("steer_rollout")}
    # bounds of the timed calls, from this run's shapes (size 32768 live
    # rows of N, B candidates): flops a live pair by type, and the inputs
    # read once plus the (ids, cost) written once
    from lqrrt_tpu_torch.tools.kernel_times import (bound, const_bound,
                                                    expand_bound)

    size, pairs = SIZES[-1], SIZES[-1] * B_BENCH

    def nn_bytes(row_floats, n):
        return 4 * (size * row_floats + B_BENCH * n) + 8 * B_BENCH

    # A: 3n + 3 flops a pair, wrapped (``kernel_times.const_flops``)
    a_bound = const_bound(NS, True, size, B_BENCH)
    # A at the double integrator's n = 4, unwrapped: 3n - 1 flops a pair
    a4_bound = const_bound(4, False, size, B_BENCH)
    # B: src read and dst columns written, (100, 6, B) f32 each
    b_bound = bound(None, 2 * 100 * 6 * B_BENCH * 4)
    # C at n = 12: e (n sub), the wrap (mul, rint, fma), and the quadratic
    # form through the symmetric part of S_j (built once a node, outside
    # the pair loop): t = U e (n(n+1)/2 fma), then e . t (n fma)
    nc = 12
    c_bound = bound({"fp32": pairs * (nc + 4 + nc * (nc + 1) + 2 * nc)},
                    nn_bytes(nc * nc + nc, nc))
    e_replaces = {"fma": "tools/exp_nn_hybrid_v5.py:214",
                  "bf16": "tools/exp_nn_hybrid_v5.py:82",
                  "bf16x3": "tools/exp_nn_hybrid_v5.py:341"}
    cq = c[12]
    kernels = [
        dict(name="nn_const", route="cuda",
             source="lqrrt_tpu_torch/csrc/nn_const.cu",
             replaces="lqrrt_tpu/ops/pallas/nn_kernel.py:415",
             launches=sum(a_paths.values()), launches_by_path=a_paths,
             max_abs_err=max(a["max_abs_err"], a4["max_abs_err"]),
             ms=a["ms"], device_ms=a["device_ms"],
             launch_device_ms=a["launch_device_ms"],
             prep_device_ms=a["prep_device_ms"], plain_ms=a["plain_ms"],
             bound_ms=a_bound[0], bound_by=a_bound[1], library_ms=None,
             id_match={str(k): v for k, v in a["id_match"].items()},
             n4_unwrapped=dict(
                 ms=a4["ms"], device_ms=a4["device_ms"],
                 launch_device_ms=a4["launch_device_ms"],
                 plain_ms=a4["plain_ms"], bound_ms=a4_bound[0],
                 bound_by=a4_bound[1],
                 id_match={str(k): v for k, v in a4["id_match"].items()}),
             ptxas=[line for line in ace_ptxas
                    if line.startswith("nn_const_kernel")]),
        dict(name="block_write", route="cuda",
             source="lqrrt_tpu_torch/csrc/block_write.cu",
             replaces="lqrrt_tpu/ops/pallas/write_kernel.py:26",
             launches=sum(b_paths.values()), launches_by_path=b_paths,
             max_abs_err=b["max_abs_err"], ms=b["ms"],
             device_ms=b["device_ms"], plain_ms=b["plain_ms"],
             bound_ms=b_bound[0], bound_by=b_bound[1],
             library_ms=b["library_ms"],
             library_device_ms=b["library_device_ms"], alone=b["alone"]),
        dict(name="nn_general", route="cuda",
             source="lqrrt_tpu_torch/csrc/nn_general.cu",
             replaces="lqrrt_tpu/ops/pallas/nn_kernel.py:177",
             launches=sum(c_paths.values()), launches_by_path=c_paths,
             max_abs_err=max(v["max_abs_err"] for v in c.values()),
             ms=cq["ms"], device_ms=cq["device_ms"],
             launch_device_ms=cq["launch_device_ms"],
             device_ms_n4=c[4]["device_ms"], plain_ms=cq["plain_ms"],
             bound_ms=c_bound[0], bound_by=c_bound[1], library_ms=None,
             id_match={f"n={n}": v["id_match"] for n, v in c.items()},
             ptxas=[line for line in ace_ptxas
                    if line.startswith("nn_general")]),
    ]
    for mode in e_replaces:
        # E: the cross term and the wrap's epilogue
        # (``kernel_times.expand_flops``)
        eb = expand_bound(mode, NS, True, size, B_BENCH)
        top = e[(mode, WRAP, size)]
        kernels.append(dict(
            name=f"nn_expand[{mode}]", route="cuda",
            source="lqrrt_tpu_torch/csrc/nn_expand.cu",
            replaces=e_replaces[mode], launches=e_launches[mode],
            max_abs_err=max(v["max_abs_err"] for k, v in e.items()
                            if k[0] == mode),
            ms=top["ms"], device_ms=top["device_ms"],
            launch_device_ms=top["launch_device_ms"],
            plain_ms=top["plain_ms"], bound_ms=eb[0],
            bound_by=eb[1], library_ms=None))
    d_replaces = {"flat": "tools/steer_kernel_experimental.py:72",
                  "tree": "tools/steer_kernel_experimental.py:340"}
    for variant, replaces in d_replaces.items():
        # the flat variant is the planner's steer: its launches on the
        # planner's paths; the tree variant is off the path
        by_path = (dict(launches=sum(d_paths.values()),
                        launches_by_path=d_paths,
                        exp_tool_launches=d_launches[variant])
                   if variant == "flat"
                   else dict(launches=d_launches[variant]))
        kernels.append(dict(
            name="steer_rollout" + ("_tree" if variant == "tree" else ""),
            route="cuda", source="lqrrt_tpu_torch/csrc/steer_rollout.cu",
            replaces=replaces, **by_path, **d[variant], library_ms=None))
    # D's raster instance (Raster<Boat>) on the grid boat's predicate: its
    # launches are the grid boat's main path's
    kernels.append(dict(
        name="steer_rollout[grid]", route="cuda",
        source="lqrrt_tpu_torch/csrc/steer_rollout.cu",
        replaces=d_replaces["flat"], launches=l_grid["steer_rollout"],
        **d["flat[grid]"], library_ms=None))
    # the fleet's round (phase 12): 65,536 rows, one goal a row
    kernels.append(dict(
        name="steer_rollout[fleet]", route="cuda",
        source="lqrrt_tpu_torch/csrc/steer_rollout.cu",
        replaces=d_replaces["flat"], **d_fleet, library_ms=None))
    for name in D_MODELS:
        for variant, replaces in d_replaces.items():
            kernels.append(dict(
                name=f"steer_rollout{'_tree' if variant == 'tree' else ''}"
                f"[{name}]", route="cuda",
                source="lqrrt_tpu_torch/csrc/steer_rollout.cu",
                replaces=replaces, launches=dm_launches[name][variant],
                **dm[name][variant], library_ms=None))
    kernels += f_kernels(f1, f1_launches, f2, f2_res, f2_launches, f3,
                         f3_launches, f4, f4_launches, f_ptxas)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
