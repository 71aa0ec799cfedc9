"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compile the CUDA kernels from ``lqrrt_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), with ``ptxas``'s resource lines; every
   instance of kernels A, D and E and all 15 of the stage scaffold's
   ``stage_kernel`` (F2, F3) without spills;
3. kernel A (nn_const) vs its plain PyTorch version at N = 40960,
   B = 8192 with an fp64 brute-force anchor: the boat's n = 6 (wrap dim 2)
   at sizes 0 to 32768, the root-pad tie at sizes 1024 and 32768, NaN
   state rows inside and past size, n = 4, 12 and 16 wrapped at the first
   and the last dim and unwrapped; id match >= 0.999 at each; then the
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
   times, the wrapper alone and the launch alone;
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
   B = 8192, H = 100 on the boat, on a batch that reaches every branch of
   the step (goal stop, infeasible stop, length 0, the psi wrap, saturated
   efforts): every field of the result bit for bit, agreement of length,
   in_goal and reached, max |dx| and |du| where lengths agree, the branch
   counts, and both times; then kernel D's
   main path, the experiment's entry point
   ``lqrrt_tpu_torch.tools.exp_steer_kernel.main`` at full width (B = 8192,
   a tree of N = 40960 rows), with the launch counts set to 0 just before
   and read just after;
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
   after; then one restart chunk of each under
   ``torch.cuda.set_sync_debug_mode("error")``.

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

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


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
    past size; n = 4, 12 and 16 wrapped at the first and the last dim and
    unwrapped.  Gates: id match >= 0.999, fp64 excess and anchors <=
    TOL_EXCESS.  Then the times at n = 6, size 32768: the wrapper with its
    dispatch, alone (``device_ms``), its launch alone and its prep alone
    (the candidate mean and the fill of the keys), and the plain
    version."""
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
    for n in (4, 12, 16):
        for wrap in (0, n - 1, None):
            st_n, S_n, xr_n = const_inputs(n, wrap, "cuda", 30 + n)
            for size in (4097, 32768):
                check_nn(fns, f"n={n} wrap={wrap}", st_n, S_n, xr_n, size,
                         wrap, gate_ids=True)

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
    included) and the launch alone on folded rows."""
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


def phase_kernel_d():
    """Kernel D (steer_rollout), flat and tree-gather, against its plain
    version at B = 8192, H = 100 on the boat's operating point, on
    ``branch_batch`` (every branch of the step reached).  The tree holds
    N_BENCH rows, with the batch's x0 at distinct random rows and a gain of
    its own in each row (the boat's K scaled by 0.5-1.5), so that the
    in-kernel gather of K is checked too.  Returns per variant the numbers
    of the kernels line."""
    from lqrrt_tpu_torch.tools.exp_steer_kernel import (agreement,
                                                        branch_counts,
                                                        device_ms)
    from lqrrt_tpu_torch.tools.kernel_times import (same_result, steer_bound,
                                                    steer_calls, steer_inputs)

    dev = "cuda"
    t = steer_inputs(dev, B_BENCH, 19, N_BENCH)
    x0_np, xtar_np, pids, ncirc = (t["x0_np"], t["xtar_np"], t["pids"],
                                   t["ncirc"])
    calls = steer_calls(t)
    cases = {v: calls[v] for v in ("flat", "tree")}
    # the kernel sums 6 terms in the order of PyTorch's CUDA reduction
    # (sum6 in csrc/steer_rollout.cu): the share of rows where it is
    # torch.sum's order, printed since bit-for-bit agreement rests on it
    a = torch.randn((65536, 6), generator=torch.Generator(device=dev)
                    .manual_seed(29), device=dev) * 100.0
    sum6 = ((a[:, 0] + a[:, 4]) + a[:, 2]) + ((a[:, 1] + a[:, 5]) + a[:, 3])
    log(f"kernel D: torch.sum of 6 in sum6's order on "
        f"{(sum6 == a.sum(-1)).double().mean().item():.6f} of rows")
    out = {}
    for variant, (kernel, plain_fn) in cases.items():
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
        rows_read = (int(torch.unique(pids).numel()) if variant == "tree"
                     else B_BENCH)
        bound_ms, bound_by, flops, nbytes = steer_bound(
            res, rows_read, ncirc, variant == "tree")
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
    model's sample space, against scipy's float64 CARE on a subsample."""
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
        S, K = riccati.care_lqr(A, B, Q, R)
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


def check_plan(prob, planner):
    n, m = prob["constraints"].nstates, prob["constraints"].ncontrols
    x_seq, u_seq = planner.x_seq, planner.u_seq
    if not (np.all(np.isfinite(x_seq)) and np.all(np.isfinite(u_seq))
            and x_seq.shape[1] == n and u_seq.shape == (len(x_seq) - 1, m)):
        raise AssertionError("plan has the wrong shape or non-finite values")
    if not np.allclose(x_seq[0], prob["x0"], atol=1e-5):
        raise AssertionError("plan does not start at x0")
    feas = prob["constraints"].is_feasible(torch.as_tensor(x_seq[1:]),
                                           torch.as_tensor(u_seq))
    if not bool(feas.all()):
        raise AssertionError("plan infeasible at some step")
    wrap = list(prob["wrap_dims"])
    e = prob["goal"] - x_seq[-1]
    e[wrap] = (e[wrap] + np.pi) % (2 * np.pi) - np.pi
    if not np.all(np.abs(e) <= prob["constraints"].goal_buffer + 0.1):
        raise AssertionError(f"plan ends outside the goal box: {e}")
    xn = prob["dynamics"](torch.as_tensor(x_seq[:-1]), torch.as_tensor(u_seq),
                          prob["dt"]).numpy()
    d = xn - x_seq[1:]
    d[:, wrap] = (d[:, wrap] + np.pi) % (2 * np.pi) - np.pi
    err = np.max(np.abs(d), axis=1)
    if not (np.median(err) < 1e-3 and np.max(err) < 0.2):
        raise AssertionError(f"plan not dynamically consistent: median "
                             f"{np.median(err)}, max {np.max(err)}")


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
        f"nodes={st['nodes']} peak_mem_GiB={peak:.2f} launches={launches}")
    return reached, launches


def phase_main_path(name, prob, smi, bias, budget, nn, extra_budgets=()):
    """The replan at full width through nn (the kernel the planner must
    pick), then one chunk under sync-debug mode 'error'."""
    import lqrrt_tpu_torch
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const, nn_general
    from lqrrt_tpu_torch.ops.kernels.write_kernel import block_write

    counters = {nn: {"nn_const": nn_const, "nn_general": nn_general}[nn],
                "block_write": block_write}
    planner = lqrrt_tpu_torch.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        erf=prob["erf"], printing=True, batch_size=8192, capacity=32768,
        wrap_dims=prob["wrap_dims"], saturate=prob["saturate"],
        device="cuda", seed=0)
    t0 = time.perf_counter()
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=bias)
    torch.cuda.synchronize()
    log(f"{name} warmup: {time.perf_counter() - t0:.3f} s")
    if planner.nn_selected != nn:
        raise AssertionError(f"{name}: NN is {planner.nn_selected}, not {nn}")

    reached, launches = replan(name, prob, planner, bias, budget, smi,
                               counters)
    if not reached:
        raise AssertionError(f"{name}: goal not reached: {planner.stats}")
    check_plan(prob, planner)
    if min(launches.values()) < 1:
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
    kind = torch.cuda.get_device_name(0)
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
    # kernels A, D and E: every instance without spills
    ae_ptxas = [line for line in ptxas
                if line.startswith(("nn_const_kernel", "nn_expand_kernel"))]
    d_ptxas = [line for line in ptxas
               if line.startswith("steer_rollout_kernel")]
    # and the stage scaffold (F2, F3): every stage_kernel instance
    f_ptxas = [line for line in ptxas if line.startswith("stage_kernel")]
    spilled = [line for line in ae_ptxas + d_ptxas + f_ptxas
               if "spill 0/0 B" not in line]
    if (len(ae_ptxas) != 38 or len(d_ptxas) != 1
            or len(f_ptxas) != N_STAGE_KERNELS or spilled):
        raise AssertionError(f"ptxas: kernels A and E: {len(ae_ptxas)} "
                             f"instances (38 expected), D: {len(d_ptxas)} "
                             f"(1 expected), stage_kernel: {len(f_ptxas)} "
                             f"({N_STAGE_KERNELS} expected), spilling "
                             f"{spilled}")

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
    l_car = timed("car main path", phase_main_path, "car", car_p, smi,
                  [0.3, 0.3, 0, 0], 2.0, "nn_general")
    l_quad = timed("quadrotor main path", phase_main_path, "quadrotor",
                   quad_p, smi, [0.3] * 3 + [0.0] * 9, 3.0, "nn_general")
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
             launches=l_boat["nn_const"], max_abs_err=a["max_abs_err"],
             ms=a["ms"], device_ms=a["device_ms"],
             launch_device_ms=a["launch_device_ms"],
             prep_device_ms=a["prep_device_ms"], plain_ms=a["plain_ms"],
             bound_ms=a_bound[0], bound_by=a_bound[1], library_ms=None,
             id_match={str(k): v for k, v in a["id_match"].items()},
             ptxas=[line for line in ae_ptxas
                    if line.startswith("nn_const_kernel")]),
        dict(name="block_write", route="cuda",
             source="lqrrt_tpu_torch/csrc/block_write.cu",
             replaces="lqrrt_tpu/ops/pallas/write_kernel.py:26",
             launches=sum(l["block_write"] for l in (l_boat, l_car, l_quad)),
             max_abs_err=b["max_abs_err"], ms=b["ms"],
             device_ms=b["device_ms"], plain_ms=b["plain_ms"],
             bound_ms=b_bound[0], bound_by=b_bound[1],
             library_ms=b["library_ms"],
             library_device_ms=b["library_device_ms"], alone=b["alone"]),
        dict(name="nn_general", route="cuda",
             source="lqrrt_tpu_torch/csrc/nn_general.cu",
             replaces="lqrrt_tpu/ops/pallas/nn_kernel.py:177",
             launches=l_car["nn_general"] + l_quad["nn_general"],
             max_abs_err=max(v["max_abs_err"] for v in c.values()),
             ms=cq["ms"], device_ms=cq["device_ms"],
             launch_device_ms=cq["launch_device_ms"],
             device_ms_n4=c[4]["device_ms"], plain_ms=cq["plain_ms"],
             bound_ms=c_bound[0], bound_by=c_bound[1], library_ms=None,
             id_match={f"n={n}": v["id_match"] for n, v in c.items()}),
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
        kernels.append(dict(
            name="steer_rollout" + ("_tree" if variant == "tree" else ""),
            route="cuda", source="lqrrt_tpu_torch/csrc/steer_rollout.cu",
            replaces=replaces, launches=d_launches[variant],
            **d[variant], library_ms=None))
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
