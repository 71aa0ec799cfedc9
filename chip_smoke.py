"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compile the CUDA kernels from ``lqrrt_tpu_torch/csrc`` (one
   ``nvcc`` per source, in parallel), with ``ptxas``'s resource lines;
3. kernel A (nn_const) vs its plain PyTorch version at bench shapes, with an
   fp64 brute-force anchor, and both times (the plain version's at size
   32768 only, as for kernel C);
4. kernel B (block_write) vs its plain version, bit for bit, and both times;
5. kernel C (nn_general) vs its plain version at N = 40960, B = 8192 for
   n = 4 (wrap dim 2) and n = 12 (wrap dim 5) with random SPD per-node S,
   with an fp64 brute-force anchor, and both times;
5b. kernel E (nn_expand) in each cross-term mode (fma, bf16, bf16x3) vs
   its plain version at N = 40960, B = 8192, boat S and boat-scale data,
   sizes 512 / 8704 / 32768, wrap dim 2 and unwrapped: id match, fp64
   excess and an fp64 brute-force anchor against the mode's error bound,
   cost agreement, and the times of the kernel, the wrapper (prep
   included) and the plain version; kernel A's launch alone on the same
   inputs; then kernel E's main path, the experiment's entry point
   ``lqrrt_tpu_torch.tools.exp_nn_hybrid.main`` at full width, with the
   launch counts set to 0 just before and read just after;
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
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import re
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
# H100 SXM peaks (NVIDIA's data sheet, dense): flop/s by type, HBM bytes/s
PEAKS = {"fp32": 67e12, "bf16": 989e12}
HBM_BYTES_PER_S = 3.35e12


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


def ptxas_summary(build_log: str):
    """One line per kernel instance from ``ptxas -v``: registers, shared
    memory and spills, with the kernel's name and state dimension."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_(?:kernel|merge))"
                          r"(?:I((?:L[a-z]\d+E)+)E)?", m.group(1))
            args = re.findall(r"L[a-z](\d+)E", k.group(2) or "") if k else []
            name = (m.group(1) if k is None else
                    k.group(1) + (f"<{','.join(args)}>" if args else ""))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, "
                       f"{m.group(2) or 0} B smem, {spill}")
            name = None
    return out


def phase_kernel_a():
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const, nn_const_plain

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(3)
    scale = torch.tensor([40.0, 40.0, math.pi, 3.0, 3.0, 1.0], device=dev)
    states = (torch.rand((N_BENCH, NS), generator=g, device=dev) * 2 - 1) \
        * scale
    xr = (torch.rand((B_BENCH, NS), generator=g, device=dev) * 2 - 1) * scale
    A = torch.randn((NS, NS), generator=g, device=dev) * 0.3
    S = A @ A.T + 2.0 * torch.eye(NS, device=dev)
    st64, xr64, S64 = states.double(), xr.double(), S.double()
    anchor = torch.arange(0, B_BENCH, B_BENCH // 256, device=dev)[:256]
    out = {}
    for size in SIZES:
        sz = torch.tensor(size, dtype=torch.int32, device=dev)
        ik, ck = nn_const(states, S, sz, xr, wrap_dim=WRAP)
        ip, cp = nn_const_plain(states, S, sz, xr, wrap_dim=WRAP)
        torch.cuda.synchronize()
        id_match = (ik == ip).double().mean().item()
        c_k = wrapped_cost64(xr64, st64[ik.long()], S64)
        c_p = wrapped_cost64(xr64, st64[ip.long()], S64)
        excess = ((c_k - c_p) / c_p.abs().clamp(min=1e-6)).max().item()
        c_star = wrapped_cost64(xr64[anchor, None, :], st64[None, :size, :],
                                S64).min(dim=1).values
        anchor_k = ((c_k[anchor] - c_star)
                    / c_star.abs().clamp(min=1e-6)).max().item()
        anchor_p = ((c_p[anchor] - c_star)
                    / c_star.abs().clamp(min=1e-6)).max().item()
        max_err = (ck - cp).abs().max().item()
        ms = cuda_ms(lambda: nn_const(states, S, sz, xr, wrap_dim=WRAP))
        # the plain version is timed at the top size only (script time)
        plain_ms = cuda_ms(
            lambda: nn_const_plain(states, S, sz, xr, wrap_dim=WRAP),
            reps=5) if size == SIZES[-1] else None
        live_ids_ok = bool((ik < size).all().item())
        log(f"kernel A nn_const size={size}: id_match={id_match:.6f} "
            f"fp64_excess={excess:.3e} anchor_kernel={anchor_k:.3e} "
            f"anchor_plain={anchor_p:.3e} max_abs_cost_err={max_err:.3e} "
            f"kernel_ms={ms:.4f}"
            + (f" plain_ms={plain_ms:.4f}" if plain_ms is not None else ""))
        if not (live_ids_ok and excess <= TOL_EXCESS
                and anchor_k <= TOL_EXCESS and anchor_p <= TOL_EXCESS):
            raise AssertionError(f"kernel A disagrees at size={size}")
        out[size] = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                         id_match=id_match, fp64_excess=excess)
    return out


def phase_kernel_b():
    from lqrrt_tpu_torch.ops.kernels.write_kernel import (block_write,
                                                          block_write_plain)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(5)
    timing = {}
    max_err = 0.0
    for C in (6, 3):
        dst0 = torch.randn((100, C, N_BENCH), generator=g, device=dev)
        src = torch.randn((100, C, B_BENCH), generator=g, device=dev)
        for start in (512, 512 + 8192, 24576 + 512, 1000, 37000):
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
        log(f"kernel B block_write (100,{C},{N_BENCH}) B={B_BENCH}: "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={library_ms:.4f} (slice copy_)")
        timing[C] = (ms, plain_ms, library_ms)
    return dict(max_abs_err=max_err, ms=timing[6][0], plain_ms=timing[6][1],
                library_ms=timing[6][2])


def phase_kernel_c():
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import (nn_general,
                                                       nn_general_plain)

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(7)
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
        st64, xr64, S64 = states.double(), xr.double(), S.double()
        anchor = torch.arange(0, B_BENCH, B_BENCH // 256, device=dev)[:256]
        for size in SIZES:
            sz = torch.tensor(size, dtype=torch.int32, device=dev)
            ik, ck = nn_general(states, S, sz, xr, wrap_dim=wrap)
            ip, cp = nn_general_plain(states, S, sz, xr, wrap_dim=wrap)
            torch.cuda.synchronize()
            id_match = (ik == ip).double().mean().item()
            c_k = wrapped_cost64(xr64, st64[ik.long()], S64[ik.long()], wrap)
            c_p = wrapped_cost64(xr64, st64[ip.long()], S64[ip.long()], wrap)
            excess = rel_excess(c_k, c_p)
            c_star = torch.full((256,), math.inf, dtype=torch.float64,
                                device=dev)
            for j0 in range(0, size, 2048):
                j1 = min(j0 + 2048, size)
                c = wrapped_cost64(xr64[anchor, None, :], st64[None, j0:j1],
                                   S64[None, j0:j1], wrap)
                c_star = torch.minimum(c_star, c.min(dim=1).values)
            anchor_k = rel_excess(c_k[anchor], c_star)
            anchor_p = rel_excess(c_p[anchor], c_star)
            max_err = (ck - cp).abs().max().item()
            max_rel = ((ck - cp).abs() / cp.abs().clamp(min=1e-6)).max().item()
            ms = cuda_ms(lambda: nn_general(states, S, sz, xr, wrap_dim=wrap))
            # the plain version is timed at the top size only (script time)
            plain_ms = cuda_ms(
                lambda: nn_general_plain(states, S, sz, xr, wrap_dim=wrap),
                reps=5) if size == SIZES[-1] else None
            live_ids_ok = bool((ik < size).all().item())
            log(f"kernel C nn_general n={n} wrap={wrap} size={size}: "
                f"id_match={id_match:.6f} fp64_excess={excess:.3e} "
                f"anchor_kernel={anchor_k:.3e} anchor_plain={anchor_p:.3e} "
                f"max_abs_cost_err={max_err:.3e} "
                f"max_rel_cost_err={max_rel:.3e} kernel_ms={ms:.4f}"
                + (f" plain_ms={plain_ms:.4f}" if plain_ms is not None
                   else ""))
            if not (live_ids_ok and excess <= TOL_EXCESS
                    and anchor_k <= TOL_EXCESS and anchor_p <= TOL_EXCESS):
                raise AssertionError(f"kernel C disagrees at n={n}, "
                                     f"size={size}")
            out[(n, size)] = dict(max_abs_err=max_err, ms=ms,
                                  plain_ms=plain_ms)
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
        ERROR, MODES, error_scale, expand_prep, launch_expand, nn_exp,
        nn_expand_plain, nn_hybrid, nn_split3, pick_cost64)
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import _launch, nn_const_prep
    from lqrrt_tpu_torch.tools.exp_nn_hybrid import problem

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
                # the kernel alone, on prepared features, and the wrapper
                # (prep and launch)
                ms = cuda_ms(lambda: launch_expand(p, sz, mode, wrapped),
                             reps=50)
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
                    f"cost_err/M={cost_err:.3e} kernel_ms={ms:.4f} "
                    f"wrapper_ms={wrapper_ms:.4f} plain_ms={plain_ms:.4f} "
                    "(no single PyTorch call computes this function) "
                    f"t={time.perf_counter() - t_cfg:.2f} s")
                if not (live_ok and id_match >= 0.999 and excess <= 1.0
                        and anchor_k <= 1.0 and anchor_p <= 1.0
                        and cost_err <= TOL_SUM):
                    raise AssertionError(f"kernel E disagrees in mode {mode} "
                                         f"at wrap={wrap}, size={size}")
                out[(mode, wrap, size)] = dict(max_abs_err=max_err, ms=ms,
                                               plain_ms=plain_ms)
    # kernel A's launch alone on the same inputs, for the like-for-like
    # comparison
    sz = torch.tensor(SIZES[-1], dtype=torch.int32, device="cuda")
    z, w, xa, ra, c = nn_const_prep(states, S, xr, WRAP)
    ids = torch.empty(B_BENCH, dtype=torch.int32, device="cuda")
    cost = torch.empty(B_BENCH, dtype=torch.float32, device="cuda")
    a_ms = cuda_ms(lambda: _launch("lqrrt_nn_const", z, xa, w, ra, c, sz, ids,
                                   cost, N_BENCH, B_BENCH, NS, 1))
    log(f"kernel A nn_const launch alone, same inputs, wrap={WRAP} "
        f"size={SIZES[-1]}: kernel_ms={a_ms:.4f}")
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


def bound(flops=None, nbytes=0.0):
    """(ms, what bounds it): the larger of the bytes over the memory rate
    and each type's operations over its peak (PEAKS)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max([f / PEAKS[k] * 1e3 for k, f in (flops or {}).items()],
                default=0.0)
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


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
    ptxas_log = _build.ptxas_log_path()
    for line in ptxas_summary(ptxas_log.read_text()
                              if ptxas_log.exists() else ""):
        log(f"  ptxas {line}")

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
    size, pairs = SIZES[-1], SIZES[-1] * B_BENCH

    def nn_bytes(row_floats, n):
        return 4 * (size * row_floats + B_BENCH * n) + 8 * B_BENCH

    # A: per dim, d = z - w - k c (sub, fma) and acc += d^2 (fma); the
    # turn count k (sub, mul, rint)
    a_bound = bound({"fp32": pairs * (NS * 5 + 3)}, nn_bytes(NS, NS))
    # B: src read and dst columns written, (100, 6, B) f32 each
    b_bound = bound(None, 2 * 100 * 6 * B_BENCH * 4)
    # C at n = 12: e (n sub), the wrap (mul, rint, fma), and the quadratic
    # form through the symmetric part of S_j (built once a node, outside
    # the pair loop): t = U e (n(n+1)/2 fma), then e . t (n fma)
    nc = 12
    c_bound = bound({"fp32": pairs * (nc + 4 + nc * (nc + 1) + 2 * nc)},
                    nn_bytes(nc * nc + nc, nc))
    # E: the epilogue (sub, mul, rint, add, fma, mul, fma: 9 flops) and the
    # cross term: n multiply-adds onto |z_j|^2 (psi's leading 1 and the
    # zero pad are layout, not work), in fp32, or in bf16 a pass (3 passes,
    # and one fp32 add, in bf16x3)
    e_flops = {"fma": {"fp32": 9 + 2 * NS},
               "bf16": {"fp32": 9, "bf16": 2 * NS},
               "bf16x3": {"fp32": 10, "bf16": 3 * 2 * NS}}
    e_replaces = {"fma": "tools/exp_nn_hybrid_v5.py:214",
                  "bf16": "tools/exp_nn_hybrid_v5.py:82",
                  "bf16x3": "tools/exp_nn_hybrid_v5.py:341"}
    cq = c[(12, 32768)]
    kernels = [
        dict(name="nn_const", route="cuda",
             source="lqrrt_tpu_torch/csrc/nn_const.cu",
             replaces="lqrrt_tpu/ops/pallas/nn_kernel.py:415",
             launches=l_boat["nn_const"],
             max_abs_err=a[32768]["max_abs_err"],
             ms=a[32768]["ms"], plain_ms=a[32768]["plain_ms"],
             bound_ms=a_bound[0], bound_by=a_bound[1], library_ms=None),
        dict(name="block_write", route="cuda",
             source="lqrrt_tpu_torch/csrc/block_write.cu",
             replaces="lqrrt_tpu/ops/pallas/write_kernel.py:26",
             launches=sum(l["block_write"] for l in (l_boat, l_car, l_quad)),
             max_abs_err=b["max_abs_err"], ms=b["ms"],
             plain_ms=b["plain_ms"], bound_ms=b_bound[0],
             bound_by=b_bound[1], library_ms=b["library_ms"]),
        dict(name="nn_general", route="cuda",
             source="lqrrt_tpu_torch/csrc/nn_general.cu",
             replaces="lqrrt_tpu/ops/pallas/nn_kernel.py:177",
             launches=l_car["nn_general"] + l_quad["nn_general"],
             max_abs_err=max(v["max_abs_err"] for v in c.values()),
             ms=cq["ms"], plain_ms=cq["plain_ms"], bound_ms=c_bound[0],
             bound_by=c_bound[1], library_ms=None),
    ]
    for mode, flops in e_flops.items():
        eb = bound({k: pairs * f for k, f in flops.items()},
                   nn_bytes(NS, NS))
        top = e[(mode, WRAP, size)]
        kernels.append(dict(
            name=f"nn_expand[{mode}]", route="cuda",
            source="lqrrt_tpu_torch/csrc/nn_expand.cu",
            replaces=e_replaces[mode], launches=e_launches[mode],
            max_abs_err=max(v["max_abs_err"] for k, v in e.items()
                            if k[0] == mode),
            ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=eb[0],
            bound_by=eb[1], library_ms=None))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
