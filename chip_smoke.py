"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero:

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compile the CUDA kernels from ``lqrrt_tpu_torch/csrc``;
3. kernel A (nn_const) vs its plain PyTorch version at bench shapes, with an
   fp64 brute-force anchor, and both times;
4. kernel B (block_write) vs its plain version, bit for bit, and both times;
5. round parity: one expansion round on the card against the same round on
   the CPU (plain versions) on the same tree and candidates;
6. main path: the boat replan at full width (batch 8192, capacity 32768)
   through ``Planner.warmup`` and ``update_plan``, checked for goal,
   feasibility, goal box and dynamic consistency, with the kernels' launch
   counts taken over that replan; then one restart chunk under
   ``torch.cuda.set_sync_debug_mode("error")``.

The last two lines are a JSON object with the kernels' checks and times and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the package
beside it, the script exits non-zero and prints no result.
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

TOL_EXCESS = 1e-4      # fp64 relative cost excess allowed for kernel A picks
N_BENCH, B_BENCH, NS, WRAP = 40960, 8192, 6, 2


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


def wrapped_cost64(xr, st, S64):
    """fp64 metric (B, .) between candidates xr (B, n) and nodes st."""
    e = xr - st
    e[..., WRAP] = torch.remainder(e[..., WRAP] + math.pi,
                                   2 * math.pi) - math.pi
    return torch.einsum("...i,ij,...j->...", e, S64, e)


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
    for size in (512, 8704, 32768):
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
        plain_ms = cuda_ms(
            lambda: nn_const_plain(states, S, sz, xr, wrap_dim=WRAP))
        live_ids_ok = bool((ik < size).all().item())
        log(f"kernel A nn_const size={size}: id_match={id_match:.6f} "
            f"fp64_excess={excess:.3e} anchor_kernel={anchor_k:.3e} "
            f"anchor_plain={anchor_p:.3e} max_abs_cost_err={max_err:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
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
        log(f"kernel B block_write (100,{C},{N_BENCH}) B={B_BENCH}: "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        timing[C] = (ms, plain_ms)
    return dict(max_abs_err=max_err, ms=timing[6][0], plain_ms=timing[6][1])


def phase_round_parity(prob):
    """One round at B=512, capacity=4096 on the card vs on the CPU."""
    from lqrrt_tpu_torch.core.rounds import (RoundSpec, commit_candidates,
                                             make_expand)
    from lqrrt_tpu_torch.core.tree import init_tree
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import make_nearest_const

    B, cap, H = 512, 4096, 100
    spec = RoundSpec(nstates=6, ncontrols=3, batch=B, horizon_steps=H,
                     capacity=cap, dt=prob["dt"], nn_block=1024, slack=1024)
    rng = np.random.default_rng(11)
    lo, hi = prob["sample_space"][:, 0], prob["sample_space"][:, 1]
    xrands = [rng.uniform(lo, hi, (B, 6)).astype(np.float32)
              for _ in range(4)]
    wrap_mask = np.zeros(6, bool)
    wrap_mask[WRAP] = True

    def run(device, tree=None):
        expand = make_expand(spec, prob["dynamics"], prob["lqr"],
                             prob["erf"], prob["constraints"].is_feasible,
                             0.05, prob["constraints"].goal_buffer,
                             wrap_mask=wrap_mask, saturate=prob["saturate"],
                             nearest_fn=make_nearest_const(WRAP))
        goal = torch.as_tensor(prob["goal"], device=device)
        if tree is None:
            x0 = torch.as_tensor(prob["x0"], device=device)
            S0, K0 = prob["lqr"](x0, torch.zeros(3, device=device))
            tree = init_tree(cap, H, 6, 3, x0, S0, K0,
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
    pid_match = (c_cpu.pids == c_gpu.pids.cpu()).double().mean().item()
    len_match = (c_cpu.length == c_gpu.length.cpu()).double().mean().item()
    same = c_cpu.length == c_gpu.length.cpu()
    dx = (c_cpu.x_seq - c_gpu.x_seq.cpu()).abs()[:, :, same]
    max_dx = float(dx.max()) if dx.numel() else 0.0
    log(f"round parity card vs cpu (B={B}, capacity={cap}): "
        f"pid_match={pid_match:.4f} length_match={len_match:.4f} "
        f"max_abs_x_seq_err={max_dx:.3e}")
    if not (pid_match >= 0.99 and len_match >= 0.99 and max_dx <= 1e-3
            and bool(torch.isfinite(c_gpu.x_seq).all())):
        raise AssertionError("the card's round disagrees with the CPU's")


def check_plan(prob, planner):
    x_seq, u_seq = planner.x_seq, planner.u_seq
    if not (np.all(np.isfinite(x_seq)) and np.all(np.isfinite(u_seq))
            and x_seq.shape[1] == 6 and u_seq.shape == (len(x_seq) - 1, 3)):
        raise AssertionError("plan has the wrong shape or non-finite values")
    if not np.allclose(x_seq[0], prob["x0"], atol=1e-5):
        raise AssertionError("plan does not start at x0")
    feas = prob["constraints"].is_feasible(torch.as_tensor(x_seq[1:]),
                                           torch.as_tensor(u_seq))
    if not bool(feas.all()):
        raise AssertionError("plan infeasible at some step")
    e = np.abs(prob["goal"] - x_seq[-1])
    if not np.all(e <= prob["constraints"].goal_buffer + 0.1):
        raise AssertionError(f"plan ends outside the goal box: {e}")
    xn = prob["dynamics"](torch.as_tensor(x_seq[:-1]), torch.as_tensor(u_seq),
                          prob["dt"]).numpy()
    d = xn - x_seq[1:]
    d[:, WRAP] = (d[:, WRAP] + np.pi) % (2 * np.pi) - np.pi
    err = np.max(np.abs(d), axis=1)
    if not (np.median(err) < 1e-3 and np.max(err) < 0.2):
        raise AssertionError(f"plan not dynamically consistent: median "
                             f"{np.median(err)}, max {np.max(err)}")


def phase_main_path(prob, smi):
    import lqrrt_tpu_torch
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const
    from lqrrt_tpu_torch.ops.kernels.write_kernel import block_write

    planner = lqrrt_tpu_torch.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        erf=prob["erf"], printing=True, batch_size=8192, capacity=32768,
        wrap_dims=prob["wrap_dims"], saturate=prob["saturate"],
        device="cuda", seed=0)
    bias = [0.3, 0.3, 0, 0, 0, 0]
    t0 = time.perf_counter()
    planner.warmup(prob["x0"], prob["sample_space"], goal_bias=bias)
    torch.cuda.synchronize()
    log(f"main path warmup: {time.perf_counter() - t0:.3f} s")
    if planner.nn_selected != "nn_const":
        raise AssertionError(f"NN is {planner.nn_selected}, not the kernel")

    nn_const.launches = 0
    block_write.launches = 0
    torch.cuda.reset_peak_memory_stats()
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=bias, specific_time=2.0,
                                  pruning=True)
    launches = {"nn_const": nn_const.launches,
                "block_write": block_write.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    st = planner.stats
    log(f"main path replan 2.0 s [{smi}]: goal={reached} "
        f"expansions_per_s={st['expansions_per_s']:.1f} "
        f"rounds={st['rounds']} restarts={st['restarts']} "
        f"elapsed_s={st['elapsed_s']:.4f} "
        f"plan_duration_s={st['plan_duration_s']:.2f} "
        f"nodes={st['nodes']} peak_mem_GiB={peak:.2f} launches={launches}")
    if not reached:
        raise AssertionError(f"goal not reached: {st}")
    check_plan(prob, planner)
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched: {launches}")
    log("main path plan checks: starts at x0, feasible, ends in goal box, "
        "dynamically consistent")

    reached1 = planner.update_plan(prob["x0"], prob["sample_space"],
                                   goal_bias=bias, specific_time=1.0,
                                   pruning=True)
    st = planner.stats
    log(f"main path replan 1.0 s [{smi}]: goal={reached1} "
        f"expansions_per_s={st['expansions_per_s']:.1f} "
        f"rounds={st['rounds']} restarts={st['restarts']} "
        f"elapsed_s={st['elapsed_s']:.4f} "
        f"plan_duration_s={st['plan_duration_s']:.2f}")

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
    log(f"sync-free chunk ({n_cycles}x{F} rounds) under sync_debug_mode="
        f"'error': ok, enqueue_s={enqueue:.3f} total_s={total:.3f}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from lqrrt_tpu_torch.models import boat
    from lqrrt_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"build: {_build.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s")
    a = phase_kernel_a()
    b = phase_kernel_b()
    prob = boat.default_problem()
    phase_round_parity(prob)
    launches = phase_main_path(prob, smi)
    kernels = [
        dict(name="nn_const", route="cuda",
             source="lqrrt_tpu_torch/csrc/nn_const.cu",
             replaces="lqrrt_tpu/ops/pallas/nn_kernel.py:415",
             launches=launches["nn_const"],
             max_abs_err=a[32768]["max_abs_err"],
             ms=a[32768]["ms"], plain_ms=a[32768]["plain_ms"]),
        dict(name="block_write", route="cuda",
             source="lqrrt_tpu_torch/csrc/block_write.cu",
             replaces="lqrrt_tpu/ops/pallas/write_kernel.py:26",
             launches=launches["block_write"], max_abs_err=b["max_abs_err"],
             ms=b["ms"], plain_ms=b["plain_ms"]),
    ]
    log(smi_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
