"""Kernel D's experiment: the fused steer rollout against the plain steer at
the boat's operating point (port of tools/exp_steer_kernel.py ``main``, with
the gathered cell ``k_gathered`` of tools/exp_steer_v5.py:144-162).

    python -m lqrrt_tpu_torch.tools.exp_steer_kernel [--device cuda]
        [--B 8192] [--N 40960] [--seed 0] [--model boat]

Inputs, from a seeded numpy generator: ``boat.default_problem()``, H = 100
steps of dt = 0.05, error_tol 0.05, the goal box and ``saturate``; x0
uniform in [-1, 1], the boat's constant K tiled, xtar uniform in the sample
space.  It times the plain steer (``core.steer.make_steer``, the tool's
"scan" line), then the kernel (``make_steer_kernel``) at each block size of
``BLOCKS``, the sweep that takes the place of the tool's batch-tile sweep
(the kernel picks its own launch geometry, so every block size times the
same launch), and prints each one's ``len_eq`` (the share of candidates whose lengths
agree with the plain steer's) and max|dx| (over those candidates).  The
tool's ``unroll`` sweep is dropped: it probed Mosaic's ``fori_loop``, which
takes only a rolled or a fully unrolled loop; nvcc unrolls the kernel's
fixed inner loops and keeps the H loop.  The gathered cell draws B parents
from an N-row tree buffer (rows uniform in [-1, 1], as x0) and times the
tree kernel (``make_steer_kernel_tree``) against the plain index gather
plus steer.  Clocks: CUDA events on the card, the host clock on the CPU
(for tests, at a small size).  The device is explicit: ``device="cuda"``
needs a card.

``--model car``, ``quadrotor`` or ``double_integrator`` runs the same
cells on that model's ``default_problem()`` at its own horizon
(``kernel_times.model_steer_inputs``: x0 and xtar from a seeded
``torch.Generator`` in the sample space, K from the model's ``lqr``).

``branch_batch`` and ``branch_counts`` build and read a batch that reaches
every branch of the step; the tests and ``chip_smoke.py`` use them.
"""
from __future__ import annotations

import argparse
import math
import statistics
import time

import numpy as np
import torch

from ..core.steer import make_steer
from ..models import boat
from ..ops.kernels.steer_kernel import (make_steer_kernel,
                                        make_steer_kernel_tree)

H, DT, TOL = 100, 0.05, 0.05
MODELS = ("boat", "car", "quadrotor", "double_integrator")
BLOCKS = (32, 64, 128, 256)            # threads (candidates) a block
REPS, PLAIN_REPS = 20, 3               # timed calls: kernel, plain steer
GROUPS = ("uniform", "goal", "buoy", "near", "wrap", "far")


def steer_args(prob):
    """make_steer's arguments for the boat at the tool's operating point."""
    return ((prob["dynamics"], prob["erf"], prob["constraints"].is_feasible,
             H, DT, TOL),
            dict(saturate=prob["saturate"],
                 goal_buffer=prob["constraints"].goal_buffer))


def boat_K(prob) -> np.ndarray:
    """The boat's constant LQR gain (3, 6)."""
    return prob["lqr"](torch.zeros(6), torch.zeros(3))[1].numpy()


def branch_batch(B: int, seed: int, prob=None):
    """(x0, xtar) (B, 6) float32 and group (B,): candidate b is in group
    ``GROUPS[b % 6]``, so that every branch of the step is reached:

    - uniform: x0 in [-1, 1], xtar uniform in the sample space;
    - goal: x0 at rest 2-6 m short of the goal, xtar inside the goal box
      (the first-entry goal stop);
    - buoy: x0 and xtar 5-7 m either side of the first buoy (the infeasible
      stop);
    - near: xtar 0.02 from x0, inside the 0.05 tolerance (length 0);
    - wrap: psi of x0 and of xtar within 0.25 of +pi and -pi, on opposite
      sides (the erf's wrap);
    - far: xtar 25-40 m from x0 (saturated efforts)."""
    prob = boat.default_problem() if prob is None else prob
    ss, goal = prob["sample_space"], prob["goal"]
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, (B, 6))
    xtar = ss[:, 0] + rng.random((B, 6)) * (ss[:, 1] - ss[:, 0])
    group = np.arange(B) % len(GROUPS)

    def rows(name):
        s = group == GROUPS.index(name)
        return s, int(s.sum())

    def u(lo, hi, k):
        return rng.uniform(lo, hi, k)

    s, k = rows("goal")
    z = np.zeros(k)
    x0[s] = goal + np.column_stack([u(-6, -2, k), u(-1, 1, k),
                                    u(-0.3, 0.3, k), z, z, z])
    xtar[s] = goal + np.column_stack([u(-0.5, 0.5, k), u(-0.5, 0.5, k),
                                      z, z, z, z])
    s, k = rows("buoy")
    z = np.zeros(k)
    (cx, cy) = prob["obstacles"][0][0]
    x0[s] = np.column_stack([cx - u(5, 7, k), cy + u(-1, 1, k),
                             u(-0.2, 0.2, k), z, z, z])
    xtar[s] = np.column_stack([cx + u(5, 7, k), cy + u(-1, 1, k), z, z, z,
                               z])
    s, k = rows("near")
    d = rng.normal(size=(k, 6))
    xtar[s] = x0[s] + 0.02 * d / np.linalg.norm(d, axis=1, keepdims=True)
    s, k = rows("wrap")
    side = rng.choice([-1.0, 1.0], k)
    x0[s, 2] = side * (math.pi - u(0, 0.25, k))
    xtar[s] = x0[s]
    xtar[s, :2] += rng.uniform(-3, 3, (k, 2))
    xtar[s, 2] = -side * (math.pi - u(0, 0.25, k))
    s, k = rows("far")
    ang, dist = u(0, 2 * math.pi, k), u(25, 40, k)
    xtar[s, :2] = x0[s, :2] + dist[:, None] * np.column_stack(
        [np.cos(ang), np.sin(ang)])
    return x0.astype(np.float32), xtar.astype(np.float32), group


def branch_counts(res, x0, xtar) -> dict:
    """How many candidates took each branch, from a SteerResult and its
    numpy inputs.  A rollout that stops early (length < H) and is not in
    the goal stopped on the converged test if it reached the target (the
    same test on the same final state), else on the circles."""
    Hs = res.x_seq.shape[0]
    length = res.length.cpu().numpy()
    reached = res.reached.cpu().numpy()
    in_goal = res.in_goal.cpu().numpy()
    stopped = length < Hs
    u0 = res.u_seq[0].T.cpu().numpy()
    dpsi = xtar[:, 2].astype(np.float64) - x0[:, 2]
    return {"goal stop": int(in_goal.sum()),
            "arrived stop": int((~in_goal & reached & stopped).sum()),
            "infeasible stop": int((~in_goal & ~reached & stopped).sum()),
            "full horizon": int((~in_goal & ~stopped).sum()),
            "length 0": int((length == 0).sum()),
            "psi wrapped": int((np.abs(dpsi) > math.pi).sum()),
            "saturated": int((np.abs(u0) >= boat.WRENCH_MAX).any(1).sum())}


def agreement(res, ref) -> dict:
    """res against ref: the shares of candidates whose length, in_goal and
    reached agree, and max |dx|, |du| and |dxnew| over the candidates whose
    lengths agree."""
    same = res.length == ref.length

    def dmax(a, b):
        d = (a - b).abs()
        return float(d.max()) if d.numel() else 0.0

    return dict(
        len_eq=same.double().mean().item(),
        in_goal_eq=(res.in_goal == ref.in_goal).double().mean().item(),
        reached_eq=(res.reached == ref.reached).double().mean().item(),
        max_dx=dmax(res.x_seq[:, :, same], ref.x_seq[:, :, same]),
        max_du=dmax(res.u_seq[:, :, same], ref.u_seq[:, :, same]),
        max_dxnew=dmax(res.xnew[same], ref.xnew[same]))


def timed_ms(fn, dev, reps: int) -> float:
    """Median ms of ``fn`` over ``reps`` calls after a warm-up (on CUDA,
    the build): CUDA events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


SPIN_CYCLES = 2_000_000    # ~1 ms of the card's clock: longer than a call's
                           # dispatch on the host


def device_ms(fn, reps: int, before=None) -> float:
    """Median device ms of one call of ``fn`` (CUDA) over ``reps`` calls
    after a warm-up, without the host's dispatch: before each call the
    stream spins (``torch.cuda._sleep``) while the host enqueues the call
    between two CUDA events, so that the events time only the call's
    kernels.  ``timed_ms`` on the card times the dispatch too.  ``before``,
    if given, is enqueued ahead of each spin, outside the timed events (an
    L2 flush, for a cold cache).

    Each call checks that the spin outlasted the host's enqueueing: the
    device time from the spin's start to the start event must exceed the
    host time from before the spin to after the end event (the device
    cannot start the spin before the host enqueues it).  Where it does
    not, host time could leak into the events, and the call is repeated
    with a spin twice as long; after 6 doublings it raises."""
    fn()
    times, cycles = [], SPIN_CYCLES
    while len(times) < reps:
        if before is not None:
            before()
        torch.cuda.synchronize()
        spin, start, end = (torch.cuda.Event(enable_timing=True)
                            for _ in range(3))
        t0 = time.perf_counter()
        spin.record()
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if spin.elapsed_time(start) > host_ms:
            times.append(start.elapsed_time(end))
        elif cycles < SPIN_CYCLES << 6:
            cycles *= 2
        else:
            raise RuntimeError(
                f"device_ms: the stream's spin ({spin.elapsed_time(start):.3f}"
                f" ms) ended before the host enqueued the call "
                f"({host_ms:.3f} ms)")
    return statistics.median(times)


def _boat_inputs(dev, B, N, seed):
    """The boat's cells: x0 uniform in [-1, 1], xtar in the sample space,
    the constant K, N tree rows in [-1, 1] and B random parents."""
    prob = boat.default_problem()
    args, kw = steer_args(prob)
    ss = prob["sample_space"]
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, (B, 6)).astype(np.float32)
    xtar = (ss[:, 0] + rng.random((B, 6)) * (ss[:, 1] - ss[:, 0])).astype(
        np.float32)
    states = rng.uniform(-1.0, 1.0, (N, 6)).astype(np.float32)
    pids = rng.integers(0, N, B).astype(np.int32)

    def t(a):
        return torch.as_tensor(a, device=dev)

    K = t(boat_K(prob))
    return dict(args=args, kw=kw, x0=t(x0), xtar=t(xtar), states=t(states),
                pids=t(pids), KB=K.expand(B, 3, 6).contiguous(),
                KN=K.expand(N, 3, 6).contiguous(), goal=t(prob["goal"]))


def main(device: str = "cuda", B: int = 8192, N: int = 40960,
         seed: int = 0, model: str = "boat") -> dict:
    """Run the experiment; print its lines and return its numbers."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_steer_kernel: device='cuda' needs a CUDA card")
    if model not in MODELS:
        raise ValueError(f"exp_steer_kernel: unknown model {model!r}")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if model == "boat":
        c = _boat_inputs(dev, B, N, seed)
    else:
        import importlib

        from .kernel_times import model_steer_inputs

        mod = importlib.import_module(f"..models.{model}", __package__)
        c = model_steer_inputs(mod.default_problem(), dev, B, seed, N)
    args, kw = c["args"], c["kw"]
    x0, xtar, states, pids, goal = (c["x0"], c["xtar"], c["states"],
                                    c["pids"], c["goal"])
    Kb, KN = c["KB"], c["KN"]
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"exp_steer_kernel [{model}] on {name}: B={B} N={N} H={args[3]} "
          f"seed={seed} ({clock})", flush=True)

    plain = make_steer(*args, **kw)
    ref = plain(x0, Kb, xtar, goal)
    plain_ms = timed_ms(lambda: plain(x0, Kb, xtar, goal), dev, PLAIN_REPS)
    print(f"plain steer (core.steer, the tool's scan line): "
          f"{plain_ms:9.3f} ms", flush=True)
    out = dict(device=name, model=model, B=B, N=N, H=args[3],
               plain_ms=plain_ms, kernel={})
    for block in BLOCKS:
        steer = make_steer_kernel(*args, block=block, **kw)
        ms = timed_ms(lambda: steer(x0, Kb, xtar, goal), dev, REPS)
        a = agreement(steer(x0, Kb, xtar, goal), ref)
        out["kernel"][block] = dict(ms=ms, **a)
        print(f"kernel block={block:4d}: {ms:9.4f} ms "
              f"({plain_ms / ms:7.1f}x)  len_eq {a['len_eq']:.4f}  "
              f"max|dx| {a['max_dx']:.2e}", flush=True)

    # the gathered cell: parents from the tree buffer (the round's pattern)
    tree = make_steer_kernel_tree(*args, **kw)
    idx = pids.long()

    def plain_tree():
        return plain(states[idx], KN[idx], xtar, goal)

    ref_t = plain_tree()
    tree_plain_ms = timed_ms(plain_tree, dev, PLAIN_REPS)
    tree_ms = timed_ms(lambda: tree(states, KN, pids, xtar, goal), dev, REPS)
    a = agreement(tree(states, KN, pids, xtar, goal), ref_t)
    out["tree"] = dict(ms=tree_ms, plain_ms=tree_plain_ms, **a)
    print(f"tree kernel (parents of {N} rows): {tree_ms:9.4f} ms, plain "
          f"gather + steer {tree_plain_ms:9.3f} ms "
          f"({tree_plain_ms / tree_ms:7.1f}x)  len_eq {a['len_eq']:.4f}  "
          f"max|dx| {a['max_dx']:.2e}", flush=True)
    return out


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--B", type=int, default=8192)
    ap.add_argument("--N", type=int, default=40960)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", default="boat", choices=MODELS)
    a = ap.parse_args()
    main(a.device, a.B, a.N, a.seed, a.model)


if __name__ == "__main__":
    _cli()
