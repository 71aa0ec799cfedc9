"""Kernel D under F1's factory: the double-vmap rollout's bench (port of
tools/exp_steer_dv_v5.py, its bench :208-241).

    python -m lqrrt_tpu_torch.tools.exp_steer_dv [--device cuda] [--B 8192]
        [--seed 0]

``boat.default_problem()`` at H = 100, dt 0.05, error_tol 0.05, the goal
box and ``saturate``; x0 the problem's x0 tiled over B candidates, the
boat's constant K tiled, xtar ~ 5 N(0, 1) from a seeded numpy generator.
For each ``batch_tile`` of the tool's sweep (512, 1024) it builds
``make_steer_kernel_dv`` (the kernel picks its own launch geometry, so both
tiles time the same launch), prints the first call's agreement with the plain
steer (``core.steer.make_steer``), then times the tool's chained call (x0
<- the result's xnew, xtar <- xtar + 1e-6) over ``REPS`` calls after one
warm-up, as ms a call, and on the card the kernel alone (``device_ms``,
median of ``DEVICE_REPS``).  Clocks: CUDA events on the card, the host
clock on the CPU (for tests, at a small size).  The device is explicit:
``device="cuda"`` needs a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.steer import make_steer
from ..models import boat
from ..ops.kernels.steer_kernel import make_steer_kernel_dv
from .exp_steer_kernel import (H, agreement, boat_K, device_ms,
                               steer_args)

BATCH_TILES = (512, 1024)
REPS = 100                 # chained calls timed (the tool's ``outer``)
DEVICE_REPS = 20           # single calls timed on the card


def chained_ms(steer, x0, K, xtar, goal, dev, reps: int) -> float:
    """ms a call of the tool's chain: x0 <- xnew, xtar <- xtar + 1e-6,
    after one warm-up call."""
    def call(state):
        x, tar = state
        return steer(x, K, tar, goal).xnew, tar + 1e-6

    state = call((x0, xtar))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            state = call(state)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        state = call(state)
    return (time.perf_counter() - t0) * 1e3 / reps


def main(device: str = "cuda", B: int = 8192, seed: int = 0) -> dict:
    """Run the bench; print its lines and return its numbers."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_steer_dv: device='cuda' needs a CUDA card")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    prob = boat.default_problem()
    args, kw = steer_args(prob)
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(np.tile(prob["x0"], (B, 1)), device=dev)
    K = torch.as_tensor(boat_K(prob), device=dev).expand(B, 3, 6).contiguous()
    xtar = torch.as_tensor(
        (rng.standard_normal((B, 6)) * 5.0).astype(np.float32), device=dev)
    goal = torch.as_tensor(prob["goal"], device=dev)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"exp_steer_dv on {name}: B={B} H={H} seed={seed} ({clock}, "
          f"{REPS} chained calls)", flush=True)
    ref = make_steer(*args, **kw)(x0, K, xtar, goal)
    out = dict(device=name, B=B, H=H, kernel={})
    for bt in BATCH_TILES:
        steer = make_steer_kernel_dv(*args, batch_tile=bt, **kw)
        a = agreement(steer(x0, K, xtar, goal), ref)
        ms = chained_ms(steer, x0, K, xtar, goal, dev, REPS)
        dms = (device_ms(lambda: steer(x0, K, xtar, goal), DEVICE_REPS)
               if dev.type == "cuda" else None)
        out["kernel"][bt] = dict(ms=ms, device_ms=dms, **a)
        print(f"dv kernel Bt={bt:<5d}: {ms:8.4f} ms chained"
              + ("" if dms is None else f", {dms:8.4f} ms alone")
              + f"  first call vs plain steer: len_eq {a['len_eq']:.4f} "
              f"in_goal_eq "
              f"{a['in_goal_eq']:.4f} reached_eq {a['reached_eq']:.4f} "
              f"max|dx| {a['max_dx']:.2e} max|du| {a['max_du']:.2e}",
              flush=True)
    return out


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--B", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    main(a.device, a.B, a.seed)


if __name__ == "__main__":
    _cli()
