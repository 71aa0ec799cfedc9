"""Where kernel D's time goes: the stage scaffold with richer and richer step
bodies (port of tools/exp_steer_stages_v5.py: its ``__main__`` :205-212 and
its ``STAGE2`` block :278-284).

    python -m lqrrt_tpu_torch.tools.exp_steer_stages [--device cuda]
        [--B 8192] [--seed 0]

The tool's data, from a seeded numpy generator: x0 ~ N(0, 1) (6, B), K ~
0.1 N(0, 1) (3, 6, B), xtar ~ 5 N(0, 1) (6, B), H = 100.  For each of the
twelve configurations (``steer_stages.F2``: identity, identity_nostore,
erf, matvec, saturate, dynamics, full, then sin_whole, sincos8_row,
rk4_lin_rows, euler_full, rk4_trig_rows) it times ``steer_stages.build``
(median of ``REPS`` calls after a warm-up) and prints the kernel's time
and its difference from the configuration before.  Then kernel D's flat
rollout (``make_steer_kernel``, the boat problem) on the same x0, K and
xtar, for reference.  Both launch in D's geometry
(``steer_kernel.rollout_geometry``, from B and the SM count; D ignores
its ``block``), which the first line prints on the card.  The tool
chained its calls through the state; each call here is timed alone.
Clocks: on the card, CUDA events around the kernel alone (``device_ms``:
the stream spins while the host dispatches the call) and, beside it,
around the call with its dispatch (``timed_ms``, "wall"); on the CPU the
host clock for both (for tests, at a small size).  The device is explicit:
``device="cuda"`` needs a card.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import boat
from ..ops.kernels.nn_kernel import sm_count
from ..ops.kernels.steer_kernel import make_steer_kernel, rollout_geometry
from ..ops.kernels.steer_stages import F2, H, build
from .exp_steer_kernel import device_ms, steer_args, timed_ms

REPS = 20


def stage_inputs(B: int, seed: int, dev):
    """The tool's bench data (x0T (6, B), KT (3, 6, B), tarT (6, B)) from a
    seeded numpy generator, float32 on ``dev``."""
    rng = np.random.default_rng(seed)
    x0T = rng.standard_normal((6, B))
    KT = rng.standard_normal((3, 6, B)) * 0.1
    tarT = rng.standard_normal((6, B)) * 5.0
    return [torch.as_tensor(a.astype(np.float32), device=dev)
            for a in (x0T, KT, tarT)]


def main(device: str = "cuda", B: int = 8192, seed: int = 0) -> dict:
    """Run the experiment; print its lines and return its numbers."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_steer_stages: device='cuda' needs a CUDA "
                           "card")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    x0T, KT, tarT = stage_inputs(B, seed, dev)
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    geometry = (rollout_geometry(B, sm_count(dev)) if dev.type == "cuda"
                else None)
    print(f"exp_steer_stages on {name}: B={B} H={H} seed={seed} "
          f"(threads, blocks)={geometry} ({clock}, median of {REPS})",
          flush=True)

    def times(fn):
        wall = timed_ms(fn, dev, REPS)
        return (device_ms(fn, REPS) if dev.type == "cuda" else wall), wall

    out = dict(device=name, B=B, H=H, geometry=geometry, stages={})
    prev = None
    for stage in F2:
        steer = build(stage)
        ms, wall = times(lambda: steer(x0T, KT, tarT))
        d = None if prev is None else ms - prev
        out["stages"][stage] = dict(ms=ms, d_ms=d, wall_ms=wall)
        print(f"{stage:18s}: {ms:9.4f} ms"
              + ("" if d is None else f"  ({d:+9.4f} ms on the stage "
                                      "before)")
              + f"  wall {wall:9.4f} ms", flush=True)
        prev = ms
    prob = boat.default_problem()
    args, kw = steer_args(prob)
    D = make_steer_kernel(*args, **kw)
    x0, xtar = x0T.T.contiguous(), tarT.T.contiguous()
    K = KT.permute(2, 0, 1).contiguous()
    goal = torch.as_tensor(prob["goal"], device=dev)
    ms, wall = times(lambda: D(x0, K, xtar, goal))
    out.update(steer_rollout_ms=ms, steer_rollout_wall_ms=wall)
    print(f"kernel D steer_rollout (flat, the boat problem, same x0, K, "
          f"xtar): {ms:9.4f} ms  wall {wall:9.4f} ms", flush=True)
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
