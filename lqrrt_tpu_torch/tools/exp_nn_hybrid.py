"""Kernel E's experiment: the expanded-form constant-metric NN variants
against the exact scan and kernel A, at boat scale (port of
tools/exp_nn_hybrid_v5.py ``main``).

    python -m lqrrt_tpu_torch.tools.exp_nn_hybrid [--device cuda] [--N 40960]
        [--B 8192] [--size 32768] [--seed 0]

States and candidates are uniform in ``boat.default_problem()``'s sample
space (a seeded numpy generator), under the boat's constant S, with psi
(dim 2) wrapped.  For each variant -- exp, hybrid at "highest", "high" and
"default", split3 -- it prints the id match against the exact blocked scan
(``core.nearest.make_nearest`` with the boat's erf) and the max and mean
excess of its picks' costs over the scan's, both rescored in fp64, and
that excess as a share of its mode's bound (``nn_hybrid.ERROR``).  Then
it times kernel A (``nn_const``) and each variant in the tool's chained
loop: ``REPS`` = 16 calls a chain, each feeding ``xr + 1e-7 * cost`` to
the next, ``OUTER`` = 12 chains, on CUDA events (the host clock on the
CPU, which is for tests at a small size).  The device is explicit:
``device="cuda"`` needs a card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core.nearest import make_nearest
from ..models import boat
from ..ops.kernels.nn_hybrid import (ERROR, error_scale, expand_prep,
                                     nn_exp, nn_hybrid, nn_split3)
from ..ops.kernels.nn_kernel import nn_const
from ..utils.device import card_name

WRAP = 2                               # psi
REPS, OUTER = 16, 12                   # the tool's chain: calls, chains

# (label, function, kwargs, the cross term's mode); kernel A's direct form
# is held to the fp32 bound
KERNEL_A = ("kernel A nn_const", nn_const, {}, "fma")
VARIANTS = (
    ("exp", nn_exp, {}, "fma"),
    ("hybrid[highest]", nn_hybrid, {"prec": "highest"}, "fma"),
    ("hybrid[high]", nn_hybrid, {"prec": "high"}, "bf16x3"),
    ("hybrid[default]", nn_hybrid, {"prec": "default"}, "bf16"),
    ("split3", nn_split3, {}, "bf16x3"),
)


def problem(device, N: int, B: int, size: int, seed: int):
    """(states (N, 6), S (N, 6, 6), size int32, xrand (B, 6)) at boat
    scale on ``device``."""
    prob = boat.default_problem()
    lo, hi = prob["sample_space"][:, 0], prob["sample_space"][:, 1]
    rng = np.random.default_rng(seed)
    states = (lo + rng.random((N, 6)) * (hi - lo)).astype(np.float32)
    xrand = (lo + rng.random((B, 6)) * (hi - lo)).astype(np.float32)
    states = torch.as_tensor(states, device=device)
    S0, _ = prob["lqr"](states[0], torch.zeros(3, device=device))
    return (states, S0.expand(N, 6, 6),
            torch.tensor(size, dtype=torch.int32, device=device),
            torch.as_tensor(xrand, device=device))


def cost64(states, S, xrand, ids):
    """The boat metric of each candidate's pick, rescored in fp64."""
    e = boat.erf(xrand.double(), states[ids.long()].double())
    return torch.einsum("bi,ij,bj->b", e, S[0].double(), e)


def chained_ms(fn, states, S, size, xrand) -> float:
    """ms a call of ``fn`` in the tool's chained loop: ``OUTER`` chains of
    ``REPS`` calls, each fed ``xr + 1e-7 * cost`` of the one before."""
    def chain(i):
        xr = xrand + 1e-9 * i
        for _ in range(REPS):
            _, cost = fn(states, S, size, xr)
            xr = xr + 1e-7 * cost[:, None]
        return xr

    cuda = states.device.type == "cuda"
    chain(0)                           # warm-up (and, on CUDA, the build)
    if cuda:
        torch.cuda.synchronize(states.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    for i in range(OUTER):
        chain(i + 1)
    if cuda:
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (OUTER * REPS)
    return (time.perf_counter() - t0) * 1e3 / (OUTER * REPS)


def main(device: str = "cuda", N: int = 40960, B: int = 8192,
         size: int = 32768, seed: int = 0) -> dict:
    """Run the experiment; print its lines and return its numbers."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("exp_nn_hybrid: device='cuda' needs a CUDA card")
    name = card_name(dev)
    states, S, sz, xrand = problem(dev, N, B, size, seed)
    print(f"exp_nn_hybrid on {name}: N={N} B={B} size={size} seed={seed}",
          flush=True)

    ids_ref, _ = make_nearest(boat.erf, block=2048)(states, S, sz, xrand)
    c_ref = cost64(states, S, xrand, ids_ref)
    M = error_scale(expand_prep(states, S, xrand, WRAP), sz).double()
    checks = {}
    for label, fn, kw, mode in (KERNEL_A,) + VARIANTS:
        ids, _ = fn(states, S, sz, xrand, wrap_dim=WRAP, **kw)
        excess = (cost64(states, S, xrand, ids) - c_ref).clamp(min=0.0)
        checks[label] = dict(
            id_match=(ids == ids_ref).double().mean().item(),
            max_excess=excess.max().item(), mean_excess=excess.mean().item(),
            # 1 at the most a pick of this mode may exceed the nearest
            excess_over_bound=(excess / (2 * ERROR[mode] * M)).max().item(),
            live=bool((ids < size).all().item()))
        c = checks[label]
        print(f"{label:17s} vs exact scan: id_match {c['id_match']:.4f}  "
              f"max_excess {c['max_excess']:.3e}  "
              f"mean_excess {c['mean_excess']:.3e}  "
              f"excess/bound {c['excess_over_bound']:.3e}", flush=True)

    timing = {}
    for label, fn, kw, _ in (KERNEL_A,) + VARIANTS:
        timing[label] = chained_ms(
            lambda st, S_, s, xr, fn=fn, kw=kw: fn(st, S_, s, xr,
                                                    wrap_dim=WRAP, **kw),
            states, S, sz, xrand)
        print(f"{label:17s}: {timing[label]:8.4f} ms/call "
              f"({'CUDA events' if dev.type == 'cuda' else 'host clock'})",
              flush=True)
    return dict(device=name, N=N, B=B, size=size, checks=checks,
                ms_per_call=timing)


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--N", type=int, default=40960)
    ap.add_argument("--B", type=int, default=8192)
    ap.add_argument("--size", type=int, default=32768)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    main(a.device, a.N, a.B, a.size, a.seed)


if __name__ == "__main__":
    _cli()
