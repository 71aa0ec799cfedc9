"""The six debug stages of the rollout scaffold (port of
tools/dbg_steer_kernel.py, its stages :98-144).

    python -m lqrrt_tpu_torch.tools.dbg_steer_kernel [--device cuda]

The tool bisected which body feature Mosaic rejected, printing
"<stage>: OK" or "<stage>: FAILED ...".  Here OK means that the stage's
kernel (``steer_stages.run_stage``) was built, launched and equal to its
plain version, bit for bit, on two inputs of x0 and xtar (6, B), K
(3, 6, B), B = 1024, H = 100: the tool's, all ones (where the error is 0
at every step, so that the matvec adds 0 and full never leaves x0), and
``branch_inputs``, on which full takes each of its branches.  Stages:
identity, erf, matvec, dynamics, feasibility, full.  ``main`` returns the
count of stages that failed.  The device is explicit: ``device="cuda"`` needs a card; on the
CPU the wrapper takes the plain version (for tests).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models import boat
from ..ops.kernels import steer_stages
from ..ops.kernels.steer_stages import F3, plain, run_stage
from .exp_steer_kernel import boat_K, branch_batch


def same(a, b) -> bool:
    """Equal shapes and values, NaN equal to NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    eq = a == b
    if a.is_floating_point():
        eq = eq | (a.isnan() & b.isnan())
    return bool(eq.all())


def branch_inputs(B: int, seed: int, dev):
    """(x0T (6, B), KT (3, 6, B), tarT (6, B)) float32 on ``dev``: the
    start and target of ``exp_steer_kernel.branch_batch`` (goal-box,
    buoy, near and wrap groups among uniform ones) and the boat's K, so
    that over H steps full reaches the goal box, stops at the buoy and
    arrives at once (length 0)."""
    x0, xtar, _ = branch_batch(B, seed, boat.default_problem())
    K = np.broadcast_to(boat_K(boat.default_problem())[..., None],
                        (3, 6, B))
    return [torch.as_tensor(np.ascontiguousarray(a, np.float32), device=dev)
            for a in (x0.T, K, xtar.T)]


def main(device: str = "cuda", B: int = 1024) -> int:
    """Run the six stages; print one line each, return the failures."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dbg_steer_kernel: device='cuda' needs a CUDA "
                           "card")
    inputs = {"ones": [torch.ones(s, device=dev)
                       for s in ((6, B), (3, 6, B), (6, B))],
              "branches": branch_inputs(B, 0, dev)}
    failures = 0
    for stage in F3:
        label = stage[len("dbg_"):]
        try:
            before = steer_stages.LAUNCHES[stage]
            bad = []
            for what, args in inputs.items():
                xs, length = run_stage(stage)(*args)
                ref, _, ref_len = plain(stage, *args)
                if not (same(xs, ref) and same(length, ref_len)):
                    bad.append(f"{what}: max|dx|="
                               f"{(xs - ref).abs().max().item():.3e} "
                               f"len_eq={same(length, ref_len)}")
            launched = dev.type == "cpu" or \
                steer_stages.LAUNCHES[stage] > before
            if launched and not bad:
                print(f"{label}: OK", flush=True)
                continue
            print(f"{label}: FAILED launched={launched} {'; '.join(bad)}",
                  flush=True)
        except Exception as e:          # the tool's report: name the error
            print(f"{label}: FAILED {type(e).__name__}: {str(e)[:200]}",
                  flush=True)
        failures += 1
    return failures


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    sys.exit(main(ap.parse_args().device))


if __name__ == "__main__":
    _cli()
