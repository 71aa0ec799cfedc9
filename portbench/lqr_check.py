"""The per-node LQR check of a configuration whose planner re-linearises
its LQR at every node (the car): one planner at the cell's own width, a
warm-up and replans of the cell's own load for ``--seconds``, then the
tree of the last replan (``Planner._device_tree``, the timed path's own
tree) read row by row, state, S and K, and each row's (S, K) compared
with the plain reference's ``lqr`` at its state, in float64, in blocks;
the same comparison with the reference computed in bfloat16 is the
control, which must fail the configuration's ``lqr_check`` limit.

    python -m portbench.lqr_check --workload car.replan \\
        --seeds 11,12 --seconds 6

Prints one JSON line a seed: the rows compared, the largest and median
relative error of S and of K (the Frobenius norm of a row's difference
over the reference's), for the program and for the control, and whether
each passes the limit.  The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import numpy as np

from .run import _cache_env

BLOCK = 4096     # rows a block of the reference's solve


def rel_errors(got, ref) -> np.ndarray:
    """(N,) the Frobenius norm of each row's got - ref over ref's, in
    float64 (not finite where either is not)."""
    got = np.asarray(got, np.float64).reshape(len(got), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    return (np.linalg.norm(got - ref, axis=1)
            / np.linalg.norm(ref, axis=1))


def compare(model, x, S=None, K=None, dtype=None, block: int = BLOCK
            ) -> dict:
    """{S_max, S_med, K_max, K_med}: against ``model.lqr`` in float64 at
    states x (N, n), on x's device, block by block, either the program's
    S (N, n, n) and K (N, m, n), or (without them) ``model.lqr`` computed
    in ``dtype``, the control.  An error that is not finite counts as the
    largest."""
    import torch

    x = torch.as_tensor(x)
    es, ek = [], []
    for i in range(0, len(x), block):
        xb = x[i:i + block].to(torch.float64)
        Sr, Kr = model.lqr(xb)
        if S is None:
            Sg, Kg = model.lqr(xb.to(dtype))
        else:
            Sg, Kg = S[i:i + block], K[i:i + block]
        for e, got, ref in ((es, Sg, Sr), (ek, Kg, Kr)):
            e.append(rel_errors(torch.as_tensor(got).cpu().double(),
                                ref.cpu()))
    es, ek = np.concatenate(es), np.concatenate(ek)

    def worst(e):
        return float(e.max()) if np.isfinite(e).all() else float("inf")
    return {"S_max": worst(es), "S_med": float(np.median(es)),
            "K_max": worst(ek), "K_med": float(np.median(ek))}


def check(cfg: dict, mix: dict, seed: int, seconds: float,
          device="cuda") -> dict:
    """One planner of the configuration, its replans for ``seconds``, and
    the comparison of its last tree (see the module docstring)."""
    import time

    import torch

    from lqrrt_tpu_torch import Planner

    from .loops import _problem
    from .reference.plans import load_model
    from .traffic import GoalStream

    model = load_model(cfg)
    prob = _problem(cfg, mix)
    pc = cfg["planner"]
    planner = Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=cfg["horizon"], dt=cfg["dt"], FPR=pc["FPR"],
        error_tol=cfg["error_tol"], erf=prob["erf"],
        min_time=mix["min_time"], max_time=mix["max_time"],
        goal0=np.asarray(cfg["goal"], np.float32), printing=False,
        batch_size=pc["batch_size"], capacity=pc["capacity"],
        wrap_dims=tuple(cfg["wrap_dims"]), seed=seed,
        saturate=prob["saturate"], rounds_per_chunk=pc["rounds_per_chunk"],
        refine_mode=pc["refine_mode"], device=device)
    x0 = np.asarray(cfg["x0"], np.float32)
    ss = np.asarray(cfg["sample_space"], np.float32)
    gb = np.asarray(cfg["goal_bias"], np.float32)
    goals = GoalStream(cfg, mix, seed)
    planner.warmup(x0, ss, goal_bias=gb, pruning=bool(mix["pruning"]))
    t0, replans = time.perf_counter(), 0
    while not replans or time.perf_counter() - t0 < seconds:
        planner.set_goal(goals.next_goal())
        planner.update_plan(x0, ss, goal_bias=gb,
                            pruning=bool(mix["pruning"]))
        replans += 1
    tree = planner._device_tree
    size = int(tree.size)
    x = tree.state[:size].detach()
    S, K = (t[:size].detach().cpu() for t in (tree.S, tree.K))
    out = {"seed": seed, "replans": replans, "rows": size,
           "nn_selected": planner.nn_selected,
           "steer_selected": planner.steer_selected}
    del planner, tree
    gc.collect()
    limit = cfg["lqr_check"]["rel_max"]
    for name, r in (("program", compare(model, x, S, K)),
                    ("control", compare(model, x, dtype=torch.bfloat16))):
        r["passes"] = bool(r["S_max"] <= limit and r["K_max"] <= limit)
        out[name] = r
    return out


def main(argv=None) -> int:
    _cache_env()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    from . import cells
    w = cells.workload(cells.load_manifest(), args.workload)
    cfg = cells.config(w["config"])
    mix = cells.traffic(w["traffic"])
    if "lqr_check" not in cfg:
        print(f"{cfg['name']} has no lqr_check limit", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(check(cfg, mix, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
