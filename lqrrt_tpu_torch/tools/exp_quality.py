"""Anytime quality curve: plan duration against budget (port of
tools/exp_quality_r5.py).

Plan duration at budgets 0.2 / 0.5 / 1 / 2 / 4 s over six fixed seeds a
budget, pruning on (the plan a user gets), on two instances, each a
planner with ``informed=0.5``, capacity 32768, warmed up once:

* ``boat.default_problem`` at the throughput operating point (batch
  8192), where the reference found the curve saturated near its 16.75 s
  floor;
* ``boat.hard_problem`` (two offset walls, a deep goal chain) at the
  quality operating point (batch 2048), where budget buys quality.

Each replan is reseeded through the planner's ``torch.Generator``
(``manual_seed(seed)``).  Prints a line a replan, then one JSON record:
per-seed durations (null where the goal was not reached), the means over
the seeds that reached it, and the 0.2 -> 1.0 s and 1.0 -> 4.0 s gains in
percent per instance; writes the record to ``--out`` only when that is
given.

Run:  python -m lqrrt_tpu_torch.tools.exp_quality [--instances default,hard]
          [--budgets 0.2,0.5,1,2,4] [--seeds 777,101,202,303,404,505]
          [--batch B] [--capacity 32768] [--out PATH] [--device cuda]
"""
import argparse
import json
import time

import numpy as np
import torch

from ..models import boat
from ..planner import Planner
from ..utils.device import device_name

BUDGETS = (0.2, 0.5, 1.0, 2.0, 4.0)
SEEDS = (777, 101, 202, 303, 404, 505)
BIAS = [0.3, 0.3, 0, 0, 0, 0]
# name -> (problem, its operating point's batch)
INSTANCES = {"default": (boat.default_problem, 8192),
             "hard": (boat.hard_problem, 2048)}


def floats(text):
    return tuple(float(v) for v in text.split(","))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--instances", default=",".join(INSTANCES))
    ap.add_argument("--budgets", type=floats, default=BUDGETS)
    ap.add_argument("--seeds", type=lambda t: tuple(map(int, t.split(","))),
                    default=SEEDS)
    ap.add_argument("--batch", type=int, default=None,
                    help="every instance's batch (default: its own)")
    ap.add_argument("--capacity", type=int, default=32768)
    ap.add_argument("--out", default=None, help="JSON artifact path")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run_instance(prob, batch, args, informed=0.5):
    p = Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=False, batch_size=batch,
                capacity=args.capacity, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], seed=0, informed=informed,
                device=args.device)
    p.warmup(prob["x0"], prob["sample_space"], goal_bias=BIAS, pruning=True)

    curve = {}
    for budget in args.budgets:
        durs = []
        for seed in args.seeds:
            p._gen.manual_seed(seed)
            t0 = time.time()
            reached = p.update_plan(prob["x0"], prob["sample_space"],
                                    goal_bias=BIAS, specific_time=budget,
                                    pruning=True)
            wall = time.time() - t0
            durs.append(float(p.T) if reached else None)
            print(f"budget {budget:4.1f}s seed {seed}: dur="
                  f"{p.T if reached else None} goal={reached} "
                  f"(wall {wall:.2f}s, rounds={p.stats['rounds']}, "
                  f"restarts={p.stats['restarts']})", flush=True)
        ok = [d for d in durs if d is not None]
        curve[budget] = dict(
            mean=float(np.mean(ok)) if ok else None, seeds=durs,
            goal=f"{len(ok)}/{len(durs)}")
        print(f"== budget {budget}: mean {curve[budget]['mean']} over "
              f"{curve[budget]['goal']}", flush=True)

    def gain(b0, b1):
        if b0 not in curve or b1 not in curve:
            return None
        a, b = curve[b0]["mean"], curve[b1]["mean"]
        return 100.0 * (a - b) / a if a and b else None

    return {"batch": batch, "informed": informed,
            "curve": {str(k): v for k, v in curve.items()},
            "gain_0p2_to_1p0_pct": gain(0.2, 1.0),
            "gain_1p0_to_4p0_pct": gain(1.0, 4.0)}


def main(argv=None) -> dict:
    """Run the curve, print its JSON record (and write --out); returns the
    record."""
    args = parse_args(argv)
    rec = {"tool": "exp_quality",
           "device": device_name(torch.device(args.device)),
           "seeds": list(args.seeds), "budgets": list(args.budgets),
           "instances": {}}
    for name in args.instances.split(","):
        make_prob, batch = INSTANCES[name]
        rec["instances"][name] = run_instance(make_prob(),
                                              args.batch or batch, args)
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
            fh.write("\n")
    return rec


if __name__ == "__main__":
    main()
