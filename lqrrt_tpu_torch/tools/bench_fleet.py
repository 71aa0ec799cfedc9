"""Fleet benchmark at advertised scale (port of tools/bench_fleet.py;
BASELINE.json config 5: "Pod-scale fleet replanning: 1k simultaneous boat
scenarios").

Runs the port's ``FleetPlanner`` (``lqrrt_tpu_torch/parallel/fleet.py``)
on --scenarios boat problems (``boat.default_problem()``, goals perturbed
by ``demos/fleet_demo.py``'s ``perturbed_goals``) under a wall-clock
anytime budget, then extracts every scenario's plan: cold once, then warm
as the best of 3.  Prints one JSON record (aggregate expansions/s, goal
rate, time-to-first-goal, extraction with its breakdown) and writes it to
--out when given.  Defaults: 1024 scenarios, batch 64, capacity 1024,
``nn_block=256`` (slack 256), goal bias 0.25, a 2.0 s budget in chunks of
8 rounds, at most 64 rounds.

Memory: the edge rollouts dominate, (capacity + slack) x H x (n + m) x 4 B
= 1280 x 100 x 9 x 4 B, ~4.4 MiB a scenario, ~4.7 GB for 1024.

Run:  python -m lqrrt_tpu_torch.tools.bench_fleet [--scenarios 1024]
          [--out FLEET.json] [--device cuda]
Exit code 0 when the goal rate within the budget is above 0.5.  A round is
bound by the host's launches, so the budget's round count, and with it
this exit code, follows the host's speed; ``chip_smoke.py`` gates the goal
rate on a fixed 64 rounds instead.
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

from ..demos.fleet_demo import perturbed_goals
from ..models import boat
from ..parallel import FleetPlanner
from .kernel_times import smi_line


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=64)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--capacity", type=int, default=1024)
    ap.add_argument("--max-time", type=float, default=2.0,
                    help="wall-clock anytime budget (s)")
    ap.add_argument("--out", default=None, help="JSON artifact path")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def device_name(dev: torch.device) -> str:
    """The card's name and ``nvidia-smi`` power limit, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    limit = smi_line().rsplit(", ", 1)[-1]
    return f"{torch.cuda.get_device_name(dev)} x1, {limit}"


def bench(args):
    """Plan and extract as ``main`` does; returns (record, fleet, plans,
    problem, x0s, goals) for callers that check the fleet further."""
    dev = torch.device(args.device)
    S = args.scenarios
    prob = boat.default_problem()
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], n_scenarios=S,
        batch_size=args.batch, capacity=args.capacity, nn_block=256,
        saturate=prob["saturate"], wrap_dims=prob["wrap_dims"], device=dev)
    x0s = np.tile(np.asarray(prob["x0"]), (S, 1))
    goals = perturbed_goals(prob, S)

    # warm-up: one 1-round chunk (the callbacks' constants reach the
    # device, and the per-round time seeds the timed run's first clamp)
    fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25, rounds=1,
               max_time=1e9, rounds_per_chunk=1)
    t0 = time.time()
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                       rounds=args.rounds, max_time=args.max_time,
                       rounds_per_chunk=8)
    wall = time.time() - t0

    # batched extraction of EVERY scenario's plan, cold, then warm best-of-3
    t1 = time.time()
    plans = fleet.extract_plans()
    extract_cold = time.time() - t1
    extract_wall = float("inf")
    best_tm = None
    for _ in range(3):
        t1 = time.time()
        plans = fleet.extract_plans()
        dt_e = time.time() - t1
        if dt_e < extract_wall:
            extract_wall = dt_e
            best_tm = dict(fleet.last_extract_timings)
    fleet.last_extract_timings = best_tm

    gt = stats["goal_time_s"][~np.isnan(stats["goal_time_s"])]
    rec = {
        "metric": "fleet_boat_expansions_per_s_aggregate",
        "value": round(stats["expansions_per_s"], 1),
        "unit": "expansions/s",
        "scenarios": int(S),
        "rounds": int(stats["rounds"]),
        "budget_s": args.max_time,
        "elapsed_s": round(stats["elapsed_s"], 4),
        "per_round_s": round(fleet._per_round_s, 4),
        "wall_s": round(wall, 3),
        "budget_overshoot_pct": round(100.0 * max(
            wall / args.max_time - 1.0, 0.0), 1),
        "goal_rate": round(float(stats["goal_found"].mean()), 4),
        "mean_nodes": round(float(stats["sizes"].mean()), 1),
        "goal_time_p50_s": round(float(np.median(gt)), 3) if len(gt) else None,
        "goal_time_p99_s": (round(float(np.percentile(gt, 99)), 3)
                            if len(gt) else None),
        "extract_all_plans_s": round(extract_wall, 3),
        "extract_all_plans_cold_s": round(extract_cold, 3),
        "extract_breakdown": fleet.last_extract_timings,
        "mean_plan_steps": round(float(np.mean(
            [len(p) for p in plans.values()])), 1),
        "device": device_name(dev),
    }
    return rec, fleet, plans, prob, x0s, goals


def main(argv=None) -> dict:
    """Run the bench, print its JSON record (and write --out); returns the
    record."""
    args = parse_args(argv)
    rec = bench(args)[0]
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
            fh.write("\n")
    return rec


if __name__ == "__main__":
    sys.exit(0 if main()["goal_rate"] > 0.5 else 1)
