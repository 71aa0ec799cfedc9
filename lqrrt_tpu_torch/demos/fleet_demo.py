"""Fleet replanning: many simultaneous boat scenarios on one device (port
of demos/fleet_demo.py; BASELINE.json config: "Pod-scale fleet
replanning: 1k simultaneous boat scenarios").

Every scenario starts at the boat's x0 with a goal perturbed from the
default one (a regatta fanning out to different stations); the fleet
(``lqrrt_tpu_torch/parallel/fleet.py``) grows all their trees at once.  A
fleet sharded over several devices takes ``FleetPlanner(mesh=...)``, one
process a device (``parallel/mesh.py``).

Run:  python -m lqrrt_tpu_torch.demos.fleet_demo [--scenarios 64]
          [--rounds 16] [--batch 64] [--device cuda]
Healthy: exit 0, a goal rate above 0.5.
"""
import argparse
import sys
import time

import numpy as np
import torch

from ..models import boat
from ..parallel import FleetPlanner
from ..utils.device import card_name


def perturbed_goals(prob, n_scenarios: int, seed: int = 0) -> np.ndarray:
    """(S, n) goals: the problem's goal moved by U(-4, 4) m in x and
    U(-6, 6) m in y, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    goals = np.tile(np.asarray(prob["goal"]), (n_scenarios, 1))
    goals[:, 0] += rng.uniform(-4, 4, n_scenarios)
    goals[:, 1] += rng.uniform(-6, 6, n_scenarios)
    return goals


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenarios", type=int, default=64)
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    S = args.scenarios
    dev = torch.device(args.device)
    print(f"device: {card_name(dev)}, scenarios: {S}")
    prob = boat.default_problem()
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], n_scenarios=S,
        batch_size=args.batch, capacity=2048, saturate=prob["saturate"],
        wrap_dims=prob["wrap_dims"], device=dev)

    x0s = np.tile(np.asarray(prob["x0"]), (S, 1))
    goals = perturbed_goals(prob, S)

    # warm-up (the callbacks' constants reach the device), then timed
    fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25, rounds=1)
    t0 = time.time()
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.25,
                       rounds=args.rounds)
    dt_s = time.time() - t0
    eps = stats["expansions"] / dt_s
    print(f"fleet: {S} scenarios x {args.rounds} rounds in {dt_s:.2f}s = "
          f"{eps:,.0f} expansions/s aggregate")
    print(f"fleet: goal rate {stats['goal_found'].mean():.2f}, "
          f"mean nodes {stats['sizes'].mean():.0f}")
    # extract one plan to prove per-scenario results are usable
    plan0 = fleet.extract_plan(0)
    print(f"fleet: scenario 0 plan has {len(plan0)} states, "
          f"ends at {plan0[-1][:2]}")
    return 0 if stats["goal_found"].mean() > 0.5 else 1


if __name__ == "__main__":
    sys.exit(main())
