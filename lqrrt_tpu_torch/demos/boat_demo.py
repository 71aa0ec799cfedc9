"""WAM-V boat demo, the headline workload (port of demos/boat_demo.py).

Plans a 40 m transit through a buoy field, then simulates the vessel
tracking the plan (feedforward efforts plus LQR feedback on the planned
state) and checks it; ``--out`` saves a tree/plan figure.

Run:  python -m lqrrt_tpu_torch.demos.boat_demo [--replan] [--grid]
          [--seed 0] [--out boat_demo.png] [--device cuda]
  --replan  1 Hz replanning loop from the executed state (FPR warm-started)
  --grid    occupancy-grid feasibility instead of analytic circles
"""
import sys

import numpy as np

from ..models import boat
from .common import parser, run_replan_loop, run_single


def main(argv=None):
    ap = parser(__doc__, "boat")
    ap.add_argument("--grid", action="store_true")
    args = ap.parse_args(argv)
    prob = boat.default_problem(
        obstacle_model="grid" if args.grid else "circles")
    gb = np.array([0.3, 0.3, 0, 0, 0, 0], np.float32)
    if args.replan:
        return run_replan_loop("boat", prob, gb, args.out, seed=args.seed,
                               device=args.device)
    return run_single("boat", prob, gb, args.out, seed=args.seed,
                      device=args.device)


if __name__ == "__main__":
    sys.exit(main())
