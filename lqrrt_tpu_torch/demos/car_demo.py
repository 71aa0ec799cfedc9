"""Car-like (kinematic bicycle) slalom: nonholonomic steering with the
re-linearized (batched CARE) LQR (port of demos/car_demo.py).

Run:  python -m lqrrt_tpu_torch.demos.car_demo [--replan] [--seed 0]
          [--out car_demo.png] [--device cuda]
"""
import sys

import numpy as np

from ..models import car
from .common import parser, run_replan_loop, run_single


def main(argv=None):
    args = parser(__doc__, "car").parse_args(argv)
    prob = car.default_problem()
    gb = np.array([0.25, 0.25, 0.0, 0.0], np.float32)
    if args.replan:
        return run_replan_loop("car", prob, gb, args.out, seed=args.seed,
                               device=args.device)
    # nonholonomic tracking is looser than the holonomic workloads
    return run_single("car", prob, gb, args.out, seed=args.seed, pos_tol=1.5,
                      device=args.device)


if __name__ == "__main__":
    sys.exit(main())
