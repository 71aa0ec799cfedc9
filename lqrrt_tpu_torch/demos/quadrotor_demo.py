"""12-state quadrotor through a column field, the heaviest batched-CARE
workload (port of demos/quadrotor_demo.py).

Run:  python -m lqrrt_tpu_torch.demos.quadrotor_demo [--replan] [--seed 0]
          [--out quadrotor_demo.png] [--device cuda]
"""
import sys

import numpy as np

from ..models import quadrotor as quad
from .common import parser, run_replan_loop, run_single


def main(argv=None):
    args = parser(__doc__, "quadrotor").parse_args(argv)
    prob = quad.default_problem()
    gb = np.zeros(12, np.float32)
    gb[:3] = 0.25
    if args.replan:
        return run_replan_loop("quad", prob, gb, args.out, seed=args.seed,
                               batch_size=128, capacity=4096,
                               device=args.device)
    return run_single("quad", prob, gb, args.out, seed=args.seed, pos_tol=1.0,
                      batch_size=128, capacity=4096, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
