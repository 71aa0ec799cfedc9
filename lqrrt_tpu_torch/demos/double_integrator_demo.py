"""2-D double-integrator point mass through circular obstacles, the
reference's "hello world" workload (port of demos/double_integrator_demo.py).

Run:  python -m lqrrt_tpu_torch.demos.double_integrator_demo [--replan]
          [--seed 0] [--out double_integrator_demo.png] [--device cuda]
"""
import sys

from ..models import double_integrator as di
from .common import parser, run_replan_loop, run_single


def main(argv=None):
    args = parser(__doc__, "double_integrator").parse_args(argv)
    prob = di.default_problem()
    gb = 0.2
    if args.replan:
        return run_replan_loop("di", prob, gb, args.out, seed=args.seed,
                               device=args.device)
    return run_single("di", prob, gb, args.out, seed=args.seed,
                      device=args.device)


if __name__ == "__main__":
    sys.exit(main())
