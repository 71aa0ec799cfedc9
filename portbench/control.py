"""The control of ``correct``: for each seed, one short run of a cell (its
own sizes, its own load), then every compared number read twice from the
same committed plans: as the program gave them, and as the reference
computed in bfloat16, the precision below the configuration's float32,
would give them (``reference/plans.py`` ``control_plans``).  The
program's readings over a dozen seeds or more give each limit its lower
reading, the control's its upper one (PERF.md).

    python -m portbench.control --workload boat.replan \\
        --seeds 11,12,13 --seconds 6

Prints one JSON line a seed, then the largest program reading and the
smallest control reading of each number.  The benchmark's own runs do not
run it.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

from .run import _cache_env, _since_start_fn, judge


def readings(cell: str, seeds, seconds: float, device="cuda",
             manifest_path=None, root=None) -> list:
    from . import cells
    from .loops import SYSTEMS
    from .reference.plans import control_plans, load_model

    root = Path(root) if root else cells.HERE
    manifest = cells.load_manifest(manifest_path)
    w = cells.workload(manifest, cell)
    cfg = cells.config(w["config"], root)
    mix = cells.traffic(w["traffic"], root)
    model = load_model(cfg)
    out = []
    for seed in seeds:
        run = SYSTEMS[cfg["system"]](cfg, mix, seed, seconds, False, device,
                                     _since_start_fn())
        gc.collect()
        program = judge(run, seed, model)[0]
        for r in run.replans:
            r["plans"] = control_plans(model, r["plans"])
        control = judge(run, seed, model)[0]
        out.append({"seed": seed, "replans": len(run.replans),
                    "program": program, "control": control})
        print(json.dumps(out[-1]), flush=True)
        del run
        gc.collect()
    return out


def main(argv=None) -> int:
    _cache_env()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    seeds = [int(s) for s in args.seeds.split(",")]
    out = readings(args.workload, seeds, args.seconds)
    names = sorted({k for o in out for k in o["program"]})
    summary = {
        n: {"program_max": max(o["program"].get(n, float("nan"))
                               for o in out),
            "control_min": min(o["control"].get(n, float("nan"))
                               for o in out)}
        for n in names}
    print(json.dumps({"workload": args.workload, "seeds": len(seeds),
                      "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
