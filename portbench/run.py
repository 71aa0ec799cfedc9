"""One run of one cell of ``BENCHMARK.json`` on the card:

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

It sets up the cell's system, warms it up, runs the closed loop for
``--seconds`` (``--trace 1`` adds one replan, or fleet cycle, under
``torch.profiler``), judges every committed plan against the plain
reference once the window has closed and the program's state is freed,
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, ``breakdown`` (traced
runs) and ``checks``, each compared number with its limit.  The same
numbers are the last lines of standard error.

Exit codes: 0 after a result; 3 without CUDA or with fewer cards than the
cell asks for; 4 when ``jax``, ``jaxlib``, ``flax`` or ``lqrrt_tpu`` were
loaded.  No result is printed unless the code is 0.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]
CACHE = CHECKOUT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "lqrrt_tpu")
DYN_SAMPLE = 384      # plans whose steps the dynamics numbers read


def _since_start_fn():
    """Seconds since this process started, on the boot clock that
    ``/proc/self/stat`` counts its start in (the interpreter's start-up
    included); the time since this module loaded where that is missing."""
    t_mod = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        start = ticks / os.sysconf("SC_CLK_TCK")
        time.clock_gettime(time.CLOCK_BOOTTIME)
    except (OSError, ValueError, IndexError, AttributeError):
        return lambda: time.perf_counter() - t_mod
    return lambda: time.clock_gettime(time.CLOCK_BOOTTIME) - start


def _cache_env():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "unknown"


def _loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _compare(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): each number beside its limit."""
    ok, checks = True, {}
    for name, spec in limits.items():
        value, limit = numbers.get(name), spec["limit"]
        checks[name] = {"value": value, "limit": limit}
        if value is None or limit is None:
            ok = False
        elif spec["op"] == "<=":
            ok &= value <= limit
        else:
            raise ValueError(f"unknown limit op {spec['op']!r}")
    return ok, checks


def judge(run, seed: int, model=None) -> tuple:
    """(numbers, attempted, failed) of a finished run: every plan of the
    window and the traced replans through the exact checks, a sample drawn
    from the seed (with the longest plan) through the dynamics."""
    from .reference.plans import judge as judge_plans, load_model
    from .traffic import sample_indices

    model = model or load_model(run.cfg)
    records = run.replans + run.traced
    plans = [p for r in records for p in r["plans"]]
    occ = run.occ
    if occ is None and run.mix["obstacle_model"] == "grid":
        occ = model.raster()
    lens = [0 if p["x"] is None else len(p["x"]) for p in plans]
    idx = sample_indices(seed, len(plans), DYN_SAMPLE,
                         must=[max(range(len(plans)), key=lens.__getitem__)])
    K = model.gain() if run.system == "planner" else None
    numbers, faults = judge_plans(model, plans, occ=occ, K=K, dyn_idx=idx)
    for i, names in faults[:10]:
        _log(f"plan {i}: fails {', '.join(names)}")
    if run.system == "planner":
        attempted = len(records)
        failed = sum(not r["ok"] for r in records)
    else:
        attempted = len(plans)
        failed = sum(p["x"] is None for p in plans)
    return numbers, attempted, failed


def main(argv=None, device=None, manifest_path=None, root=None) -> int:
    """Run one cell; returns the exit code.  ``device``, ``manifest_path``
    and ``root`` (the folder of configs, traffic and metrics) serve the
    tests, which run the harness on the CPU; the command line takes the
    card and the checkout's files."""
    since_start = _since_start_fn()
    _cache_env()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import cells
    from .loops import SYSTEMS
    root = Path(root) if root else cells.HERE
    manifest = cells.load_manifest(manifest_path)
    cell = cells.workload(manifest, args.workload)
    cfg = cells.config(cell["config"], root)
    mix = cells.traffic(cell["traffic"], root)

    import torch
    if device is None:
        if not torch.cuda.is_available():
            _log("no CUDA device: this benchmark runs on the card only")
            return 3
        if torch.cuda.device_count() < cell["chips"]:
            _log(f"{args.workload} needs {cell['chips']} cards, "
                 f"{torch.cuda.device_count()} found")
            return 3
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    run = SYSTEMS[cfg["system"]](cfg, mix, args.seed, args.seconds,
                                 bool(args.trace), device, since_start)

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in cells.metrics_for(manifest, args.workload, kind):
        value = cells.reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    for i, r in enumerate(run.replans + run.traced):
        st = r["stats"]
        _log(f"replan {i}: wall_s={r['wall_s']:.4f} rounds={st['rounds']} "
             f"expansions={st['expansions']} elapsed_s={st['elapsed_s']:.4f}"
             + (f" goal={r['ok']} plan_duration_s={st['plan_duration_s']}"
                f" overhead_total_s={st['overhead_total_s']:.4f}"
                if run.system == "planner" else
                f" goal_rate={st['goal_found'].mean():.4f}"
                f" extract_s={r['extract_s']:.4f}"))

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    numbers, attempted, failed = judge(run, args.seed)
    correct, checks = _compare(numbers, cfg["limits"])

    bad = _loaded_forbidden()
    if bad:
        _log(f"loaded in this process: {', '.join(bad)}; the benchmark "
             "runs the port alone")
        return 4
    if torch.device(device).type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": int(cell["chips"]),
               "memory_peak_bytes": run.memory_peak_bytes}
        _log(f"card: {_power_limit()}")
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    for name, c in checks.items():
        _log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
