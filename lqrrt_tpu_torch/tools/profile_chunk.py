"""Time the boat's host-loop chunk (``Planner._get_chunk``, 8 rounds) for
each NN backend (port of tools/profile_chunk.py).

For ``nn_impl`` in ("nn_const", "nn_general", "scan"): a planner at
batch 8192, capacity 32768 (``boat.default_problem()``, seed 0), one warm
chunk on a fresh tree, then chunks 1 and 2 each between two CUDA events
(``utils.timing.StreamMarks``; the host clock on the CPU), with the tree's
size after each.  With 8 rounds a chunk the first chunk fills the tree
and chunks 1 and 2 run at capacity, as the reference's do.  The boat's
lqr is constant, so "nn_general" runs kernel C on a tree of one S
repeated.

Prints one JSON line with the device's name and ``nvidia-smi`` power limit;
writes the same record to ``--out`` only when that is given.

Run:  python -m lqrrt_tpu_torch.tools.profile_chunk [--batch 8192]
          [--capacity 32768] [--out PATH] [--device cuda]
"""
import argparse
import json

import torch

from ..models import boat
from ..planner import Planner
from ..utils.timing import StreamMarks
from .bench_fleet import device_name

IMPLS = ("nn_const", "nn_general", "scan")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--capacity", type=int, default=32768)
    ap.add_argument("--out", default=None, help="JSON artifact path")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def profile_impl(impl, args):
    prob = boat.default_problem()
    p = Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=False, batch_size=args.batch,
                capacity=args.capacity, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], seed=0, nn_impl=impl,
                device=args.device)
    chunk = p._get_chunk(None, 0)
    x0 = p._tensor(prob["x0"])
    tree = p._seed_tree(x0, p.goal)
    ss = p._tensor(prob["sample_space"])
    gb = torch.zeros_like(p.goal)
    informed = p._informed_start(x0)    # as the host loop passes it

    def run():
        return chunk(tree, p.goal, ss, gb, p.goal, informed=informed)

    st = run()                                       # warm: fills the tree
    rec = {"nn_selected": p.nn_selected, "rounds_per_chunk":
           p.rounds_per_chunk, "size_after_chunk0": int(st[0])}
    for c in (1, 2):
        marks = StreamMarks(args.device)
        marks.mark()
        st = run()
        marks.mark()
        ms = marks.intervals_ms()[0]
        rec[f"chunk{c}_ms"] = ms
        rec[f"chunk{c}_ms_per_round"] = ms / p.rounds_per_chunk
        rec[f"size_after_chunk{c}"] = int(st[0])
    return rec


def main(argv=None) -> dict:
    """Time each backend, print one JSON record (and write --out); returns
    the record."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    rec = {"tool": "profile_chunk", "device": device_name(dev),
           "clock": "cuda_events" if dev.type == "cuda" else "host",
           "batch": args.batch, "capacity": args.capacity, "impls": {}}
    for impl in IMPLS:
        rec["impls"][impl] = profile_impl(impl, args)
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
            fh.write("\n")
    return rec


if __name__ == "__main__":
    main()
