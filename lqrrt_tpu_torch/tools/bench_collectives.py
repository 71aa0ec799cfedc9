"""The best-edge collectives, "gather" against "topk" (port of
tools/bench_collectives.py): the communication volume of each, and the
sharded round's time with each on whatever mesh it runs on.

Communication per round per rank, B the global batch, H the horizon
steps, n and m the state and control dims, k the topk, float32:

  gather: the whole candidate batch is all-gathered,
          B * (H (n + m) + n + n^2 + m n + 4) * 4 bytes;
  topk:   one (B,) score all-gather (B * 4 bytes) and a SUM all-reduce of
          k zero-masked winner rows, counted twice as a reduction moves
          them: 2 k * (H (n + m) + n + n^2 + m n + 4) * 4 bytes.

At B = 8192, H = 100, n = 6, m = 3: gather 31.6 MB, topk at k = 1024
7.9 MB.

    python -m lqrrt_tpu_torch.tools.bench_collectives [--device cuda]
    torchrun --nproc-per-node=N -m lqrrt_tpu_torch.tools.bench_collectives

Run alone it makes a one-rank world (NCCL on the card, gloo on the CPU):
there the collectives are the device's local copies, not an interconnect,
and each record says so (``"interconnect": false``).  Under a launcher
(``WORLD_SIZE`` > 1) each rank joins the job through
``parallel.mesh.init_distributed`` and the first rank prints the records.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist


def comm_bytes(B, H, n, m, k=None):
    per_cand = (H * (n + m) + n + n * n + m * n + 4) * 4
    if k is None:
        return B * per_cand
    return B * 4 + 2 * k * per_cand


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch-per-device", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--capacity", type=int, default=2048)
    ap.add_argument("--horizon-steps", type=int, default=40)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def bench(args, mesh) -> list:
    """One record a collective (gather; topk at B/8 and B/32) of the
    boat's sharded round on ``mesh`` (its "dp" axis), from a seed tree,
    the best of two timed runs of ``args.rounds`` rounds."""
    from ..core.rounds import RoundSpec
    from ..core.tree import init_tree
    from ..models import boat
    from ..parallel.mesh import axis_size, world_size
    from ..parallel.sharded import (make_sharded_round, rank_generator,
                                    replicate_tree)

    dev = torch.device(args.device)
    n_dev = axis_size(mesh, "dp")
    prob = boat.default_problem()
    B, H = args.batch_per_device * n_dev, args.horizon_steps
    blk = min(1024, args.capacity)
    spec = RoundSpec(6, 3, B, H, args.capacity, prob["dt"], nn_block=blk,
                     slack=-(-B // blk) * blk)
    x0 = torch.as_tensor(prob["x0"], device=dev)
    S0, K0 = prob["lqr"](x0, torch.zeros(3, device=dev))
    wrap_mask = np.zeros(6, bool)
    wrap_mask[2] = True
    goal = torch.as_tensor(prob["goal"], device=dev)
    ss = torch.as_tensor(prob["sample_space"], device=dev)
    gb = torch.full((6,), 0.2, device=dev)
    out = []
    for collective, k in (("gather", None), ("topk", B // 8),
                          ("topk", B // 32)):
        rf = make_sharded_round(
            spec, mesh, prob["dynamics"], prob["lqr"], prob["erf"],
            prob["constraints"].is_feasible, 0.05,
            prob["constraints"].goal_buffer, wrap_mask=wrap_mask,
            saturate=prob["saturate"], collective=collective, topk=k)

        def run(reps):
            gen = rank_generator(0, mesh, "dp", dev)
            tree = replicate_tree(init_tree(
                args.capacity, H, 6, 3, x0, S0, K0,
                torch.tensor(1e9, device=dev),
                torch.tensor(False, device=dev), slack=spec.slack), mesh)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                rf(tree, gen, goal, ss, gb, goal)
            size = int(tree.size)                 # waits for the device
            return time.perf_counter() - t0, size

        run(2)                                    # warm-up
        elapsed, size = min(run(args.rounds) for _ in range(2))
        out.append({
            "collective": collective, "topk": k, "devices": world_size(),
            "global_batch": B,
            "round_ms": round(1e3 * elapsed / args.rounds, 3),
            "expansions_per_s": round(B * args.rounds / elapsed, 1),
            "tree_size_after": size,
            "comm_bytes_per_round_per_device": comm_bytes(B, H, 6, 3, k),
            "platform": "gpu" if dev.type == "cuda" else "cpu",
            "interconnect": world_size() > 1})
    return out


def main(argv=None) -> int:
    from ..parallel import mesh as meshlib

    args = parse_args(argv)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    own = not dist.is_initialized()
    if own and world > 1:
        meshlib.init_distributed(None, world, int(os.environ["RANK"]),
                                 device_type=args.device)
    elif own:
        if args.device == "cuda":
            torch.cuda.set_device(0)
        store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
        dist.init_process_group(meshlib.BACKENDS[args.device], store=store,
                                world_size=1, rank=0)
    try:
        recs = bench(args, meshlib.make_mesh(device_type=args.device))
        if dist.get_rank() == 0:
            for rec in recs:
                print(json.dumps(rec), flush=True)
            if meshlib.world_size() == 1:
                print("one rank: every collective is a local copy on the "
                      "device, so these times are not interconnect numbers",
                      flush=True)
    finally:
        if own:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
