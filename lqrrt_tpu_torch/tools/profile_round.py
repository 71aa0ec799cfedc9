"""Where one grow round's time goes, phase by phase (port of
tools/profile_round_r5.py:56-175).

For each model at its bench width (batch 8192, capacity 32768; the boat,
the car, the quadrotor and the grid boat, each with its bench goal bias),
the round is the grow round of the planner's fused-restart chunk
(``Planner._get_restart_chunk``, the path ``update_plan`` takes for these
models), built from the planner's own parts: its sampler
(``Planner._sampler``, drawing as that chunk does before a goal: the
informed mix on the straight x0 -> goal pool at fraction 0, and no FPR
rows, as on a first replan), its NN (``_nearest_override``: kernel A for
the boat and the grid boat, kernel C for the car and the quadrotor, the
plain scan on the CPU), the gather of ``make_expand``,
``core/rounds.py``'s ``make_extend_stages`` (``make_extend``'s three
stages, with ``Planner._expand``'s arguments) and ``commit_candidates``.
``tests/test_torch_profilers.py`` holds one round against
``Planner._expand`` and ``commit_candidates`` on the same draw, bit for
bit.  A tree is filled first (the rounds then run at capacity, as the
reference's do), and then:

- the direct split: ``--rounds`` rounds with a mark between the phases
  (sample, nearest, gather, steer, lqr, goal cost, commit), all chained on
  one stream and read once at the end (``utils.timing.StreamMarks``: CUDA
  events on the card, nothing waits between marks); the median of each
  phase over the rounds.  A phase whose launches the host cannot enqueue
  as fast as the card runs them shows its enqueue time here;
- the knockout deltas of the reference: chunks of ``--rounds-per-chunk``
  rounds, whole and with the nearest (parents ``arange(B) % size``), the
  steer (a stand-in rollout) or the commit (a sink) dropped, the other
  phases live; each delta in ms a round;
- the device's kernel time over one round, its kernel count and its busy
  share of the unprofiled round (``torch.profiler``, ``utils.timing.
  device_busy``);
- the NN's time composed at live sizes 8192, capacity / 2 and capacity:
  16 chained calls on the filled tree (each call's candidates moved by
  1e-7 x the last call's costs), between two marks.

Prints one JSON line with the device's name and ``nvidia-smi`` power limit;
writes the same record to ``--out`` only when that is given.  On the CPU
every time is the host's clock and every device figure is null.

Run:  python -m lqrrt_tpu_torch.tools.profile_round
          [--models boat,car,quadrotor,grid_boat] [--batch 8192]
          [--capacity 32768] [--rounds 5] [--chunks 2]
          [--rounds-per-chunk 8] [--out PATH] [--device cuda]
"""
import argparse
import json
import statistics
import time

import torch

from ..core.nearest import make_nearest
from ..core.rounds import commit_candidates, make_extend_stages
from ..core.steer import SteerResult
from ..models import boat, car, quadrotor
from ..planner import Planner
from ..utils.timing import StreamMarks, device_busy
from .bench_fleet import device_name

PHASES = ("sample", "nearest", "gather", "steer", "lqr", "goal_cost",
          "commit")
KNOCKOUTS = ("nearest", "steer", "commit")
NN_REPS = 16

# name -> (problem, the bench's goal bias)
MODELS = {
    "boat": (boat.default_problem, [0.3, 0.3, 0, 0, 0, 0]),
    "car": (car.default_problem, [0.3, 0.3, 0, 0]),
    "quadrotor": (quadrotor.default_problem, [0.3] * 3 + [0.0] * 9),
    "grid_boat": (lambda: boat.default_problem(obstacle_model="grid"),
                  [0.3, 0.3, 0, 0, 0, 0]),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--capacity", type=int, default=32768)
    ap.add_argument("--rounds", type=int, default=5,
                    help="rounds of the direct split")
    ap.add_argument("--chunks", type=int, default=2,
                    help="timed chunks of each knockout variant")
    ap.add_argument("--rounds-per-chunk", type=int, default=8)
    ap.add_argument("--out", default=None, help="JSON artifact path")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def build(name, batch, capacity, device):
    """(round_fn, tree, parts) of one model: round_fn(tree, mark, drop)
    runs one grow round in place, calling ``mark()`` before the first
    phase and after each; ``drop`` is None or one of KNOCKOUTS."""
    make_prob, bias = MODELS[name]
    prob = make_prob()
    p = Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=False, batch_size=batch,
                capacity=capacity, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], device=device, seed=0)
    p._load_feasibility_data()
    spec = p._spec()
    nearest = p._nearest_override() or make_nearest(
        p.erf, block=min(spec.nn_block, spec.capacity))
    steer, endpoint, finish = make_extend_stages(
        spec, p.dynamics, p.lqr, p.erf, p._feasibility(), p.error_tol,
        p.constraints.goal_buffer, wrap_mask=p._wrap_mask(),
        saturate=p.saturate)
    goal = p.goal
    ss = p._tensor(prob["sample_space"])
    gb = p._tensor(bias)
    x0 = p._tensor(prob["x0"])
    draw = p._sampler(None, 0, p.informed > 0.0)
    pool = p._straight_line(x0)

    def sample():
        return draw(pool, 0.0, ss, gb, goal, None)

    ar = torch.arange(batch, device=p.device)
    H, n, m = spec.horizon_steps, spec.nstates, spec.ncontrols

    def stand_in(x0, xrand):
        """The reference's steer knockout: a one-step rollout at x0."""
        f = torch.zeros((batch,), dtype=torch.bool, device=p.device)
        return SteerResult(
            x_seq=x0.T[None].expand(H, n, batch) * 1.0001,
            u_seq=torch.zeros((H, m, batch), device=p.device),
            mask=torch.zeros((H, batch), dtype=torch.bool, device=p.device),
            length=torch.ones((batch,), dtype=torch.int32, device=p.device),
            xnew=x0 + 0.01 * xrand, reached=f, in_goal=f)

    def sink(tree, c):
        """The reference's commit knockout: every output read into one
        scalar, the size advanced as a commit would."""
        tree.node_time[:1] += 1e-12 * (
            c.xnew.sum() + c.gcost.sum() + c.x_seq[0, 0].sum()
            + c.u_seq[0, 0].sum() + c.length.float().sum()
            + c.pids.float().sum())
        tree.size.copy_(torch.clamp(tree.size + batch, max=spec.capacity))

    def round_fn(tree, mark=lambda: None, drop=None):
        mark()
        xrand = sample()
        mark()
        if drop == "nearest":
            pids = (ar % torch.clamp(tree.size, min=1)).to(torch.int32)
        else:
            pids, _ = nearest(tree.state, tree.S, tree.size, xrand)
        mark()
        pl = pids.long()
        x0, K0 = tree.state[pl], tree.K[pl]
        mark()
        res = (stand_in(x0, xrand) if drop == "steer"
               else steer(x0, K0, xrand, goal))
        mark()
        S_new, K_new = endpoint(res)
        mark()
        c = finish(pids, res, S_new, K_new, goal)
        mark()
        if drop == "commit":
            sink(tree, c)
        else:
            commit_candidates(spec, tree, c)
        mark()

    tree = p._seed_tree(x0, goal)
    parts = dict(planner=p, nearest=nearest, spec=spec, sample=sample)
    return round_fn, tree, parts


def profile_model(name, args):
    """The record of one model (see the module docstring)."""
    dev = args.device
    round_fn, tree, parts = build(name, args.batch, args.capacity, dev)
    spec = parts["spec"]
    # fill the tree: the dense commit-all lands a batch a round
    for _ in range(-(-spec.capacity // spec.batch)):
        round_fn(tree)

    # the direct split, one warm-up round first
    marks = StreamMarks(dev)
    for _ in range(args.rounds + 1):
        round_fn(tree, marks.mark)
    iv = marks.intervals_ms()
    per_round = len(PHASES) + 1     # the phases, then the gap to the next
    rounds = [iv[i * per_round:i * per_round + len(PHASES)]
              for i in range(1, args.rounds + 1)]
    phases = {ph: statistics.median(r[k] for r in rounds)
              for k, ph in enumerate(PHASES)}
    round_ms = statistics.median(sum(r) for r in rounds)

    # the knockout deltas, chunks of rounds between two marks
    rpc = args.rounds_per_chunk

    def chunk_ms(drop):
        for _ in range(rpc):                    # warm-up chunk
            round_fn(tree, drop=drop)
        marks = StreamMarks(dev)
        marks.mark()
        for _ in range(args.chunks * rpc):
            round_fn(tree, drop=drop)
        marks.mark()
        return marks.intervals_ms()[0] / (args.chunks * rpc)

    full = chunk_ms(None)
    knockout = {"round_ms": full}
    for drop in KNOCKOUTS:
        knockout[f"{drop}_ms"] = max(full - chunk_ms(drop), 0.0)

    # the device's busy share of one round
    busy = dict(device_ms=None, kernels=None, busy_share=None)
    if torch.device(dev).type == "cuda":
        busy_ms, kernels = device_busy(lambda: round_fn(tree))
        busy = dict(device_ms=busy_ms, kernels=kernels,
                    busy_share=busy_ms / round_ms)

    # the NN composed at live sizes, chained calls on the filled tree
    nearest = parts["nearest"]
    xr0 = parts["sample"]()
    nn_ms = {}
    for size in sorted({min(8192, spec.capacity), spec.capacity // 2,
                        spec.capacity}):
        sz = torch.tensor(size, dtype=torch.int32, device=xr0.device)

        def composed():
            xr = xr0
            for _ in range(NN_REPS):
                _, cost = nearest(tree.state, tree.S, sz, xr)
                xr = xr + 1e-7 * cost[:, None]
            return xr

        composed()
        marks = StreamMarks(dev)
        marks.mark()
        composed()
        marks.mark()
        nn_ms[str(size)] = marks.intervals_ms()[0] / NN_REPS

    return {"batch": spec.batch, "capacity": spec.capacity,
            "horizon_steps": spec.horizon_steps,
            "nn": parts["planner"].nn_selected,
            "rounds_timed": args.rounds, "phases_ms": phases,
            "round_ms": round_ms,
            "round_expansions_per_s": spec.batch / round_ms * 1e3,
            "knockout_ms": knockout, "knockout_rounds": args.chunks * rpc,
            "busy": busy, "nn_composed_ms": nn_ms}


def main(argv=None) -> dict:
    """Profile each model, print one JSON record (and write --out);
    returns the record."""
    args = parse_args(argv)
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    rec = {"tool": "profile_round", "device": device_name(dev),
           "clock": "cuda_events" if dev.type == "cuda" else "host",
           "models": {}}
    for name in args.models.split(","):
        rec["models"][name] = profile_model(name, args)
    rec["wall_s"] = time.perf_counter() - t0
    print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rec, fh, indent=1)
            fh.write("\n")
    return rec


if __name__ == "__main__":
    main()
