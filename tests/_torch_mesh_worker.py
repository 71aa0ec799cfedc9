"""One rank of a gloo job for the port's multi-device tests
(``lqrrt_tpu_torch/parallel``): the counterpart of
``tests/_distributed_worker.py``, on ``torch.distributed``.

    python _torch_mesh_worker.py <coordinator> <world> <rank> <inputs.npz>
                                 <out_dir> <case>[,<case>...]

The rank joins the job through ``parallel.mesh.init_distributed`` (gloo,
CPU tensors), runs each case in order and writes what it found to
``<out_dir>/rank<r>.npz`` (keys ``<case>/<name>``); the test compares
those with the JAX package's sharded rounds and across ranks.  The inputs
(seed trees, candidate tables, the JAX (S, K)) come from the test as
numpy.  It imports no JAX.  ``spawn`` and ``collect`` run a job from a
test.
"""
import os
import socket
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the shapes shared with the tests: the double integrator, H = 20
N_X, N_U, H, DT, TOL = 4, 2, 20, 0.05, 0.05
B, CAP, BLK, SLACK, TOPK = 64, 512, 128, 64, 16     # the sharded rounds
R_ROUNDS = 3                                        # lockstep rounds
MB, MCAP = 32, 256                                  # the grid rounds
FIELDS = ("state", "S", "K", "parent", "edge_x", "edge_u", "edge_len",
          "node_time", "in_goal", "goal_cost", "n_children", "size",
          "goal_found")                              # TreeArrays' fields


def grid_world():
    """A wall with a gap, rasterised (tests/test_map_sharded.py): x and y
    in [0, 16], 0.25 m cells."""
    occ = np.zeros((64, 64), bool)
    occ[:, 28:32] = True          # vertical wall at x in [7, 8)
    occ[24:32, 28:32] = False     # gap at y in [6, 8)
    return occ, np.zeros(2, np.float32), 0.25


GRID_X0 = np.array([2.0, 7.0, 0.0, 0.0], np.float32)
GRID_GOAL = np.array([14.0, 7.0, 0.0, 0.0], np.float32)
GRID_SS = np.array([[0.0, 16.0], [0.0, 16.0], [-2.0, 2.0], [-2.0, 2.0]],
                   np.float32)


def _tree(inp, prefix):
    from lqrrt_tpu_torch import interop
    from lqrrt_tpu_torch.core.tree import TreeArrays

    return interop.tree_from_numpy(
        {f: inp[f"{prefix}/{f}"] for f in TreeArrays._fields}, device="cpu")


def _out(tree, prefix):
    from lqrrt_tpu_torch import interop

    return {f"{prefix}/{k}": v.copy()
            for k, v in interop.tree_to_numpy(tree).items()}


def _common(inp, obstacles=True):
    from lqrrt_tpu_torch import interop
    from lqrrt_tpu_torch.models import double_integrator as di

    prob = di.default_problem(obstacles=obstacles)
    lqr = interop.lqr_from_numpy(inp["jS"], inp["jK"])
    return prob, lqr


def _spec(batch=B, cap=CAP, slack=SLACK):
    from lqrrt_tpu_torch.core.rounds import RoundSpec

    return RoundSpec(nstates=N_X, ncontrols=N_U, batch=batch,
                     horizon_steps=H, capacity=cap, dt=DT, nn_block=BLK,
                     slack=slack)


def _table_gen(table, rank):
    """xrand_gen reading this rank's row of the current round's table."""
    state = {"r": 0}

    def gen(g, nb):
        x = torch.from_numpy(table[state["r"], rank][:nb].copy())
        state["r"] += 1
        return x
    return gen


def _sharded_lockstep(ctx, collective, commit="grow", key="lock",
                      mesh=None, axis="dp"):
    """Rounds of ``make_sharded_round`` fed by the tables (row: the rank's
    index over ``axis``), from the JAX tree; the tree after each."""
    from lqrrt_tpu_torch.parallel.mesh import axis_index
    from lqrrt_tpu_torch.parallel.sharded import make_sharded_round

    inp = ctx["inp"]
    mesh = ctx["mesh_dp"] if mesh is None else mesh
    prob, lqr = _common(inp)
    table = inp[f"{key}/table"]
    rf = make_sharded_round(
        _spec(), mesh, prob["dynamics"], lqr, prob["erf"],
        prob["constraints"].is_feasible, TOL,
        prob["constraints"].goal_buffer, saturate=prob["saturate"],
        xrand_gen=_table_gen(table, axis_index(mesh, axis)),
        collective=collective, topk=TOPK, commit=commit, axis=axis)
    tree = _tree(inp, f"{'refine' if commit == 'refine' else 'lock'}/tree0")
    goal = torch.from_numpy(prob["goal"])
    out = {}
    for r in range(table.shape[0]):
        start = (torch.tensor(int(inp["refine/start"]))
                 if commit == "refine" else None)
        rf(tree, None, goal, None, None, None, start=start)
        out.update(_out(tree, f"r{r}"))
    return out


def case_gather(ctx):
    return _sharded_lockstep(ctx, "gather")


def case_topk(ctx):
    return _sharded_lockstep(ctx, "topk")


def case_refine(ctx):
    return _sharded_lockstep(ctx, "gather", commit="refine", key="refine")


def case_gather2d(ctx):
    """The gather round sharded over both dims of the hosts x chips mesh
    (``axis=("host", "dp")``, host-major rank order)."""
    from lqrrt_tpu_torch.parallel.mesh import make_mesh_2d

    return _sharded_lockstep(ctx, "gather", key="lock4",
                             mesh=make_mesh_2d(2, 2, device_type="cpu"),
                             axis=("host", "dp"))


def case_replicas(ctx):
    """Eight rounds of each collective from the seed tree, each rank's
    shard drawn from its own generator; the trees, to be compared across
    ranks bit for bit."""
    from lqrrt_tpu_torch.parallel.sharded import (make_sharded_round,
                                                  rank_generator,
                                                  replicate_tree)

    inp, mesh = ctx["inp"], ctx["mesh_dp"]
    prob, lqr = _common(inp)
    out = {}
    for collective in ("gather", "topk"):
        rf = make_sharded_round(
            _spec(), mesh, prob["dynamics"], lqr, prob["erf"],
            prob["constraints"].is_feasible, TOL,
            prob["constraints"].goal_buffer, saturate=prob["saturate"],
            collective=collective, topk=TOPK)
        gen = rank_generator(3, mesh, "dp", "cpu")
        tree = replicate_tree(_tree(inp, "lock/tree0"), mesh)
        ss = torch.from_numpy(prob["sample_space"])
        goal = torch.from_numpy(prob["goal"])
        gb = torch.full((N_X,), 0.2)
        for _ in range(8):
            rf(tree, gen, goal, ss, gb, goal)
        out.update(_out(tree, collective))
        out[f"{collective}/first_draw"] = torch.rand(
            4, generator=rank_generator(3, mesh, "dp", "cpu")).numpy()
    return out


def _patched_sampler(module):
    """The map-sharded round draws with ``sample_batch``: the tests pass
    the round's candidates as its sample space."""
    module.sample_batch = lambda gen, nb, ss, gb, bt: ss


def case_map(ctx):
    """``make_map_sharded_round`` over a 2-shard map axis, two rounds."""
    from lqrrt_tpu_torch.parallel import map_sharded as pm

    inp, mesh = ctx["inp"], ctx["mesh_map"]
    prob, lqr = _common(inp, obstacles=False)
    occ, origin, res = grid_world()
    grid = pm.ShardedGrid(occ, origin, res, n_shards=2)
    _patched_sampler(pm)
    rf = pm.make_map_sharded_round(
        _spec(MB, MCAP, MB), mesh, grid, prob["dynamics"], lqr, prob["erf"],
        lambda x, u: torch.ones(x.shape[:-1], dtype=torch.bool), TOL,
        prob["constraints"].goal_buffer)
    slab = grid.slab(ctx["rank"], "cpu")
    tree = _tree(inp, "map/tree0")
    goal = torch.from_numpy(GRID_GOAL)
    out = {}
    for r, xr in enumerate(inp["map/table"]):
        rf(tree, slab, None, goal, torch.from_numpy(xr), None, None)
        out.update(_out(tree, f"r{r}"))
    return out


def case_dp_map(ctx):
    """``make_dp_map_round_body`` on the 2 x 2 (dp, map) mesh, two rounds
    from the tables (a row of them a dp rank); then eight rounds from each
    dp row's own generator, for the replicas."""
    from lqrrt_tpu_torch.parallel import map_sharded as pm
    from lqrrt_tpu_torch.parallel.mesh import axis_index
    from lqrrt_tpu_torch.parallel.sharded import rank_generator

    inp, mesh = ctx["inp"], ctx["mesh_dp_map"]
    prob, lqr = _common(inp, obstacles=False)
    occ, origin, res = grid_world()
    grid = pm.ShardedGrid(occ, origin, res, n_shards=2)
    slab = grid.slab(axis_index(mesh, "map"), "cpu")
    dp = axis_index(mesh, "dp")
    table = inp["dpmap/table"]
    free = lambda x, u: torch.ones(x.shape[:-1], dtype=torch.bool)  # noqa
    args = (_spec(MB, MCAP, MB), mesh, grid, prob["dynamics"], lqr,
            prob["erf"], free, TOL, prob["constraints"].goal_buffer)
    rf = pm.make_dp_map_round_body(*args, xrand_gen=_table_gen(table, dp))
    tree = _tree(inp, "dpmap/tree0")
    goal = torch.from_numpy(GRID_GOAL)
    out = {}
    for r in range(table.shape[0]):
        rf(tree, slab, None, goal, None, None, None)
        out.update(_out(tree, f"r{r}"))
    rf = pm.make_dp_map_round(*args)
    gen = rank_generator(5, mesh, "dp", "cpu")
    tree = _tree(inp, "dpmap/tree0")
    ss, gb = torch.from_numpy(GRID_SS), torch.tensor([0.3, 0.3, 0.0, 0.0])
    for _ in range(8):
        rf(tree, slab, gen, goal, ss, gb, goal)
    out.update(_out(tree, "replicas"))
    return out


def _planner(mesh, prob=None, **kw):
    import lqrrt_tpu_torch
    from lqrrt_tpu_torch.models import double_integrator as di

    prob = prob or di.default_problem()
    args = dict(horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                printing=False, batch_size=B, capacity=CAP, nn_block=BLK,
                saturate=prob["saturate"], seed=3, mesh=mesh, device="cpu")
    args.update(kw)
    return lqrrt_tpu_torch.Planner(prob["dynamics"], prob["lqr"],
                                   prob["constraints"], **args), prob


def _counted(n):
    """A clock that reads 0 for its first n calls, then 1e9."""
    calls = [0]

    def clock():
        calls[0] += 1
        return 0.0 if calls[0] <= n else 1e9
    return clock


def _plan_out(planner, prob, prefix, reached):
    xs = np.asarray(planner.x_seq, np.float32)
    feas = prob["constraints"].is_feasible(
        torch.from_numpy(xs[1:]), torch.from_numpy(planner.u_seq))
    st = planner.stats
    return {f"{prefix}/reached": np.array(reached),
            f"{prefix}/x_seq": xs,
            f"{prefix}/feasible": np.array(bool(feas.all())),
            f"{prefix}/rounds": np.array(st["rounds"]),
            f"{prefix}/restarts": np.array(st["restarts"]),
            f"{prefix}/nodes": np.array(st["nodes"])}


def case_planners(ctx):
    """``Planner(mesh=)`` replans on the double integrator: the fused
    restart path (gather), topk on the host loop, FPR with a kill on the
    last rank, and circle data through a 3-arg predicate."""
    from lqrrt_tpu_torch.constraints import Constraints
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.ops.collision import circles_free_data

    mesh, rank, world = ctx["mesh_dp"], ctx["rank"], ctx["world"]
    out = {}
    p, prob = _planner(mesh)
    p.sys_time = _counted(7)
    reached = p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                            specific_time=1.0)
    out.update(_plan_out(p, prob, "gather", reached))
    p, prob = _planner(mesh, collective="topk", topk=TOPK, refine=False,
                       rounds_per_chunk=4)
    p.sys_time = _counted(9)
    reached = p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                            specific_time=1.0)
    out.update(_plan_out(p, prob, "topk", reached))
    # FPR: a first plan, then a replan killed by the last rank after its
    # second chunk
    p, prob = _planner(mesh, FPR=0.2)
    p.sys_time = _counted(7)
    reached = p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                            specific_time=1.0)
    out.update(_plan_out(p, prob, "fpr", reached))
    calls = [0]

    def clock():
        calls[0] += 1
        if rank == world - 1 and calls[0] == 3:
            p.kill_update()
        return 0.0
    p.sys_time = clock
    reached = p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                            specific_time=1.0)
    out.update(_plan_out(p, prob, "fpr_kill", reached))
    # circles as data
    dprob = di.default_problem()
    centers, radii = dprob["obstacles"]
    lim = dprob["constraints"].is_feasible.parts[0]
    data_pred = circles_free_data(margin=0.1)
    dprob["constraints"] = Constraints(
        N_X, N_U, goal_buffer=dprob["constraints"].goal_buffer,
        is_feasible=lambda x, u, d: data_pred(x, u, d) & lim(x, u),
        feasibility_data={"centers": centers, "radii": radii})
    p, _ = _planner(mesh, dprob)
    p.sys_time = _counted(7)
    reached = p.update_plan(dprob["x0"], dprob["sample_space"],
                            goal_bias=0.2, specific_time=1.0)
    out.update(_plan_out(p, prob, "data", reached))
    return out


def case_agree(ctx):
    """Clocks that disagree: rank r's reads 0 for 3 + 4 r calls.  The
    ranks must stop at the same round, on both loops."""
    out = {}
    for label, kw in (("restart", {}), ("host", dict(refine=False,
                                                     rounds_per_chunk=2))):
        p, prob = _planner(ctx["mesh_dp"], **kw)
        p.sys_time = _counted(3 + 4 * ctx["rank"])
        p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                      specific_time=1.0, pruning=False)
        out[f"{label}/rounds"] = np.array(p.stats["rounds"])
    return out


def case_mesh2d(ctx):
    """The hosts x chips mesh: the candidates sharded over both dims."""
    from lqrrt_tpu_torch.parallel.mesh import make_mesh_2d

    mesh = make_mesh_2d(2, 2, device_type="cpu")
    p, prob = _planner(mesh, mesh_axis=("host", "dp"))
    p.sys_time = _counted(7)
    reached = p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                            specific_time=1.0)
    return _plan_out(p, prob, "mesh2d", reached)


def case_grid_planner(ctx):
    """``Planner(mesh=dp x map, feasibility_grid=...)`` through the wall's
    gap: the host loop with the restart stash (capacity 256, so trees
    fill every four rounds), prune and finish checked on the full grid."""
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.parallel.map_sharded import ShardedGrid

    prob = di.default_problem(obstacles=False)
    occ, origin, res = grid_world()
    grid = ShardedGrid(occ, origin, res, n_shards=2)
    p, _ = _planner(ctx["mesh_dp_map"], prob, horizon=1.0, capacity=256,
                    goal0=GRID_GOAL, feasibility_grid=grid, seed=4,
                    min_time=2.0, max_time=30.0, rounds_per_chunk=2,
                    informed_anneal=0.5)
    reached = p.update_plan(GRID_X0, GRID_SS, goal_bias=[0.3, 0.3, 0, 0],
                            pruning=True, finish_on_goal=True)
    out = _plan_out(p, prob, "grid", reached)
    out["grid/occupied"] = np.array(
        bool(grid.occupied_host(p.x_seq[:, :2]).any()))
    return out


def case_fleet(ctx):
    """``FleetPlanner(mesh=)``: 8 scenarios over 2 ranks, fixed rounds and
    a budget on clocks that disagree; per-scenario grids; the owned
    plans; the refusals."""
    from lqrrt_tpu_torch.models import double_integrator as di
    from lqrrt_tpu_torch.ops.collision import grid_free_data
    from lqrrt_tpu_torch.parallel import FleetPlanner
    from lqrrt_tpu_torch.parallel.mesh import make_fleet_mesh

    rank = ctx["rank"]
    mesh = make_fleet_mesh(2, device_type="cpu")
    prob = di.default_problem()
    S = 8
    kw = dict(horizon=1.0, dt=DT, n_scenarios=S, batch_size=16,
              capacity=128, nn_block=64, saturate=prob["saturate"],
              ncontrols=2, seed=5, mesh=mesh, device="cpu")
    fleet = FleetPlanner(prob["dynamics"], prob["lqr"], prob["erf"],
                         prob["constraints"].is_feasible,
                         prob["constraints"].goal_buffer, **kw)
    rng = np.random.default_rng(0)
    x0s = np.zeros((S, 4), np.float32)
    x0s[:, 1] = rng.uniform(-1, 1, S)
    goals = np.tile(prob["goal"], (S, 1))
    st = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.2,
                    rounds=6)
    out = {"fixed/sizes": st["sizes"], "fixed/goal_found": st["goal_found"],
           "fixed/local_sizes": fleet.trees.size.numpy(),
           "fixed/best": fleet.best_nodes()}
    plans = fleet.extract_plans()
    out["owned"] = np.array(sorted(plans))
    out["plan_starts"] = np.stack([plans[s][0] for s in sorted(plans)])
    other = (rank + 1) % 2 * 4
    try:
        fleet.extract_plans([other])
        out["refused"] = np.array("")
    except ValueError as e:
        out["refused"] = np.array(str(e))
    fleet.sys_time = _counted(9 - 5 * rank)   # the first rank's rules
    st = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.2,
                    rounds=64, max_time=1.0, rounds_per_chunk=2)
    out["budget/rounds"] = np.array(st["rounds"])
    # per-scenario grids: each scenario's own wall across y = 0
    occ = np.zeros((S, 32, 48), bool)
    for s in range(S):
        occ[s, :, 12 + s:14 + s] = True
    gfleet = FleetPlanner(prob["dynamics"], prob["lqr"], prob["erf"],
                          grid_free_data((-2.0, -4.0), 0.25),
                          prob["constraints"].goal_buffer,
                          per_scenario_data=True, **kw)
    gfleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.2, rounds=6,
                feasibility_data=occ)
    out["grid/state"] = gfleet.trees.state.numpy()
    out["grid/size"] = gfleet.trees.size.numpy()
    try:
        FleetPlanner(prob["dynamics"], prob["lqr"], prob["erf"],
                     prob["constraints"].is_feasible,
                     prob["constraints"].goal_buffer,
                     **dict(kw, n_scenarios=7))
        out["indivisible"] = np.array("")
    except ValueError as e:
        out["indivisible"] = np.array(str(e))
    return out


def case_refusals(ctx):
    """An indivisible batch and a missing axis raise on a 2-rank mesh."""
    out = {}
    for label, kw in (("batch", dict(batch_size=63)),
                      ("axis", dict(mesh_axis="nope"))):
        try:
            _planner(ctx["mesh_dp"], **kw)
            out[label] = np.array("")
        except ValueError as e:
            out[label] = np.array(str(e))
    return out


def assert_lockstep(got, want):
    """tests/test_torch_round.py's tolerances: size and goal_found equal;
    >= 99% of the rows with the same parent and edge length, and on those
    rows node times within 2e-7 relative, states and edges within 1e-3;
    in_goal and child counts equal on >= 99% of the rows."""
    want = {f: np.asarray(getattr(want, f)) for f in FIELDS}
    assert int(got["size"]) == int(want["size"])
    assert bool(got["goal_found"]) == bool(want["goal_found"])
    rows = (got["parent"] == want["parent"]) & (
        got["edge_len"] == want["edge_len"])
    assert rows.mean() >= 0.99, rows.mean()
    for f in ("in_goal", "n_children"):
        assert np.mean(got[f] == want[f]) >= 0.99, f
    np.testing.assert_allclose(got["node_time"][rows],
                               want["node_time"][rows], rtol=2e-7, atol=0)
    np.testing.assert_allclose(got["state"][rows], want["state"][rows],
                               atol=1e-3)
    np.testing.assert_allclose(got["edge_x"][:, :, rows],
                               want["edge_x"][:, :, rows], atol=1e-3)


def spawn(world: int, inputs: dict, cases, out_dir):
    """Start a ``world``-rank job on ``cases`` with ``inputs`` (numpy
    arrays by name) in the directory ``out_dir``; returns its processes."""
    path = os.path.join(out_dir, "inputs.npz")
    np.savez(path, **inputs)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), f"localhost:{port}",
         str(world), str(r), path, str(out_dir), ",".join(cases)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]


def collect(procs, out_dir, timeout: float):
    """Wait for a job (killing it past ``timeout`` seconds) and load each
    rank's results; raises with the ranks' output if one failed."""
    outs, t_end = [], time.time() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(t_end - time.time(),
                                                  1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise RuntimeError("the job timed out:\n" + "\n".join(
            o or "" for o in outs))
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(outs))
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(len(procs))]


def main():
    coordinator, world, rank, inputs, out_dir, cases = sys.argv[1:7]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    from lqrrt_tpu_torch.parallel import mesh as meshlib

    meshlib.init_distributed(coordinator, world, rank, device_type="cpu")
    import torch.distributed as dist

    assert dist.get_world_size() == world and dist.get_rank() == rank
    ctx = dict(inp=dict(np.load(inputs)), rank=rank, world=world)
    if world == 2:
        ctx["mesh_dp"] = meshlib.make_mesh(2, device_type="cpu")
        ctx["mesh_map"] = meshlib.make_mesh(2, axis="map", device_type="cpu")
    else:
        ctx["mesh_dp"] = meshlib.make_mesh(4, device_type="cpu")
        ctx["mesh_dp_map"] = meshlib.make_mesh_dp_map(2, 2, device_type="cpu")
    out = {}
    for case in cases.split(","):
        t0 = time.perf_counter()
        for k, v in globals()[f"case_{case}"](ctx).items():
            out[f"{case}/{k}"] = v
        print(f"rank {rank} {case} {time.perf_counter() - t0:.2f} s",
              flush=True)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    print(f"DONE {rank}", flush=True)


if __name__ == "__main__":
    main()
