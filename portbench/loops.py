"""The closed loops that drive ``lqrrt_tpu_torch`` through its public entry
points, one for each ``system`` a configuration names: "planner"
(``Planner.update_plan``) and "fleet" (``FleetPlanner.plan`` and
``extract_plans``).

Each builds the system from the configuration and the mix, warms it up on
the cell's own shapes, runs replans back to back until ``seconds`` have
passed (the last one ends the window), runs one more replan (or fleet
cycle) under the profiler when asked, and returns a ``RunData`` with every
replan's record and plans.
"""
from __future__ import annotations

import importlib
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import devtrace
from .traffic import GoalStream, scenario_shifts


@dataclass
class RunData:
    cfg: dict
    mix: dict
    system: str
    setup_s: float = 0.0
    window_s: float = 0.0
    replans: list = field(default_factory=list)   # the window's
    traced: list = field(default_factory=list)    # the traced replans'
    trace: Optional[devtrace.Trace] = None
    occ: Optional[np.ndarray] = None              # per-scenario rasters
    memory_peak_bytes: int = 0


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _problem(cfg: dict, mix: dict):
    """The program's problem for the configuration's model, checked
    against the configuration's numbers, so that a change of the program's
    scenario cannot pass for a change of speed."""
    mod = importlib.import_module(f"lqrrt_tpu_torch.models.{cfg['model']}")
    prob = mod.default_problem(obstacle_model=mix["obstacle_model"])
    f32 = np.float32
    want = {
        "x0": np.asarray(cfg["x0"], f32),
        "goal": np.asarray(cfg["goal"], f32),
        "sample_space": np.asarray(cfg["sample_space"], f32),
        "goal_buffer": np.asarray(cfg["goal_buffer"], f32),
        "centers": np.asarray(cfg["buoys"]["centers"], f32),
        "radii": np.asarray(cfg["buoys"]["radii"], f32),
    }
    have = {
        "x0": prob["x0"], "goal": prob["goal"],
        "sample_space": prob["sample_space"],
        "goal_buffer": prob["constraints"].goal_buffer,
        "centers": prob["obstacles"][0], "radii": prob["obstacles"][1],
    }
    for k, v in want.items():
        if not np.array_equal(np.asarray(have[k], f32), v):
            raise ValueError(f"the program's {cfg['model']} problem has "
                             f"another {k} than {cfg['name']}.json")
    if (prob["horizon"], prob["dt"]) != (cfg["horizon"], cfg["dt"]) or \
            tuple(prob["wrap_dims"]) != tuple(cfg["wrap_dims"]):
        raise ValueError(f"the program's {cfg['model']} problem has another "
                         f"horizon, dt or wrap dims than {cfg['name']}.json")
    return prob


def run_planner(cfg, mix, seed, seconds, trace, device,
                since_start) -> RunData:
    from lqrrt_tpu_torch import Planner
    prob = _problem(cfg, mix)
    pc = cfg["planner"]
    planner = Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=cfg["horizon"], dt=cfg["dt"], FPR=pc["FPR"],
        error_tol=cfg["error_tol"], erf=prob["erf"],
        min_time=mix["min_time"], max_time=mix["max_time"],
        goal0=np.asarray(cfg["goal"], np.float32), printing=False,
        batch_size=pc["batch_size"], capacity=pc["capacity"],
        wrap_dims=tuple(cfg["wrap_dims"]), seed=seed,
        saturate=prob["saturate"], rounds_per_chunk=pc["rounds_per_chunk"],
        refine_mode=pc["refine_mode"], device=device)
    x0 = np.asarray(cfg["x0"], np.float32)
    ss = np.asarray(cfg["sample_space"], np.float32)
    gb = np.asarray(cfg["goal_bias"], np.float32)
    goals = GoalStream(cfg, mix, seed)
    pruning = bool(mix["pruning"])
    planner.warmup(x0, ss, goal_bias=gb, pruning=pruning)
    _sync(device)
    run = RunData(cfg, mix, "planner")

    def replan():
        goal = goals.next_goal()
        planner.set_goal(goal)
        t0 = time.perf_counter()
        ok = planner.update_plan(x0, ss, goal_bias=gb, pruning=pruning)
        wall = time.perf_counter() - t0
        plan = dict(x=planner.x_seq, u=planner.u_seq, x0=x0, goal=goal,
                    claims_goal=bool(ok), scenario=None)
        return dict(wall_s=wall, ok=bool(ok), stats=dict(planner.stats),
                    plans=[plan])

    _window(run, replan, seconds, trace, since_start)
    run.memory_peak_bytes = _peak(device)
    del planner
    return run


def run_fleet(cfg, mix, seed, seconds, trace, device,
              since_start) -> RunData:
    from lqrrt_tpu_torch.parallel import FleetPlanner
    from lqrrt_tpu_torch.ops.collision import grid_free_data
    prob = _problem(cfg, mix)
    fc = cfg["fleet"]
    S = int(fc["n_scenarios"])
    run = RunData(cfg, mix, "fleet")
    data = None
    if mix.get("per_scenario_grids"):
        from .reference.plans import load_model
        run.occ = load_model(cfg).raster(scenario_shifts(mix, seed, S))
        data = run.occ
        g = cfg["grid"]
        pred = grid_free_data(np.asarray(g["origin"], np.float32),
                              float(g["resolution"]))
    elif mix["obstacle_model"] == "grid":
        raise ValueError("a fleet's grid takes per_scenario_grids")
    else:
        pred = prob["constraints"].is_feasible
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"], pred,
        np.asarray(cfg["goal_buffer"], np.float32), horizon=cfg["horizon"],
        dt=cfg["dt"], error_tol=cfg["error_tol"], n_scenarios=S,
        batch_size=fc["batch_size"], capacity=fc["capacity"],
        nn_block=fc["nn_block"], saturate=prob["saturate"],
        wrap_dims=tuple(cfg["wrap_dims"]), seed=seed,
        per_scenario_data=data is not None, device=device)
    x0s = np.tile(np.asarray(cfg["x0"], np.float32), (S, 1))
    ss = np.asarray(cfg["sample_space"], np.float32)
    gb = float(cfg["goal_bias"])
    goals = GoalStream(cfg, mix, seed)
    fleet.plan(x0s, goals.cycle_goals(S), ss, gb, rounds=1, max_time=1e9,
               rounds_per_chunk=1, feasibility_data=data)
    fleet.extract_plans()
    _sync(device)

    def cycle():
        goal = goals.cycle_goals(S)
        t0 = time.perf_counter()
        stats = fleet.plan(x0s, goal, ss, gb, rounds=fc["max_rounds"],
                           max_time=mix["max_time"],
                           rounds_per_chunk=fc["rounds_per_chunk"],
                           feasibility_data=data)
        t1 = time.perf_counter()
        got = fleet.extract_plans()
        t2 = time.perf_counter()
        found = np.asarray(stats["goal_found"], bool)
        plans = [dict(x=got.get(s), u=None, x0=x0s[s], goal=goal[s],
                      claims_goal=bool(found[s]),
                      scenario=s if data is not None else None)
                 for s in range(S)]
        return dict(wall_s=t2 - t0, extract_s=t2 - t1, stats=stats,
                    plans=plans)

    _window(run, cycle, seconds, trace, since_start)
    run.memory_peak_bytes = _peak(device)
    del fleet
    return run


def _window(run, replan, seconds, trace, since_start) -> None:
    """The window's replans from the end of set-up, and the traced one
    when asked."""
    t0 = time.perf_counter()
    run.setup_s = since_start()
    while not run.replans or time.perf_counter() - t0 < seconds:
        run.replans.append(replan())
    run.window_s = time.perf_counter() - t0
    if trace:
        out = []
        with devtrace.capture(out):
            run.traced.append(replan())
        run.trace = out[0]
        run.trace.rounds = run.traced[0]["stats"]["rounds"]


def _peak(device) -> int:
    import torch
    if torch.device(device).type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return int(torch.cuda.max_memory_allocated(device))


SYSTEMS = {"planner": run_planner, "fleet": run_fleet}
