"""The span recorder (``utils/timing.py`` ``PhaseTimer.span``) and the
spans inside the port's replan loops, rounds and fleet cycle, on the CPU:
the restart loops of the boat, the car and the quadrotor (the last two
with the per-node lqr's own spans inside ``round.endpoint``), the grid
boat's host loop and ``FleetPlanner.plan`` at small sizes.  Counts against the stats, the parent of each span, self
time, the ``overhead_*_s`` stats read from ``planner.post``, the ranges on
``torch.profiler``'s timeline, and no ``record_function`` without a
profiler."""
import numpy as np
import pytest
import torch

from lqrrt_tpu_torch import Planner
from lqrrt_tpu_torch.models import boat, car, quadrotor
from lqrrt_tpu_torch.parallel import FleetPlanner
from lqrrt_tpu_torch.utils.timing import NO_SPANS, PhaseTimer

torch.set_num_threads(2)

BIAS = [0.3, 0.3, 0, 0, 0, 0]
# system: (problem, goal bias) of the planner's replans
PROBLEMS = {
    "restart": (boat.default_problem, BIAS),
    "car_restart": (car.default_problem, [0.3, 0.3, 0, 0]),
    "quadrotor_restart": (quadrotor.default_problem, [0.3] * 3 + [0.0] * 9),
    "grid_host": (lambda: boat.default_problem(obstacle_model="grid"), BIAS),
}
SYSTEMS = [*PROBLEMS, "fleet"]
ROUND = ("round.sample", "round.nearest", "round.steer", "round.endpoint",
         "round.finish", "round.commit")
PLANNER_PARENTS = dict(
    {name: "planner.chunk" for name in ROUND},
    **{"planner.update_plan": None,
       "planner.chunk": "planner.update_plan",
       "planner.stats_wait": "planner.update_plan",
       "planner.post": "planner.update_plan",
       "planner.extract": "planner.post",
       "planner.prune": "planner.post",
       "planner.finish": "planner.post"})
RESTART_PARENTS = dict(PLANNER_PARENTS, **{"cycle.restart": "planner.chunk"})
LQR_PARENTS = {"lqr.linearize": "round.endpoint",
               "lqr.care": "round.endpoint"}
PARENTS = {
    "restart": RESTART_PARENTS,
    "car_restart": dict(RESTART_PARENTS, **LQR_PARENTS),
    "quadrotor_restart": dict(RESTART_PARENTS, **LQR_PARENTS),
    "grid_host": PLANNER_PARENTS,
    "fleet": dict({name: "fleet.chunk" for name in ROUND},
                  **{"fleet.plan": None, "fleet.seed": "fleet.plan",
                     "fleet.chunk": "fleet.plan",
                     "fleet.chunk_sync": "fleet.plan"}),
}


def _chunk_clock(n_chunks):
    """A clock that reads 0 for t0 and ``n_chunks`` budget checks."""
    calls = [0]

    def clock():
        calls[0] += 1
        return 0.0 if calls[0] <= n_chunks + 1 else 1e9
    return clock


def _run(system, horizon=None):
    """One replan (or fleet cycle) of ``system`` at a small size; returns
    (stats, spans, counted calls)."""
    calls = {"chunk": 0, "fetch": 0}
    if system == "fleet":
        prob = boat.default_problem()
        S = 8
        fleet = FleetPlanner(
            prob["dynamics"], prob["lqr"], prob["erf"],
            prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
            horizon=horizon or prob["horizon"], dt=prob["dt"],
            n_scenarios=S, batch_size=32, capacity=256, nn_block=64,
            saturate=prob["saturate"], wrap_dims=prob["wrap_dims"], seed=3,
            device="cpu")
        run = fleet._run_rounds

        def counted(*a):
            calls["chunk"] += 1
            return run(*a)
        fleet._run_rounds = counted
        st = fleet.plan(np.tile(prob["x0"], (S, 1)),
                        np.tile(prob["goal"], (S, 1)), prob["sample_space"],
                        0.25, rounds=6, max_time=1e9, rounds_per_chunk=2)
        return st, st["spans"], calls
    make_prob, bias = PROBLEMS[system]
    prob = make_prob()
    restart = system != "grid_host"
    kw = (dict(rounds_per_chunk=16) if restart
          else dict(refine=False, rounds_per_chunk=2))
    p = Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                horizon=horizon or prob["horizon"], dt=prob["dt"],
                goal0=prob["goal"], erf=prob["erf"], printing=False,
                batch_size=64, capacity=512, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], device="cpu", seed=0, **kw)
    # the restart loop: two chunks of two cycles; the host loop runs
    # until the tree is full
    p.sys_time = _chunk_clock(2) if restart else (lambda: 0.0)
    fetched = p._fetched

    def counted(pending):
        calls["fetch"] += 1
        return fetched(pending)
    p._fetched = counted
    p.update_plan(prob["x0"], prob["sample_space"], goal_bias=bias,
                  specific_time=1.0)
    st = p.stats
    per_chunk = (np.prod(p._restart_chunk_shape) if restart
                 else p.rounds_per_chunk)
    calls["chunk"] = st["rounds"] // per_chunk
    return st, st["spans"], calls


@pytest.fixture(scope="module")
def runs():
    return {}


def _get(runs, system):
    if system not in runs:
        runs[system] = _run(system)
    return runs[system]


# ------------------------------------------------------------ the recorder

def test_span_nesting_self_time_and_reset():
    sp = PhaseTimer()
    with sp.span("outer"):
        for _ in range(3):
            with sp.span("inner"):
                sum(range(1000))
    with sp.span("outer"):
        pass
    s = sp.span_summary()
    assert s["outer"]["count"] == 2 and s["inner"]["count"] == 3
    assert s["outer"]["parent"] is None and s["inner"]["parent"] == "outer"
    assert s["inner"]["self_s"] == s["inner"]["total_s"] > 0
    assert s["outer"]["self_s"] == pytest.approx(
        s["outer"]["total_s"] - s["inner"]["total_s"], abs=1e-9)
    assert 0 < sp.last_s("outer") < s["outer"]["total_s"]
    s["outer"]["count"] = 99                      # a fresh dict each call
    assert sp.span_summary()["outer"]["count"] == 2
    sp.reset()
    assert sp.span_summary() == {}


def test_span_records_when_the_block_raises():
    sp = PhaseTimer()
    with pytest.raises(ValueError):
        with sp.span("outer"):
            with sp.span("inner"):
                raise ValueError
    with sp.span("after"):
        pass
    s = sp.span_summary()
    assert s["inner"]["count"] == s["outer"]["count"] == 1
    assert s["after"]["parent"] is None


def test_no_spans_records_nothing():
    with NO_SPANS.span("round.steer"):
        with NO_SPANS.span("round.steer"):
            pass
    assert NO_SPANS.span_summary() == {}


def test_phase_api_is_kept_beside_spans():
    sp = PhaseTimer()
    with sp.phase("p"):
        with sp.span("s"):
            pass
    sp.add("p", 1.0)
    assert sp.summary()["p"]["count"] == 2
    assert "p" not in sp.span_summary() and "s" in sp.span_summary()


# ------------------------------------------------- spans of the planners

@pytest.mark.parametrize("system", SYSTEMS)
def test_span_counts_match_the_stats(runs, system):
    st, spans, calls = _get(runs, system)
    assert st["rounds"] > 0
    for name in ("round.sample", "round.nearest", "round.steer",
                 "round.endpoint", "round.finish", "round.commit"):
        assert spans[name]["count"] == st["rounds"], name
    if system == "fleet":
        assert spans["fleet.chunk"]["count"] == calls["chunk"] == 4
        # each chunk's fetch, and the final sizes' fetch
        assert spans["fleet.chunk_sync"]["count"] == calls["chunk"] + 1
        assert spans["fleet.plan"]["count"] == spans["fleet.seed"][
            "count"] == 1
        return
    assert spans["planner.chunk"]["count"] == calls["chunk"] >= 2
    assert spans["planner.stats_wait"]["count"] == calls["fetch"] >= 2
    assert spans["planner.update_plan"]["count"] == 1
    for name in ("planner.post", "planner.extract", "planner.prune",
                 "planner.finish"):
        assert spans[name]["count"] == 1, name
    if system.endswith("restart"):
        assert spans["cycle.restart"]["count"] == st["restarts"] == 4


@pytest.mark.parametrize("system", SYSTEMS)
def test_span_parents(runs, system):
    _, spans, _ = _get(runs, system)
    want = PARENTS[system]
    assert set(spans) == set(want)
    for name, parent in want.items():
        assert spans[name]["parent"] == parent, name


@pytest.mark.parametrize("system", SYSTEMS)
def test_self_time_and_children_fit(runs, system):
    """A span's time less its self time is its child spans' time: the
    whole of each child that runs only inside it, and at most the whole
    of one that also runs elsewhere (the per-node lqr, also called at the
    replan's seed).  Every moment inside a top span is some span's self
    time."""
    _, spans, _ = _get(runs, system)
    for name, s in spans.items():
        assert 0 <= s["self_s"] <= s["total_s"], name
        kids = [c for c in spans.values() if name in c["parents"]]
        alone = sum(c["total_s"] for c in kids if set(c["parents"]) == {name})
        shared = sum(c["total_s"] for c in kids
                     if set(c["parents"]) != {name})
        inside = s["total_s"] - s["self_s"]
        assert alone - 1e-6 <= inside <= alone + shared + 1e-6, name
    top = sum(s["total_s"] for s in spans.values() if s["parent"] is None)
    assert sum(s["self_s"] for s in spans.values()) == pytest.approx(
        top, abs=1e-6)


@pytest.mark.parametrize("system", ["restart", "grid_host"])
def test_overhead_stats_are_the_post_spans(runs, system):
    st, spans, _ = _get(runs, system)
    assert st["overhead_total_s"] == spans["planner.post"]["total_s"]
    for part in ("extract", "prune", "finish"):
        assert st[f"overhead_{part}_s"] == spans[f"planner.{part}"][
            "total_s"]
    assert st["overhead_total_s"] >= (st["overhead_extract_s"]
                                      + st["overhead_prune_s"]
                                      + st["overhead_finish_s"])


def _ranges(events, name):
    return [(e.start_ns(), e.end_ns()) for e in events if e.name() == name]


def _inside(inner, outers):
    return all(any(a <= s and e <= b for a, b in outers) for s, e in inner)


@pytest.mark.parametrize("system", SYSTEMS)
def test_spans_are_nested_profiler_ranges(system):
    """Under ``torch.profiler`` each span is a range on its timeline:
    ``round.steer`` inside the chunk, inside the replan or the cycle."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st, spans, _ = _run(system, horizon=1.0)
    # the profiler's own records (its parse into ``prof.events()`` takes a
    # minute at a per-node lqr's op count)
    events = prof.profiler.kineto_results.events()
    kinds = {e.name(): e.is_user_annotation() for e in events
             if e.name().startswith(("round.", "planner.", "fleet."))}
    assert kinds and not any(kinds.values()), kinds
    top, chunk = (("fleet.plan", "fleet.chunk") if system == "fleet"
                  else ("planner.update_plan", "planner.chunk"))
    steer = _ranges(events, "round.steer")
    assert len(steer) == st["rounds"]
    assert len(_ranges(events, top)) == 1
    assert len(_ranges(events, chunk)) == spans[chunk]["count"]
    assert _inside(steer, _ranges(events, chunk))
    assert _inside(_ranges(events, chunk), _ranges(events, top))
    if system != "fleet":
        assert _inside(_ranges(events, "planner.extract"),
                       _ranges(events, "planner.post"))


@pytest.mark.parametrize("system", SYSTEMS)
def test_no_record_function_without_a_profiler(monkeypatch, system):
    """No profiler range is entered while no profiler runs; and a span is
    never a user-scope ``record_function``, whose range the profiler
    would mirror over the device's kernels."""
    def boom(*a, **k):
        raise AssertionError("a profiler range entered with no profiler")
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    st, spans, _ = _run(system, horizon=1.0)
    assert spans["round.steer"]["count"] == st["rounds"] > 0


def test_spans_reset_each_replan_and_reach_on_replan():
    prob = boat.default_problem()
    p = Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                horizon=1.0, dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=False, batch_size=64,
                capacity=512, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], device="cpu", seed=0)
    seen = []
    p.on_replan = seen.append
    for _ in range(2):
        p.sys_time = _chunk_clock(1)
        p.update_plan(prob["x0"], prob["sample_space"], goal_bias=BIAS,
                      specific_time=1.0, pruning=False)
    assert len(seen) == 2
    for rec in seen:
        assert rec["spans"]["planner.update_plan"]["count"] == 1
        assert rec["spans"]["planner.chunk"]["count"] == 1
    assert p.stats["spans"] == seen[-1]["spans"]


def test_last_extract_timings_keep_their_keys():
    """``extract_plans`` times its parts as spans inside
    ``fleet.extract``; ``last_extract_timings`` keeps its keys and reads
    the last call's, not the sum over calls."""
    prob = boat.default_problem()
    S = 4
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=prob["dt"], n_scenarios=S, batch_size=16,
        capacity=128, nn_block=64, saturate=prob["saturate"],
        wrap_dims=prob["wrap_dims"], device="cpu")
    fleet.plan(np.tile(prob["x0"], (S, 1)), np.tile(prob["goal"], (S, 1)),
               prob["sample_space"], 0.25, rounds=2)
    for _ in range(3):
        fleet.extract_plans()
    tm = fleet.last_extract_timings
    assert set(tm) == {"chain_walk_s", "pair_build_s", "gather_transfer_s",
                       "transfer_bytes", "host_assembly_s"}
    spans = fleet._spans.span_summary()
    assert spans["fleet.extract"]["count"] == 3
    for part in ("chain_walk", "pair_build", "gather_transfer",
                 "host_assembly"):
        assert spans[f"fleet.{part}"]["parent"] == "fleet.extract"
        assert tm[f"{part}_s"] == round(fleet._spans.last_s(
            f"fleet.{part}"), 4)
    assert tm["transfer_bytes"] > 0
