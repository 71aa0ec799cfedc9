"""Which steer the planner runs (``core/steer.py`` ``steer_route``,
``make_routed_steer``), on the CPU: kernel D on a CUDA device wherever D's
factory takes the problem, the plain loop for every other problem, for the
fleet's round (one goal a row) and on the CPU.  Nothing is launched: D's
device constants are copied at its first CUDA call, and every call here is
on CPU tensors, which run the loop.  Then ``Planner.steer_selected`` and
``stats["steer_launches"]``."""
import pytest
import torch

from lqrrt_tpu_torch import Planner
from lqrrt_tpu_torch.constraints import Constraints
from lqrrt_tpu_torch.core.rounds import RoundSpec, make_extend_stages
from lqrrt_tpu_torch.core.steer import (make_routed_steer, make_steer,
                                        steer_route)
from lqrrt_tpu_torch.models import boat, double_integrator
from lqrrt_tpu_torch.ops import collision
from lqrrt_tpu_torch.ops.kernels import steer_kernel
from lqrrt_tpu_torch.utils.timing import PhaseTimer

torch.set_num_threads(2)

BIAS = [0.3, 0.3, 0, 0, 0, 0]
H, DT, TOL, B = 20, 0.05, 0.05, 16


def _planner(prob, constraints=None, **kw):
    args = dict(horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=False, batch_size=64,
                capacity=512, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], device="cpu", seed=0)
    args.update(kw)
    return Planner(prob["dynamics"], prob["lqr"],
                   constraints or prob["constraints"], **args)


def _data_bound_predicate():
    """The boat's buoys through a 3-arg predicate and its data: the
    planner's 2-arg closure over its data tensors carries no tag."""
    prob = boat.default_problem()
    centers, radii = prob["obstacles"]
    cons = Constraints(6, 3, prob["constraints"].goal_buffer,
                       is_feasible=collision.circles_free_data(margin=1.0),
                       feasibility_data={"centers": centers,
                                         "radii": radii})
    p = _planner(prob, constraints=cons)
    p._load_feasibility_data()
    return p._feasibility()


def _problem(case):
    """(dynamics, lqr, erf, is_feasible, saturate, goal_buffer) of a
    case."""
    prob = boat.default_problem()
    if case == "grid_boat":
        prob = boat.default_problem(obstacle_model="grid")
    if case == "no_device_functions":
        prob = double_integrator.stacked_problem()
    feas = prob["constraints"].is_feasible
    if case == "data_bound_predicate":
        feas = _data_bound_predicate()
    return (prob["dynamics"], prob["lqr"], prob["erf"], feas,
            prob["saturate"], prob["constraints"].goal_buffer)


# case: (device, D's factory takes the problem, the route on that device)
CASES = {"boat_circles": ("cuda", True, "kernel"),
         "grid_boat": ("cuda", False, "scan"),
         "data_bound_predicate": ("cuda", False, "scan"),
         "per_row_goal": ("cuda", False, "scan"),
         "no_device_functions": ("cuda", False, "scan"),
         "cpu": ("cpu", True, "scan")}


@pytest.mark.parametrize("case", list(CASES))
def test_routed_steer_selection(case, monkeypatch):
    """The route on the case's device (``steer_route``), whether D's
    factory was built, and a call on CPU tensors: the loop's route in the
    tally and its result, bit for bit.  ``per_row_goal`` is the fleet's
    round: one goal a row builds the loop alone (``goal_rows``), and D's
    own steer rejects such a goal."""
    device, takes, route = CASES[case]
    dynamics, lqr, erf, feas, sat, gbuf = _problem(case)
    made = []

    def factory(*a, **kw):
        out = make_steer_kernel(*a, **kw)
        made.append(out)
        return out

    make_steer_kernel = steer_kernel.make_steer_kernel
    monkeypatch.setattr(steer_kernel, "make_steer_kernel", factory)
    n = len(gbuf)
    m = {6: 3, 20: 10}[n]
    timer = PhaseTimer()
    if case == "per_row_goal":
        spec = RoundSpec(nstates=n, ncontrols=m, batch=B, horizon_steps=H,
                         capacity=64, dt=DT)
        steer, _, _ = make_extend_stages(spec, dynamics, lqr, erf, feas, TOL,
                                         gbuf, saturate=sat, goal_rows=True,
                                         spans=timer)
    else:
        assert steer_route(dynamics, erf, feas, H, DT, TOL, saturate=sat,
                           goal_buffer=gbuf, device=device) == route
        made.clear()
        steer = make_routed_steer(dynamics, erf, feas, H, DT, TOL,
                                  saturate=sat, goal_buffer=gbuf, spans=timer)
    assert len(made) == takes

    gen = torch.Generator().manual_seed(7)
    x0 = torch.rand((B, n), generator=gen) * 2.0
    K = torch.rand((B, m, n), generator=gen) * 0.5
    xtar = x0 + torch.rand((B, n), generator=gen)
    goal = torch.full((n,), 1.0)
    if case == "per_row_goal":
        goal = goal.expand(B, n).contiguous()
        with pytest.raises(ValueError, match="goal"):
            make_steer_kernel(dynamics, erf, feas, H, DT, TOL, saturate=sat,
                              goal_buffer=gbuf)(x0, K, xtar, goal)
    res = steer(x0, K, xtar, goal)
    assert timer.tallies() == ({} if case == "per_row_goal"
                               else {"steer.scan": 1})
    ref = make_steer(dynamics, erf, feas, H, DT, TOL, saturate=sat,
                     goal_buffer=gbuf)(x0, K, xtar, goal)
    for name, a, b in zip(ref._fields, res, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("obstacle_model,selected",
                         [("circles", "kernel"), ("grid", "scan")])
def test_steer_selected_on_a_cuda_planner(obstacle_model, selected):
    """``steer_selected`` on a CPU planner ("scan"), then with its device
    set to CUDA after its lqr probe (no card is here): kernel D for the
    boat's circles, the plain loop for its raster."""
    prob = boat.default_problem(obstacle_model=obstacle_model)
    p = _planner(prob)
    assert p.steer_selected == "scan"
    p._lqr_is_constant()
    p.device = torch.device("cuda")
    assert p.steer_selected == selected


def test_steer_launches_counts_the_scan_route():
    """``stats["steer_launches"]`` on a CPU planner: every steer call of
    the replan on the loop's route, one a round (the spans' count of
    ``round.steer``) plus the prune's one batched steer; reset at each
    replan."""
    prob = boat.default_problem()
    p = _planner(prob)
    for _ in range(2):
        p.update_plan(prob["x0"], prob["sample_space"], goal_bias=BIAS,
                      specific_time=0.05, pruning=True)
        st = p.stats
        pruned = len(p._last_edges[0]) > 3
        assert st["spans"]["round.steer"]["count"] == st["rounds"] > 0
        assert st["steer_launches"] == {
            "kernel": 0, "scan": st["rounds"] + int(pruned)}
    assert p.steer_selected == "scan"
