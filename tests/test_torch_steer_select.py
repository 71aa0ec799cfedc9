"""Which steer the planner runs (``core/steer.py`` ``steer_route``,
``make_routed_steer``), on the CPU: kernel D on a CUDA device wherever D's
factory takes the problem (the grid boat's raster among them), the plain
loop for every other problem, for the fleet's round (one goal a row) and
on the CPU.  Nothing is launched: D's device constants are copied at its
first CUDA call, and every call here is on CPU tensors, which run the
loop.  Then ``Planner.steer_selected`` and ``stats["steer_launches"]``, and
the raster as D reads it: its packed bits, its cell arithmetic emulated in
float32 numpy, and the launch's arguments."""
import numpy as np
import pytest
import torch

from lqrrt_tpu_torch import Planner
from lqrrt_tpu_torch.constraints import Constraints
from lqrrt_tpu_torch.core.rounds import RoundSpec, make_extend_stages
from lqrrt_tpu_torch.core.steer import (make_routed_steer, make_steer,
                                        steer_route)
from lqrrt_tpu_torch.models import boat, double_integrator
from lqrrt_tpu_torch.ops import collision
from lqrrt_tpu_torch.ops.kernels import _build, steer_kernel
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


def _buoy_grid(resolution=0.25):
    centers, radii = boat.default_problem()["obstacles"]
    return boat.buoy_grid(centers, radii, resolution)


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
    if case == "grid_footprint":
        feas = collision.all_of(_buoy_grid().feasibility(0.5))
    if case == "two_grids":
        feas = collision.all_of(_buoy_grid().feasibility(),
                                _buoy_grid(0.5).feasibility())
    if case == "grid_over_cap":
        # the buoys at 0.05 m: 480 x 1000 cells, past D's shared memory
        feas = collision.all_of(_buoy_grid(0.05).feasibility())
    return (prob["dynamics"], prob["lqr"], prob["erf"], feas,
            prob["saturate"], prob["constraints"].goal_buffer)


# case: (device, D's factory takes the problem, the route on that device)
CASES = {"boat_circles": ("cuda", True, "kernel"),
         "grid_boat": ("cuda", True, "kernel"),
         "grid_footprint": ("cuda", False, "scan"),
         "two_grids": ("cuda", False, "scan"),
         "grid_over_cap": ("cuda", False, "scan"),
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
                         [("circles", "kernel"), ("grid", "kernel")])
def test_steer_selected_on_a_cuda_planner(obstacle_model, selected):
    """``steer_selected`` on a CPU planner ("scan"), then with its device
    set to CUDA after its lqr probe (no card is here): kernel D for the
    boat's circles and for its raster."""
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


def _unpack(words, shape):
    """pack_grid's words back to an (H, W) bool raster."""
    bits = np.unpackbits(words.astype("<i4").view(np.uint8),
                         bitorder="little")
    return bits[:shape[0] * shape[1]].reshape(shape).astype(bool)


@pytest.mark.parametrize("shape", [(96, 200), (1, 1), (3, 11), (7, 32),
                                   (33, 31)])
def test_packed_raster_unpacks_to_occ(shape):
    """``pack_grid``: cell i = y W + x is bit i & 31 of word i >> 5, set
    where occupied, ceil(H W / 32) words, the padding free; the grid boat's
    raster (96 x 200) is 600 words."""
    occ = (_buoy_grid().occ if shape == (96, 200)
           else np.random.default_rng(sum(shape)).random(shape) < 0.4)
    words = steer_kernel.pack_grid(occ)
    assert words.dtype == np.int32 and words.shape == (-(-occ.size // 32),)
    np.testing.assert_array_equal(_unpack(words, occ.shape), occ)
    flat = occ.reshape(-1)
    i = np.arange(flat.size)
    w = words.view(np.uint32)
    np.testing.assert_array_equal((w[i >> 5] >> (i & 31)) & 1, flat)
    pad = np.unpackbits(words.view(np.uint8), bitorder="little")[flat.size:]
    assert not pad.any()
    if shape == (96, 200):
        assert len(words) == 600 and words.nbytes == 2400


def _kernel_grid_free(spec, x):
    """csrc/steer_rollout.cu ``grid_free`` in float32 numpy on the spec's
    words and transform: the cell floor((p - origin) * inv), the bounds on
    the float cell, then the word's bit."""
    W, H, ox, oy, inv = spec.grid_args
    words = spec.grid.value.view(np.uint32)
    f32 = np.float32
    with np.errstate(invalid="ignore"):
        cx = np.floor((x[:, 0] - f32(ox)) * f32(inv))
        cy = np.floor((x[:, 1] - f32(oy)) * f32(inv))
        inb = (cx >= 0) & (cx < f32(W)) & (cy >= 0) & (cy < f32(H))
    i = np.where(inb, np.where(inb, cy, 0).astype(np.int64) * W
                 + np.where(inb, cx, 0).astype(np.int64), 0)
    return inb & (((words[i >> 5] >> (i & 31)) & 1) == 0)


def test_kernel_cell_arithmetic_matches_the_predicate():
    """D's raster test, emulated in float32 numpy on what ``_Spec`` packs
    (words, W, H, origin and the float32 reciprocal of the resolution),
    equals the grid boat's predicate and ``OccupancyGrid.is_feasible`` on
    CPU tensors: at seeded positions over the raster and around it, on
    cell edges and just either side of them, on the raster's borders, far
    out of bounds, and at NaN (never free)."""
    prob = boat.default_problem(obstacle_model="grid")
    feas = prob["constraints"].is_feasible
    grid_pred = feas.parts[0]
    occ, origin, res = grid_pred.grid
    spec = steer_kernel._Spec(prob["dynamics"], prob["erf"], feas, H, DT,
                              TOL, prob["saturate"],
                              prob["constraints"].goal_buffer, 64)
    assert spec.grid_args == (200, 96, -4.0, -12.0, 4.0)
    rng = np.random.default_rng(11)
    x = np.zeros((20000, 6), np.float32)
    x[:8000, :2] = rng.uniform([-6.0, -14.0], [48.0, 14.0], (8000, 2))
    # cell edges: multiples of the resolution from the origin, and one ulp
    # either side
    edges = (origin + res * rng.integers(-2, 202, (4000, 2))).astype(
        np.float32)
    x[8000:12000, :2] = edges
    x[12000:16000, :2] = np.nextafter(edges, np.float32(-np.inf))
    x[16000:19000, :2] = np.nextafter(edges[:3000], np.float32(np.inf))
    x[19000:19100, :2] = [[-4.0, -12.0]] * 50 + [[46.0, 12.0]] * 50
    x[19100:19200, :2] = rng.uniform(-1e30, 1e30, (100, 2))
    x[19200:19300, 0] = np.nan
    x[19300:19400, 1] = np.nan
    x[19400:19500, :2] = np.inf
    want = grid_pred(torch.from_numpy(x), None).numpy()
    np.testing.assert_array_equal(
        _buoy_grid().is_feasible(torch.from_numpy(x), None).numpy(), want)
    np.testing.assert_array_equal(feas(torch.from_numpy(x), None).numpy(),
                                  want)
    np.testing.assert_array_equal(_kernel_grid_free(spec, x), want)
    assert not want[19200:19500].any() and want.any() and not want.all()


@pytest.mark.parametrize("obstacle_model", ["circles", "grid"])
def test_launch_passes_the_raster(obstacle_model, monkeypatch):
    """The arguments ``_Spec.launch`` hands ``lqrrt_steer_rollout``: as many
    as its C signature takes (the stream added by ``_launch``), the
    raster's words, W, H, origin and reciprocal after the box, or a null
    raster and zeros for the circles."""
    seen = []
    monkeypatch.setattr(steer_kernel, "_launch",
                        lambda name, *a: seen.append((name, a)))
    monkeypatch.setattr(steer_kernel, "sm_count", lambda dev: 132)
    monkeypatch.setattr(steer_kernel, "LAUNCHES",
                        dict.fromkeys(steer_kernel.VARIANTS, 0))
    prob = boat.default_problem(obstacle_model=obstacle_model)
    spec = steer_kernel._Spec(prob["dynamics"], prob["erf"],
                              prob["constraints"].is_feasible, H, DT, TOL,
                              prob["saturate"],
                              prob["constraints"].goal_buffer, 64)
    x0 = torch.zeros((B, 6))
    spec.launch(x0, torch.zeros((B, 3, 6)), None, x0.clone(),
                torch.zeros(6), "flat")
    (name, args), = seen
    assert name == "lqrrt_steer_rollout"
    assert len(args) + 1 == len(_build._SIGNATURES[name])
    grid, rest = args[12], args[13:18]
    if obstacle_model == "grid":
        occ = prob["constraints"].is_feasible.parts[0].grid[0]
        np.testing.assert_array_equal(grid.numpy(),
                                      steer_kernel.pack_grid(occ))
        assert grid.dtype == torch.int32
        assert rest == (200, 96, -4.0, -12.0, 4.0)
        assert args[10] == 0                       # no circles
    else:
        assert grid is None and rest == (0, 0, 0.0, 0.0, 0.0)
        assert args[10] == 7
