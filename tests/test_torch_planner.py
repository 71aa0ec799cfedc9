"""The port's planner as a whole, on the CPU: the boat at
B=512, capacity=4096 (512 root-pad rows, as at full width), and the car
(a per-node lqr) at B=64, capacity=512, mirroring the JAX end-to-end checks
(tests/test_planner_e2e.py, tests/test_models.py)."""
import contextlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lqrrt_tpu
import lqrrt_tpu_torch
from lqrrt_tpu.models import boat as jboat
from lqrrt_tpu.ops import angles as jangles
from lqrrt_tpu_torch import Constraints
from lqrrt_tpu_torch.models import boat, car, quadrotor
from lqrrt_tpu_torch.ops.angles import make_erf

torch.set_num_threads(2)

BIAS = [0.3, 0.3, 0, 0, 0, 0]
REPO = Path(__file__).resolve().parents[1]


def _planner(prob, **kw):
    args = dict(horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=False, batch_size=512,
                capacity=4096, wrap_dims=prob["wrap_dims"],
                saturate=prob["saturate"], device="cpu", seed=0)
    args.update(kw)
    return lqrrt_tpu_torch.Planner(prob["dynamics"], prob["lqr"],
                                   prob["constraints"], **args)


@pytest.fixture(scope="module")
def planned():
    prob = boat.default_problem()
    planner = _planner(prob, nn_impl="nn_const")
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=BIAS, specific_time=2.0)
    return prob, planner, reached


def test_reaches_goal(planned):
    _, planner, reached = planned
    assert reached, planner.stats
    assert planner.plan_reached_goal and planner.nn_selected == "nn_const"
    assert planner.root_pad == 512 and planner._restart_chunk_shape == (1, 7)


def test_stats_keys_match_jax(planned):
    """The JAX planner's stats keys, and the port's own ``spans`` and
    ``tallies``: on the CPU every steer call takes the loop's route
    (``steer.scan``), one a round and the prune's one, and none takes
    kernel D (``steer.kernel``)."""
    _, planner, _ = planned
    assert set(planner.stats) - {"spans", "tallies"} == {
        "nodes", "tree_rows", "rounds", "restarts", "elapsed_s",
        "expansions", "expansions_per_s", "goal_found", "plan_steps",
        "plan_duration_s", "overhead_extract_s", "overhead_prune_s",
        "overhead_finish_s", "overhead_total_s", "total_s"}
    st = planner.stats
    assert "planner.update_plan" in st["spans"]
    assert set(st["tallies"]) == {"steer.scan"}
    assert st["tallies"]["steer.scan"] - st["rounds"] in (0, 1)
    assert st["rounds"] % 7 == 0 and st["expansions"] == st["rounds"] * 512
    assert st["plan_steps"] == len(planner.x_seq)
    assert st["plan_duration_s"] == pytest.approx(planner.T)


def test_plan_shape_and_start(planned):
    prob, planner, _ = planned
    assert planner.x_seq.shape[1] == 6 and len(planner.x_seq) > 1
    assert len(planner.u_seq) == len(planner.x_seq) - 1
    assert np.all(np.isfinite(planner.x_seq))
    np.testing.assert_allclose(planner.x_seq[0], prob["x0"], atol=1e-5)


def test_plan_feasible_and_ends_in_goal(planned):
    prob, planner, _ = planned
    feas = prob["constraints"].is_feasible(torch.from_numpy(planner.x_seq[1:]),
                                           torch.from_numpy(planner.u_seq))
    assert feas.all()
    e = np.abs(prob["goal"] - planner.x_seq[-1])
    assert np.all(e <= prob["constraints"].goal_buffer + 0.1), e


def test_plan_dynamically_consistent(planned):
    prob, planner, _ = planned
    x, u = planner.x_seq, planner.u_seq
    xn = prob["dynamics"](torch.from_numpy(x[:-1]), torch.from_numpy(u),
                          prob["dt"]).numpy()
    d = xn - x[1:]
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi    # stored psi wraps
    err = np.abs(d).max(1)
    assert np.median(err) < 1e-3 and err.max() < 0.2, err.max()


def test_get_state_and_effort_match_jax_across_the_seam():
    prob = boat.default_problem()
    tp = _planner(prob)
    jprob = jboat.default_problem()
    jp = lqrrt_tpu.Planner(jprob["dynamics"], jprob["lqr"],
                           jprob["constraints"], horizon=5.0, dt=0.05,
                           goal0=jprob["goal"], printing=False,
                           wrap_dims=(2,))
    x = np.zeros((4, 6), np.float32)
    x[:, 0] = [0.0, 0.1, 0.2, 0.3]
    x[:, 2] = [3.10, 3.13, -3.13, -3.10]
    u = np.arange(9, dtype=np.float32).reshape(3, 3)
    plan = (x, u, 0.05 * 3)
    tp._plan = jp._plan = plan
    for t in (-1.0, 0.0, 0.025, 0.06, 0.075, 0.11, 0.15, 9.0):
        np.testing.assert_allclose(tp.get_state(t), jp.get_state(t),
                                   atol=1e-6)
        np.testing.assert_allclose(tp.get_effort(t), jp.get_effort(t),
                                   atol=1e-6)
    mid = tp.get_state(0.075)            # between 3.13 and -3.13
    assert abs(abs(mid[2]) - np.pi) < 0.02


def test_no_plan_before_update():
    tp = _planner(boat.default_problem())
    with pytest.raises(RuntimeError):
        tp.get_state(0.0)
    assert tp.x_seq is None and tp.T == 0.0


def test_kill_update_preempts():
    prob = boat.default_problem()
    calls = []
    planner = _planner(prob, max_time=60.0, min_time=60.0)

    def clock():
        calls.append(1)
        if len(calls) == 3:              # after the first chunk's dispatch
            planner.kill_update()
        return time.time()

    planner.sys_time = clock
    t0 = time.time()
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=BIAS,
                        pruning=False)
    assert time.time() - t0 < 30.0
    assert planner.stats["rounds"] == 7          # exactly one chunk
    assert planner.x_seq is not None
    planner.unkill()
    assert not planner._killed


@contextlib.contextmanager
def _world1_mesh(kind):
    """A one-rank gloo world and a CPU mesh in it: 1-D "dp", or
    ("dp", "map") of 1 x 1 for a sharded grid."""
    import tempfile

    import torch.distributed as dist
    from lqrrt_tpu_torch.parallel import mesh as meshlib

    dist.init_process_group(
        "gloo", init_method=f"file://{tempfile.mktemp()}", world_size=1,
        rank=0)
    try:
        yield (meshlib.make_mesh(1, device_type="cpu") if kind == "dp" else
               meshlib.make_mesh_dp_map(1, 1, device_type="cpu"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw", [
    dict(refine=False), dict(refine_mode="leaf_rewire"),
    dict(max_nodes=1000), dict(mesh="dp", refine=False),
    dict(feasibility_grid="buoys", refine=False)])
def test_off_restart_path_raises(kw):
    """Off the restart path: refine=False, max_nodes below the capacity
    and refine_mode="leaf_rewire" plan through the host loop (grow chunks,
    then refine chunks for leaf_rewire once the tree is full; no restarts,
    max_nodes held at chunk granularity); so do a one-rank mesh with
    refine=False (the sharded grow body) and a feasibility_grid (the buoy
    field rasterised into a one-slab ShardedGrid on a 1 x 1 dp x map mesh,
    the constraints holding the circles as the local predicate), which
    raised before the mesh was ported."""
    prob = boat.default_problem()
    with contextlib.ExitStack() as stack:
        if "mesh" in kw:
            kw = dict(kw, mesh=stack.enter_context(_world1_mesh("dp")))
        if "feasibility_grid" in kw:
            from lqrrt_tpu_torch.parallel.map_sharded import ShardedGrid

            g = boat.buoy_grid(*prob["obstacles"])
            kw = dict(kw, mesh=stack.enter_context(_world1_mesh("map")),
                      feasibility_grid=ShardedGrid(g.occ, g.origin,
                                                   g.resolution, 1))
        _off_restart_path(prob, kw)


def _off_restart_path(prob, kw):
    planner = _planner(prob, nn_impl="nn_const", rounds_per_chunk=2, **kw)
    if "refine_mode" in kw:
        # a clock that holds still for 8 chunks: 7 rounds fill the 4096 rows
        # (512 of them root copies), the stats are a chunk stale, and then
        # refine chunks run on the full tree
        calls = []

        def clock():
            calls.append(1)
            return 0.0 if len(calls) <= 9 else 1e9
        planner.sys_time = clock
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=BIAS,
                        specific_time=1.0)
    st = planner.stats
    assert st["restarts"] == 0 and st["rounds"] % 2 == 0 and st["rounds"]
    kinds = [k[3] for k in planner._chunk_cache]
    assert kinds == (["grow", "refine"] if "refine_mode" in kw
                     else ["grow"]), kinds
    cap = min(planner.max_nodes, planner.capacity)
    assert st["tree_rows"] < cap + 2 * 2 * 512      # stats one chunk stale
    assert st["nodes"] <= st["tree_rows"]
    np.testing.assert_allclose(planner.x_seq[0], prob["x0"], atol=1e-5)
    feas = prob["constraints"].is_feasible(
        torch.from_numpy(planner.x_seq[1:]), torch.from_numpy(planner.u_seq))
    assert feas.all()
    if planner.feasibility_grid is not None:
        assert not planner.feasibility_grid.occupied_host(
            planner.x_seq[:, :2]).any()


def test_feasibility_data_raises():
    """A 3-arg is_feasible with feasibility_data plans (it raised before
    the host loop and the data path were ported): the boat's buoy field as
    circle data, a plan clear of every buoy."""
    from lqrrt_tpu_torch.ops.collision import circles_free_data

    prob = boat.default_problem()
    centers, radii = prob["obstacles"]
    prob["constraints"] = Constraints(
        6, 3, goal_buffer=prob["constraints"].goal_buffer,
        is_feasible=circles_free_data(margin=1.0),
        feasibility_data={"centers": centers, "radii": radii})
    planner = _planner(prob, nn_impl="nn_const")
    assert planner.update_plan(prob["x0"], prob["sample_space"],
                               goal_bias=BIAS, specific_time=2.0)
    d = np.linalg.norm(planner.x_seq[:, None, :2] - centers, axis=-1)
    assert (d > radii + 1.0).all()


def test_nn_selection():
    prob = boat.default_problem()
    p = _planner(prob)
    assert p._nearest_override() is None and p.nn_selected == "scan"
    p = _planner(prob, nn_impl="nn_const")
    assert p._nearest_override() is not None and p.nn_selected == "nn_const"
    assert p._lqr_is_constant()
    # a state-dependent lqr takes the general NN kernel (kernel C) ...
    S0, K0 = prob["lqr"](torch.zeros(6), torch.zeros(3))

    def lqr(x, u):
        s = 1.0 + x[..., :1, None] ** 2
        return S0 * s, K0.expand(x.shape[:-1] + K0.shape)
    for nn_impl in ("nn_general", "nn_const"):
        p = lqrrt_tpu_torch.Planner(
            prob["dynamics"], lqr, prob["constraints"], horizon=5.0,
            goal0=prob["goal"], erf=prob["erf"], batch_size=512,
            capacity=4096, device="cpu", nn_impl=nn_impl, printing=False)
        assert not p._lqr_is_constant()
        if nn_impl == "nn_general":
            assert p._nearest_override() is not None
            assert p.nn_selected == "nn_general"
        else:      # ... and cannot take the constant-metric one
            with pytest.raises(ValueError, match="nn_general"):
                p._nearest_override()
    # two wrapped angle dims are not affine for either kernel
    for nn_impl in ("nn_const", "nn_general"):
        p = _planner(prob, nn_impl=nn_impl, erf=make_erf(6, (1, 2)))
        with pytest.raises(ValueError, match="affine"):
            p._nearest_override()


# (JAX nn_impl, the port's) for the same choice
NN_NAMES = [("auto", "auto"), ("jnp", "scan"), ("pallas_const", "nn_const"),
            ("pallas", "nn_general")]


@pytest.mark.parametrize("erf_kind", ["subtract", "make_erf", "untagged",
                                      "two_wrapped"])
@pytest.mark.parametrize("names", NN_NAMES, ids=[n for _, n in NN_NAMES])
def test_nn_selection_matches_jax(erf_kind, names):
    """Fault 18: the NN choice follows the JAX planner's rule.  An erf the
    kernels cannot take (untagged, or two wrapped dims) takes the scan
    under "auto", also on the card path, and a forced kernel raises
    ValueError for it in both packages; "scan" (JAX "jnp") forces the
    scan.  The card path is the choice made for a CUDA device: the device
    is set after construction and the lqr probe, and the choice builds no
    kernel."""
    jimpl, impl = names
    jprob = jboat.default_problem()
    jerf, erf = {"subtract": (jnp.subtract, torch.subtract),
                 "make_erf": (jprob["erf"], make_erf(6, (2,))),
                 "untagged": (lambda a, b: a - b, lambda a, b: a - b),
                 "two_wrapped": (jangles.make_erf(6, (1, 2)),
                                 make_erf(6, (1, 2)))}[erf_kind]
    jp = lqrrt_tpu.Planner(jprob["dynamics"], jprob["lqr"],
                           jprob["constraints"], horizon=5.0,
                           goal0=jprob["goal"], erf=jerf, printing=False,
                           nn_impl=jimpl)
    p = _planner(boat.default_problem(), erf=erf, nn_impl=impl)
    assert p._lqr_is_constant()          # probed on the CPU, then cached
    p.device = torch.device("cuda")
    affine = erf_kind in ("subtract", "make_erf")
    if impl in ("nn_const", "nn_general") and not affine:
        for planner in (jp, p):
            with pytest.raises(ValueError, match="affine"):
                planner._nearest_override()
        return
    fn = p._nearest_override()
    if impl == "scan" or not affine:
        assert jp._nearest_override() is None
        assert fn is None and p.nn_selected == "scan"
    else:          # the boat's lqr is constant: "auto" takes nn_const
        assert fn is not None
        assert p.nn_selected == ("nn_general" if impl == "nn_general"
                                 else "nn_const")


def _linear_planner(n, lqr_kind, nn_impl):
    """A planner on CPU tensors for an n-state single integrator (x' = u,
    m = n) with S = I (constant) or S = (1 + x_0^2) I (per node)."""
    eye = torch.eye(n)

    def lqr(x, u):
        scale = (1.0 + x[..., :1, None] ** 2 if lqr_kind == "per_node"
                 else torch.ones(x.shape[:-1] + (1, 1)))
        return eye * scale, eye.expand(x.shape[:-1] + (n, n))

    cons = Constraints(nstates=n, ncontrols=n, goal_buffer=np.ones(n))
    return lqrrt_tpu_torch.Planner(
        lambda x, u, dt: x + dt * u, lqr, cons, horizon=1.0,
        goal0=np.ones(n), printing=False, batch_size=512, capacity=4096,
        device="cpu", nn_impl=nn_impl)


@pytest.mark.parametrize("lqr_kind", ["constant", "per_node"])
@pytest.mark.parametrize("n", [16, 17, 20, 21, 24])
def test_nn_selection_past_the_kernels_state_limit(n, lqr_kind):
    """Fault 22: nn_const takes at most ``_MAX_STATES`` (20) states, the
    JAX constant-metric kernel's limit, and nn_general up to
    ``_MAX_GENERAL_STATES`` (256).  On the card path (the device set after
    the lqr probe, as in ``test_nn_selection_matches_jax``) "auto" takes
    nn_const for a constant lqr up to 20 states and the plain scan above
    (where the JAX planner raises on a TPU), and nn_general for a
    per-node lqr at every n here; a forced kernel raises ValueError past
    its limit when the chunk is built, not at its first launch."""
    from lqrrt_tpu_torch.ops.kernels.nn_kernel import (_MAX_GENERAL_STATES,
                                                       _MAX_STATES)

    const = lqr_kind == "constant"
    assert _MAX_STATES == 20 and _MAX_GENERAL_STATES >= 24
    p = _linear_planner(n, lqr_kind, "auto")
    assert p._lqr_is_constant() == const
    p.device = torch.device("cuda")
    fn = p._nearest_override()
    if not const:
        assert fn is not None and p.nn_selected == "nn_general"
    elif n <= _MAX_STATES:
        assert fn is not None and p.nn_selected == "nn_const"
    else:
        assert fn is None and p.nn_selected == "scan"
    for impl in ("nn_const", "nn_general") if const else ("nn_general",):
        p = _linear_planner(n, lqr_kind, impl)
        assert p._lqr_is_constant() == const
        p.device = torch.device("cuda")
        if impl == "nn_general" or n <= _MAX_STATES:
            assert p._nearest_override() is not None
            assert p.nn_selected == impl
        else:
            with pytest.raises(ValueError, match="states"):
                p._get_restart_chunk(None, 0)
            assert p.nn_selected is None


@pytest.mark.parametrize("nn_impl", ["auto", "nn_general"])
def test_nn_general_past_its_state_limit(nn_impl, monkeypatch):
    """nn_general's own limit (``_MAX_GENERAL_STATES``, lowered here to
    20 so that a small model crosses it): "auto" then takes the scan for a
    per-node lqr and a forced nn_general raises when the chunk is built."""
    from lqrrt_tpu_torch.ops.kernels import nn_kernel

    monkeypatch.setattr(nn_kernel, "_MAX_GENERAL_STATES", 20)
    p = _linear_planner(21, "per_node", nn_impl)
    assert not p._lqr_is_constant()
    p.device = torch.device("cuda")
    if nn_impl == "auto":
        assert p._nearest_override() is None and p.nn_selected == "scan"
    else:
        with pytest.raises(ValueError, match="at most 20 states"):
            p._get_restart_chunk(None, 0)


def test_lqr_probe_treats_any_exception_as_not_constant():
    """Fault 18: an lqr that raises anything on the probe states is not
    constant, as in the JAX planner (which then takes the general
    kernel)."""
    prob = boat.default_problem()

    def lqr(x, u):
        if x.dim() == 1 and float(x[0]) != 0.0:
            raise KeyError("no gain here")
        return prob["lqr"](x, u)

    p = lqrrt_tpu_torch.Planner(
        prob["dynamics"], lqr, prob["constraints"], horizon=5.0,
        goal0=prob["goal"], erf=prob["erf"], device="cpu", printing=False)
    assert not p._lqr_is_constant()


# keyword -> (a value both constructors take, a value both refuse or warn
# on, what the refusal is), from lqrrt_tpu/planner.py:91-113, :272-280
KEYWORDS = {
    "steer_impl": ("auto", "pallas", ValueError),
    "collective": ("topk", "psum", ValueError),
    "informed_anneal": (1.0, 0.9, UserWarning),
    "mesh_axis": ("x", None, None),
    "topk": (64, None, None),
    "map_axis": ("m", None, None),
}


@pytest.mark.parametrize("kw", sorted(KEYWORDS))
def test_constructor_keywords_match_jax(kw):
    """Fault 19: the six keywords the JAX constructor takes, with its
    defaults and checks: a good value is taken (and stored, "auto" read as
    "scan"), a bad steer_impl or collective raises ValueError, and
    informed_anneal != 1.0 warns, in both packages."""
    import inspect
    import warnings

    good, bad, err = KEYWORDS[kw]
    jprob = jboat.default_problem()
    tprob = boat.default_problem()
    jsig = inspect.signature(lqrrt_tpu.Planner).parameters[kw]
    tsig = inspect.signature(lqrrt_tpu_torch.Planner).parameters[kw]
    assert tsig.default == jsig.default and tsig.kind == jsig.kind

    def make(which, value):
        if which == "jax":
            return lqrrt_tpu.Planner(
                jprob["dynamics"], jprob["lqr"], jprob["constraints"],
                horizon=5.0, goal0=jprob["goal"], printing=False,
                **{kw: value})
        return _planner(tprob, **{kw: value})

    for which in ("jax", "port"):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            p = make(which, good)
        stored = "scan" if kw == "steer_impl" else good
        assert getattr(p, kw) == stored
        if err is UserWarning:
            with pytest.warns(UserWarning, match="informed_anneal"):
                assert make(which, bad).informed_anneal == bad
        elif err is not None:
            with pytest.raises(err, match=kw):
                make(which, bad)


@pytest.mark.parametrize("model", [car, quadrotor])
def test_relinearized_models_select_nn_general(model):
    """The car's and the quadrotor's per-node lqr is not constant: "auto"
    takes nn_general wherever it takes a kernel (the JAX planner's
    "pallas" choice, tests/test_pallas_nn.py)."""
    prob = model.default_problem()
    p = _planner(prob, batch_size=8, capacity=128, nn_impl="nn_general")
    assert not p._lqr_is_constant()
    p._nearest_override()
    assert p.nn_selected == "nn_general"
    with pytest.raises(ValueError):
        _planner(prob, batch_size=8, capacity=128,
                 nn_impl="nn_const")._nearest_override()


@pytest.fixture(scope="module")
def car_planned():
    prob = car.default_problem()
    planner = _planner(prob, batch_size=64, capacity=512,
                       nn_impl="nn_general")
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=[0.3, 0.3, 0, 0],
                                  specific_time=3.0)
    return prob, planner, reached


def test_car_plan_reaches_goal_feasible_and_consistent(car_planned):
    prob, planner, reached = car_planned
    assert reached and planner.nn_selected == "nn_general", planner.stats
    x, u = planner.x_seq, planner.u_seq
    assert x.shape[1] == 4 and u.shape == (len(x) - 1, 2)
    np.testing.assert_allclose(x[0], prob["x0"], atol=1e-5)
    feas = prob["constraints"].is_feasible(torch.from_numpy(x[1:]),
                                           torch.from_numpy(u))
    assert feas.all()
    e = prob["goal"] - x[-1]
    e[2] = (e[2] + np.pi) % (2 * np.pi) - np.pi
    assert np.all(np.abs(e) <= prob["constraints"].goal_buffer + 0.1), e
    xn = prob["dynamics"](torch.from_numpy(x[:-1]), torch.from_numpy(u),
                          prob["dt"]).numpy()
    d = xn - x[1:]
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi    # stored theta wraps
    err = np.abs(d).max(1)
    assert np.median(err) < 1e-3 and err.max() < 0.2, err.max()


def test_car_tree_holds_per_node_metric(car_planned):
    """The best tree's rows carry their own (S, K), re-solved at each row's
    state: a row mix-up in commit, reseed or extract would show here."""
    prob, planner, _ = car_planned
    t = planner._device_tree
    size = int(t.size)
    rows = torch.arange(0, size, max(size // 16, 1))
    S, K = prob["lqr"](t.state[rows], torch.zeros(len(rows), 2))
    np.testing.assert_allclose(t.S[rows].numpy(), S.numpy(), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t.K[rows].numpy(), K.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert not np.allclose(t.S[rows[0]].numpy(), t.S[rows[-1]].numpy())
    # the extracted chain's gains are its nodes' own
    chain = planner._last_chain
    gains = planner._last_edges[1]
    np.testing.assert_array_equal(gains, t.K[chain].numpy())


def test_device_is_explicit():
    with pytest.raises(ValueError):
        _planner(boat.default_problem(), nn_impl="pallas")
    if torch.cuda.is_available():
        return                           # the card exists: cuda is valid
    with pytest.raises(RuntimeError, match="CUDA"):
        _planner(boat.default_problem(), device="cuda")


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, lqrrt_tpu_torch\n"
        "for m in pkgutil.walk_packages(lqrrt_tpu_torch.__path__, "
        "'lqrrt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = ['core.rewire', 'tree', 'utils.checkpoint', 'utils.metrics',"
        " 'utils.watchdog', 'utils.timing', 'runtime.trajectory_server',"
        " 'utils.device', 'oracle.numpy_planner', 'tools.exp_quality']\n"
        "missing = [m for m in new if 'lqrrt_tpu_torch.' + m not in "
        "sys.modules]\n"
        "assert not missing, missing\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'lqrrt_tpu' or k.startswith('lqrrt_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr
