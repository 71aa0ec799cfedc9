"""The port's planner on the double integrator (CPU), mirroring the JAX
end-to-end tests of tests/test_planner_e2e.py: ``max_nodes`` on the host
loop, FPR warm starts on the host loop, moving obstacles through
``Constraints.set_feasibility_data`` with no new chunk, and depth planting
on an instance deeper than one restart cycle.  The JAX and torch random
streams differ, so these check what the JAX tests check (goal, bounds,
clearance, cache entries), not the same trees."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lqrrt_tpu
from lqrrt_tpu.constraints import Constraints as JConstraints
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu.ops.collision import circles_free_data as jcircles_free_data
from lqrrt_tpu_torch import Constraints, Planner
from lqrrt_tpu_torch.models import double_integrator as di
from lqrrt_tpu_torch.ops.collision import circles_free_data

torch.set_num_threads(2)


def _planner(prob, constraints=None, **kw):
    args = dict(horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                erf=prob["erf"], printing=False, device="cpu")
    args.update(kw)
    return Planner(prob["dynamics"], prob["lqr"],
                   constraints or prob["constraints"], **args)


def _jax_feasible(x, data):
    pred = jcircles_free_data(margin=0.05)
    return np.asarray(jax.vmap(lambda xi: pred(xi, None, data))(
        jnp.asarray(x)))


def _check_plan(prob, planner, feas=None):
    """Starts at x0, every state and effort feasible, dynamically
    consistent."""
    x, u = planner.x_seq, planner.u_seq
    np.testing.assert_allclose(x[0], prob["x0"], atol=1e-5)
    feas = feas or prob["constraints"].is_feasible
    assert feas(torch.from_numpy(x[1:]), torch.from_numpy(u)).all()
    xn = prob["dynamics"](torch.from_numpy(x[:-1]), torch.from_numpy(u),
                          prob["dt"]).numpy()
    err = np.abs(xn - x[1:]).max(1)
    assert np.median(err) < 1e-3 and err.max() < 0.2, err.max()


def test_max_nodes_respected():
    """test_planner_e2e.py::test_max_nodes_respected: max_nodes below the
    capacity takes the host loop, which holds it at chunk granularity."""
    prob = di.default_problem()
    planner = _planner(prob, min_time=0.0, max_time=30.0, max_nodes=200,
                       batch_size=32, capacity=1024, nn_block=256)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.0,
                        pruning=False)
    assert planner.stats["restarts"] == 0 and planner.x_seq is not None
    assert list(planner._chunk_cache)[0][3] == "grow"
    assert planner.stats["nodes"] <= (
        200 + planner.batch_size * planner.rounds_per_chunk)
    assert planner.stats["tree_rows"] < planner.capacity


def test_fpr_warm_start_replans_on_the_host_loop():
    """test_planner_e2e.py::test_fpr_warm_start_replans on the host loop
    (refine=False): the first replan (a straight-line pseudo-plan) and a
    warm replan from 1 s along the plan reach the goal from ONE chunk."""
    prob = di.default_problem()
    planner = _planner(prob, min_time=0.0, max_time=20.0, FPR=0.4,
                       batch_size=64, capacity=1024, nn_block=256, seed=11,
                       saturate=prob["saturate"], refine=False)
    assert planner._nearest_override() is None     # "auto" on the CPU
    r1 = planner.update_plan(prob["x0"], prob["sample_space"],
                             goal_bias=0.15)
    assert r1, planner.stats
    assert planner.stats["restarts"] == 0
    first_plan = planner.x_seq.copy()
    x1 = planner.get_state(1.0)
    r2 = planner.update_plan(x1, prob["sample_space"], goal_bias=0.15)
    assert r2, planner.stats
    assert len(planner._chunk_cache) == 1
    assert list(planner._chunk_cache)[0][2] == round(0.4 * 64)   # n_fpr
    assert planner.x_seq is not first_plan
    np.testing.assert_allclose(planner.x_seq[0], x1, atol=1e-5)


def test_dynamic_obstacles_zero_recompile():
    """test_planner_e2e.py::test_dynamic_obstacles_zero_recompile: the
    buoy moves between two replans through set_feasibility_data; the chunk
    cache gains no entry, the data tensors keep their addresses, and each
    plan keeps clear of the field then in force."""
    prob = di.default_problem(obstacles=False)
    data0 = {"centers": np.array([[1.5, 0.0]], np.float32),
             "radii": np.array([0.6], np.float32)}
    cons = Constraints(nstates=4, ncontrols=2,
                       goal_buffer=prob["constraints"].goal_buffer,
                       is_feasible=circles_free_data(margin=0.05),
                       feasibility_data=data0)
    planner = _planner(prob, cons, batch_size=64, capacity=512, nn_block=128,
                       saturate=prob["saturate"], seed=2)

    def min_clearance(c, r):
        d = np.linalg.norm(planner.x_seq[:, :2] - c, axis=1) - r
        return d.min()

    assert planner.update_plan(prob["x0"], prob["sample_space"],
                               goal_bias=0.2, pruning=True,
                               specific_time=2.0)
    keys = list(planner._chunk_cache)
    assert len(keys) == 1 and keys[0][3] == "restart"
    assert min_clearance(data0["centers"][0], 0.6) > 0.0
    bufs = planner._feas_bufs[planner._feas_sig]
    ptrs = {k: v.data_ptr() for k, v in bufs.items()}

    data1 = {"centers": np.array([[1.5, 0.35]], np.float32),
             "radii": np.array([0.7], np.float32)}
    cons.set_feasibility_data(data1)
    assert planner.update_plan(prob["x0"], prob["sample_space"],
                               goal_bias=0.2, pruning=True,
                               specific_time=2.0)
    assert list(planner._chunk_cache) == keys          # no new chunk
    assert planner._feas_bufs[planner._feas_sig] is bufs
    assert {k: v.data_ptr() for k, v in bufs.items()} == ptrs
    np.testing.assert_array_equal(bufs["centers"].numpy(), data1["centers"])
    assert min_clearance(data1["centers"][0], 0.7) > 0.0
    assert planner.plan_reached_goal
    _check_plan(prob, planner,
                lambda x, u: cons.is_feasible(x, u, {
                    k: torch.from_numpy(v) for k, v in data1.items()}))


def test_feasibility_data_shape_change_builds_a_new_chunk():
    """A change of the data's shape builds a new chunk, as a retrace does
    in JAX; going back to the first shape reuses the first chunk and its
    tensors."""
    prob = di.default_problem(obstacles=False)
    one = {"centers": np.array([[5.0, 0.0]], np.float32),
           "radii": np.array([0.5], np.float32)}
    two = {"centers": np.array([[5.0, 0.0], [7.0, 1.0]], np.float32),
           "radii": np.array([0.5, -1.0], np.float32)}
    cons = Constraints(4, 2, goal_buffer=prob["constraints"].goal_buffer,
                       is_feasible=circles_free_data(), feasibility_data=one)
    planner = _planner(prob, cons, batch_size=64, capacity=512, nn_block=128,
                       saturate=prob["saturate"], refine=False)
    sigs = []
    for data in (one, two, one):
        cons.set_feasibility_data(data)
        planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                            pruning=False, specific_time=0.05)
        sigs.append(planner._feas_sig)
    assert sigs[0] == sigs[2] != sigs[1]
    assert len(planner._chunk_cache) == 2 and len(planner._feas_bufs) == 2


def test_feasibility_data_requires_ctor():
    """test_planner_e2e.py::test_feasibility_data_requires_ctor, on both
    packages' Constraints."""
    for C in (Constraints, JConstraints):
        cons = C(nstates=4, ncontrols=2, goal_buffer=np.ones(4))
        with pytest.raises(ValueError, match="feasibility_data"):
            cons.set_feasibility_data({"x": np.zeros(3)})


def test_feasibility_data_predicate_matches_jax():
    """The dynamic-obstacle constraints of the JAX test and the port's
    agree on every point of a seeded batch (with and without the moved
    buoy)."""
    rng = np.random.default_rng(4)
    x = rng.uniform([-1, -2, -3, -3], [4, 2, 3, 3], (2048, 4)).astype(
        np.float32)
    for c, r in (([1.5, 0.0], 0.6), ([1.5, 0.35], 0.7)):
        data = {"centers": np.array([c], np.float32),
                "radii": np.array([r], np.float32)}
        want = _jax_feasible(x, data)
        got = circles_free_data(margin=0.05)(
            torch.from_numpy(x), None,
            {k: torch.from_numpy(v) for k, v in data.items()}).numpy()
        assert 0 < want.sum() < len(want)
        np.testing.assert_array_equal(got, want)


def test_depth_planting_solves_deep_instance():
    """test_planner_e2e.py::test_depth_planting_solves_deep_instance: two
    edge generations a restart cycle (batch 128, capacity 256), a short
    horizon and a goal 30 m away; the reseed's planted chains carry depth
    across cycles, so the committed plan is deeper than one cycle."""
    prob = di.default_problem()
    goal = prob["goal"].copy()
    goal[0] = 30.0
    ss = prob["sample_space"].copy()
    ss[0] = [-1.0, 33.0]
    calls = {"n": 0}

    def clock():                          # call-counted budget: 30 chunks
        calls["n"] += 1
        return 0.0 if calls["n"] <= 30 else 1e9

    planner = _planner(prob, horizon=1.0, goal0=goal, batch_size=128,
                       capacity=256, nn_block=128, seed=11,
                       saturate=prob["saturate"], rounds_per_chunk=4)
    planner.sys_time = clock
    reached = planner.update_plan(prob["x0"], ss, goal_bias=0.2,
                                  pruning=False)
    assert reached, planner.stats
    assert planner._restart_chunk_shape == (2, 2)
    assert planner.stats["plan_duration_s"] > 2 * planner.horizon


def test_untagged_erf_plans_with_the_scan():
    """Fault 18's path end to end: an erf that is neither subtract nor
    tagged by make_erf plans through the blocked scan, as the JAX planner
    does (its "auto" returns no kernel there)."""
    prob = di.default_problem()
    planner = _planner(prob, erf=lambda a, b: a - b, batch_size=64,
                       capacity=512, nn_block=128, seed=3,
                       saturate=prob["saturate"])
    jprob = jdi.default_problem()
    jp = lqrrt_tpu.Planner(jprob["dynamics"], jprob["lqr"],
                           jprob["constraints"], horizon=2.0,
                           goal0=jprob["goal"], erf=lambda a, b: a - b,
                           printing=False, batch_size=64, capacity=512)
    assert jp._nearest_override() is None
    assert planner.update_plan(prob["x0"], prob["sample_space"],
                               goal_bias=0.2, specific_time=2.0)
    assert planner.nn_selected == "scan"
    _check_plan(prob, planner)
