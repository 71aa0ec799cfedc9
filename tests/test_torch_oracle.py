"""The port's numpy oracle (``lqrrt_tpu_torch/oracle/numpy_planner.py``):
output for output against the JAX package's on the same seeds, its
independent models against the port's, and the port's planner against it
(as ``tests/test_oracle.py`` holds the JAX package)."""
import numpy as np
import pytest
import scipy.linalg
import torch

import lqrrt_tpu_torch
from lqrrt_tpu.oracle import numpy_planner as joracle
from lqrrt_tpu_torch.models import boat, car, double_integrator as di
from lqrrt_tpu_torch.models import quadrotor
from lqrrt_tpu_torch.oracle import numpy_planner as oracle

torch.set_num_threads(2)


def _di_oracle(mod, goal_entry_trunc=False):
    A = np.zeros((4, 4)); A[0, 2] = A[1, 3] = 1.0
    B = np.zeros((4, 2)); B[2, 0] = B[3, 1] = 1.0
    Q = np.diag([1.0, 1.0, 0.3, 0.3]); R = 0.05 * np.eye(2)
    S = scipy.linalg.solve_continuous_are(A, B, Q, R)
    K = np.linalg.solve(R, B.T @ S)
    prob = di.default_problem()
    feas = mod.make_circle_feasibility(*prob["obstacles"], margin=0.1)
    orc = mod.NumpyOracle(
        dynamics=mod.di_dynamics, lqr=lambda x, u: (S, K),
        erf=np.subtract, is_feasible=feas,
        goal_buffer=prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"],
        saturate=lambda u: np.clip(u, -10, 10),
        goal_entry_trunc=goal_entry_trunc)
    return orc, prob, 0.15


def _boat_oracle(mod, goal_entry_trunc=False):
    prob = boat.default_problem()
    S, K = (np.asarray(t, np.float64) for t in prob["lqr"](
        torch.zeros(6), torch.zeros(3)))
    dyn, sat = mod.boat_dynamics_factory()
    feas = mod.make_circle_feasibility(*prob["obstacles"], margin=1.0)
    orc = mod.NumpyOracle(
        dynamics=dyn, lqr=lambda x, u: (S, K), erf=mod.boat_erf,
        is_feasible=feas, goal_buffer=prob["constraints"].goal_buffer,
        horizon=prob["horizon"], dt=prob["dt"], saturate=sat,
        goal_entry_trunc=goal_entry_trunc)
    return orc, prob, [0.3, 0.3, 0, 0, 0, 0]


@pytest.mark.parametrize("goal_entry_trunc", [False, True])
@pytest.mark.parametrize("model", ["double_integrator", "boat"])
def test_oracle_matches_jax_oracle(model, goal_entry_trunc):
    """The same seed and node budget give the same plan, bit for bit, and
    the same stats but for the clock's: the copy keeps the algorithm.  The
    plan stops at its first goal (``min_time`` 0) or at 300 nodes."""
    build = {"double_integrator": _di_oracle, "boat": _boat_oracle}[model]
    out = []
    for mod in (oracle, joracle):
        orc, prob, bias = build(mod, goal_entry_trunc)
        out.append(orc.plan(prob["x0"], prob["goal"], prob["sample_space"],
                            goal_bias=bias, seed=3, max_nodes=300,
                            max_time=1e9))
    (r, st, plan), (jr, jst, jplan) = out
    assert r == jr
    np.testing.assert_array_equal(plan, jplan)
    clock = ("elapsed_s", "expansions_per_s")
    assert ({k: v for k, v in st.items() if k not in clock}
            == {k: v for k, v in jst.items() if k not in clock})
    assert r or st["nodes"] == 300


@pytest.mark.parametrize("model", ["boat", "car", "quadrotor"])
def test_oracle_dynamics_match_the_port(model):
    """The oracle's independent numpy models against the port's."""
    port, lo, hi, ulo, uhi, tol = {
        "boat": (boat, -2, 2, -500, 500, 2e-4),
        "car": (car, -2, 2, -3, 3, 2e-4),
        "quadrotor": (quadrotor, -0.5, 0.5, -0.4, 0.4, 5e-4)}[model]
    dyn_np = getattr(oracle, f"{model}_dynamics_factory")()[0]
    rng = np.random.default_rng(7)
    x = rng.uniform(lo, hi, (20, port.NSTATES))
    u = rng.uniform(ulo, uhi, (20, port.NCONTROLS))
    got = port.dynamics(torch.as_tensor(x, dtype=torch.float32),
                        torch.as_tensor(u, dtype=torch.float32), 0.05)
    want = np.stack([dyn_np(a, b, 0.05) for a, b in zip(x, u)])
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_scipy_relinearized_lqr_matches_the_port_car():
    """The oracle's scipy CARE against the port's batched CARE at sample
    linearization points (disjoint solver stacks, the same math)."""
    _, _, f_np = oracle.car_dynamics_factory()

    def x_map(x):
        v = x[3]
        x = x.copy()
        x[3] = np.where(abs(v) < 0.8, -0.8 if v < 0 else 0.8, v)
        return x

    lqr_np = oracle.make_scipy_relinearized_lqr(
        f_np, np.diag([1.0, 1.0, 0.5, 0.3]), np.diag([0.5, 2.0]),
        u_eq=np.zeros(2), x_map=x_map)
    x = np.random.default_rng(3).uniform(-2, 2, (5, 4))
    S, K = car.make_lqr()(torch.as_tensor(x, dtype=torch.float32),
                          torch.zeros(5, 2))
    for i in range(5):
        S_np, K_np = lqr_np(x[i], None)
        np.testing.assert_allclose(S_np, S[i].numpy(), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(K_np, K[i].numpy(), rtol=2e-2, atol=2e-2)


def test_port_planner_matches_oracle_quality():
    """Both solve the double integrator's field; the port's plan (CPU,
    batch 64, capacity 2048) within 2x (+1 s) of the oracle's, the
    tolerance of ``tests/test_oracle.py``."""
    orc, prob, bias = _di_oracle(oracle)
    reached, st, plan = orc.plan(prob["x0"], prob["goal"],
                                 prob["sample_space"], goal_bias=bias,
                                 seed=1, max_time=20.0)
    assert reached, st
    e = np.abs(np.asarray(prob["goal"]) - plan[-1])
    assert np.all(e <= prob["constraints"].goal_buffer + 1e-9)
    p = lqrrt_tpu_torch.Planner(
        prob["dynamics"], prob["lqr"], prob["constraints"],
        horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
        erf=prob["erf"], min_time=0.0, max_time=20.0, printing=False,
        batch_size=64, capacity=2048, nn_block=256, seed=5,
        saturate=prob["saturate"], device="cpu")
    assert p.update_plan(prob["x0"], prob["sample_space"], goal_bias=bias)
    assert p.T <= 2.0 * st["plan_duration_s"] + 1.0
