"""A model past 16 states (fault 22): the double integrator stacked five
times (n = 20, the constant-metric NN kernel's limit), ``double_integrator.
stacked_problem`` in the port, built here from the JAX package's parts for
the reference: the dynamics and the lqr against JAX's, then replans on the
CPU in both packages at a small width."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lqrrt_tpu
import lqrrt_tpu_torch
from lqrrt_tpu.constraints import Constraints as JConstraints
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu.ops import collision as jcollision
from lqrrt_tpu.ops.integrate import discretize as jdiscretize
from lqrrt_tpu.ops.riccati import make_constant_lqr as jconstant_lqr
from lqrrt_tpu_torch.models import double_integrator as di

torch.set_num_threads(2)

COPIES = di.COPIES
SEEDS = (0, 1, 2)
BIAS = 0.5


def jax_stacked(k):
    """JAX's counterpart of ``di.stacked_problem()`` at k copies: copy
    i's state at dims 4i..4i+3 and effort at 2i..2i+1, the five circles on
    copy 0."""
    base = jdi.default_problem(obstacles=False)
    n, m = 4 * k, 2 * k

    def f(x, u):
        return jnp.concatenate([jnp.concatenate([x[4 * i + 2:4 * i + 4],
                                                 u[2 * i:2 * i + 2]])
                                for i in range(k)])

    eye = np.eye(k, dtype=np.float32)
    Q = np.kron(eye, np.diag(np.array([1.0, 1.0, 0.3, 0.3], np.float32)))
    R = np.kron(eye, 0.05 * np.eye(2, dtype=np.float32))
    centers, radii = jdi.default_problem()["obstacles"]
    c = base["constraints"]
    cons = JConstraints(
        nstates=n, ncontrols=m, goal_buffer=np.tile(c.goal_buffer, k),
        search_buffer=np.tile(c.search_buffer, (k, 1)),
        is_feasible=jcollision.all_of(
            jcollision.control_limits(-jdi.U_MAX * np.ones(m),
                                      jdi.U_MAX * np.ones(m)),
            jcollision.circles_free(centers, radii, margin=0.1)))
    return dict(dynamics=jdiscretize(f, "rk4"),
                lqr=jconstant_lqr(np.kron(eye, jdi.A), np.kron(eye, jdi.B),
                                  Q, R),
                constraints=cons, x0=np.tile(base["x0"], k),
                goal=np.tile(base["goal"], k),
                sample_space=np.tile(base["sample_space"], (k, 1)),
                horizon=base["horizon"], dt=base["dt"],
                saturate=jdi.saturate)


@pytest.fixture(scope="module")
def problems():
    return di.stacked_problem(), jax_stacked(COPIES)


def test_stacked_model_matches_jax(problems):
    """Dynamics, lqr, predicate, goal box and sample space: the port's
    stacked problem against the one built from JAX's parts."""
    prob, jprob = problems
    rng = np.random.default_rng(0)
    x = rng.uniform(-3, 3, (64, 4 * COPIES)).astype(np.float32)
    u = rng.uniform(-12, 12, (64, 2 * COPIES)).astype(np.float32)
    x[:8, :2] = prob["obstacles"][0][0]           # copy 0 in a circle
    u[:8] = 0.0
    got = prob["dynamics"](torch.as_tensor(x), torch.as_tensor(u), 0.05)
    want = np.stack([np.asarray(jprob["dynamics"](jnp.asarray(a),
                                                  jnp.asarray(b), 0.05))
                     for a, b in zip(x, u)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    S, K = prob["lqr"](torch.as_tensor(x[0]), torch.as_tensor(u[0]))
    jS, jK = jprob["lqr"](None, None)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=1e-5,
                               atol=1e-5)
    feas = prob["constraints"].is_feasible(torch.as_tensor(x),
                                           torch.as_tensor(u)).numpy()
    jfeas = np.array([bool(jprob["constraints"].is_feasible(
        jnp.asarray(a), jnp.asarray(b))) for a, b in zip(x, u)])
    np.testing.assert_array_equal(feas, jfeas)
    assert feas.any() and not feas.all()
    for key in ("x0", "goal", "sample_space"):
        np.testing.assert_array_equal(prob[key], jprob[key])
    np.testing.assert_array_equal(prob["constraints"].goal_buffer,
                                  jprob["constraints"].goal_buffer)


def test_stacked_replans_match_jax_goal_rate(problems):
    """n = 20 plans in both packages on the CPU (batch 256, capacity 2048,
    goal bias 0.5, stopping at the first goal within 120 s): the same goal
    rate over three fixed seeds, here every seed, and mean plan durations
    within 2x (+1 s) of each other, as the oracle comparison allows."""
    prob, jprob = problems
    common = dict(horizon=prob["horizon"], dt=prob["dt"],
                  goal0=prob["goal"], printing=False, batch_size=256,
                  capacity=2048, min_time=0.0, max_time=120.0)
    runs = {"port": [], "jax": []}
    for seed in SEEDS:
        p = lqrrt_tpu_torch.Planner(
            prob["dynamics"], prob["lqr"], prob["constraints"],
            erf=prob["erf"], saturate=prob["saturate"], device="cpu",
            seed=seed, **common)
        reached = p.update_plan(prob["x0"], prob["sample_space"],
                                goal_bias=BIAS)
        assert p.nn_selected == "scan"
        runs["port"].append((reached, p.T))
        jp = lqrrt_tpu.Planner(
            jprob["dynamics"], jprob["lqr"], jprob["constraints"],
            saturate=jprob["saturate"], seed=seed, **common)
        reached = jp.update_plan(jprob["x0"], jprob["sample_space"],
                                 goal_bias=BIAS)
        runs["jax"].append((reached, jp.T))
    rate = {k: sum(r for r, _ in v) for k, v in runs.items()}
    assert rate["port"] == rate["jax"] == len(SEEDS), runs
    mean = {k: np.mean([t for _, t in v]) for k, v in runs.items()}
    assert mean["port"] <= 2 * mean["jax"] + 1.0, runs
    assert mean["jax"] <= 2 * mean["port"] + 1.0, runs
