"""The port's car and quadrotor models against the JAX package on the same
numpy inputs (CPU), with the sanity checks of tests/test_models.py."""
import numpy as np
import pytest
import torch

import jax

from lqrrt_tpu.models import car as jcar
from lqrrt_tpu.models import quadrotor as jquad
from lqrrt_tpu.ops import collision as jcollision
from lqrrt_tpu_torch.models import car, quadrotor
from lqrrt_tpu_torch.ops import collision

torch.set_num_threads(2)

# f32 on both sides with the same formulas; trig ulps differ by library
RTOL, ATOL = 1e-5, 1e-5
MODELS = {"car": (jcar, car), "quadrotor": (jquad, quadrotor)}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _batch(jm, seed, B=128):
    """States across the sample space (and past it), controls across and
    past the actuation limits."""
    ss = jm.default_problem()["sample_space"]
    rng = np.random.default_rng(seed)
    lo, hi = ss[:, 0], ss[:, 1]
    x = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo),
                    (B, len(ss))).astype(np.float32)
    u = rng.uniform(1.3 * jm.U_MIN, 1.3 * jm.U_MAX_VEC,
                    (B, len(jm.U_MIN))).astype(np.float32)
    return x, u


@pytest.mark.parametrize("model", ["car", "quadrotor"])
def test_callbacks_match(model):
    jm, tm = MODELS[model]
    x, u = _batch(jm, 1)
    jprob, tprob = jm.default_problem(), tm.default_problem()
    np.testing.assert_allclose(tm.f(_t(x), _t(u)).numpy(),
                               np.asarray(jax.vmap(jm.f)(x, u)),
                               rtol=RTOL, atol=ATOL)
    want = np.asarray(jax.vmap(lambda a, b: jm.dynamics(a, b, 0.05))(x, u))
    np.testing.assert_allclose(tm.dynamics(_t(x), _t(u), 0.05).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tm.saturate(_t(u)).numpy(),
                                  np.asarray(jax.vmap(jm.saturate)(u)))
    g = np.asarray(jprob["goal"])
    np.testing.assert_allclose(
        tprob["erf"](_t(g), _t(x)).numpy(),
        np.asarray(jax.vmap(jprob["erf"], in_axes=(None, 0))(g, x)),
        rtol=RTOL, atol=ATOL)
    assert tprob["erf"].angle_dims == jprob["erf"].angle_dims
    # feasibility across the obstacle field and the actuation box
    ss = jprob["sample_space"]
    x[:, 0] = np.linspace(ss[0, 0], ss[0, 1], len(x))
    x[:, 1] = np.linspace(ss[1, 0], ss[1, 1], len(x))[::-1]
    want_f = np.asarray(jax.vmap(jprob["constraints"].is_feasible)(x, u))
    assert 0 < want_f.sum() < len(want_f)
    np.testing.assert_array_equal(
        tprob["constraints"].is_feasible(_t(x), _t(u)).numpy(), want_f)
    for k in ("x0", "goal", "sample_space", "horizon", "dt", "wrap_dims"):
        np.testing.assert_array_equal(np.asarray(tprob[k]),
                                      np.asarray(jprob[k]))
    for a, b in zip(tprob["obstacles"], jprob["obstacles"]):
        np.testing.assert_array_equal(a, b)
    for k in ("goal_buffer", "search_buffer"):
        np.testing.assert_array_equal(getattr(tprob["constraints"], k),
                                      getattr(jprob["constraints"], k))


def test_control_limits_matches():
    lo = np.array([-1.0, -2.0], np.float32)
    hi = np.array([1.0, 0.5], np.float32)
    rng = np.random.default_rng(2)
    u = rng.uniform(-2.5, 2.5, (256, 2)).astype(np.float32)
    u[:2] = [lo, hi]                                 # the box is closed
    x = np.zeros((256, 4), np.float32)
    want = np.asarray(jax.vmap(jcollision.control_limits(lo, hi))(x, u))
    assert 0 < want.sum() < len(want) and want[:2].all()
    np.testing.assert_array_equal(
        collision.control_limits(lo, hi)(_t(x), _t(u)).numpy(), want)


def test_rotation_matrix_matches():
    rng = np.random.default_rng(4)
    rpy = rng.uniform(-np.pi, np.pi, (32, 3)).astype(np.float32)
    R = quadrotor._rpy_to_R(_t(rpy)).numpy()
    np.testing.assert_allclose(R, np.asarray(jax.vmap(jquad._rpy_to_R)(rpy)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


def test_quadrotor_hover_equilibrium():
    x0 = torch.zeros(12)
    x0[2] = 2.0
    # u = 0 is hover: the thrust channel is a deviation from m*g
    np.testing.assert_allclose(quadrotor.f(x0, torch.zeros(4)).numpy(), 0.0,
                               atol=1e-5)
    # gimbal guard: pitch past 90 degrees stays finite
    x = torch.zeros(12)
    x[4] = np.pi / 2
    x[9:] = 1.0
    assert torch.isfinite(quadrotor.f(x, torch.zeros(4))).all()


def test_car_dynamics_nonholonomic():
    # zero speed: no lateral motion possible
    xd = car.f(torch.zeros(4), torch.tensor([0.0, 0.5]))
    np.testing.assert_allclose(xd[:3].numpy(), 0.0, atol=1e-7)
    # forward at heading 0 moves +x
    xd = car.f(torch.tensor([0.0, 0.0, 0.0, 2.0]), torch.zeros(2))
    assert float(xd[0]) > 0 and abs(float(xd[1])) < 1e-6


def test_double_integrator_matches():
    """The double integrator's f, dynamics (RK4), saturate, erf, constant
    lqr and problem against the JAX model: f32 on both sides with the
    same formulas (RTOL, ATOL); saturate and feasibility exactly."""
    from lqrrt_tpu.models import double_integrator as jdi
    from lqrrt_tpu_torch.models import double_integrator as di

    rng = np.random.default_rng(6)
    x = rng.uniform(-12.0, 12.0, (256, 4)).astype(np.float32)
    u = rng.uniform(-15.0, 15.0, (256, 2)).astype(np.float32)
    np.testing.assert_allclose(di.f(_t(x), _t(u)).numpy(),
                               np.asarray(jax.vmap(jdi.f)(x, u)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        di.dynamics(_t(x), _t(u), 0.05).numpy(),
        np.asarray(jax.vmap(lambda a, b: jdi.dynamics(a, b, 0.05))(x, u)),
        rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(di.saturate(_t(u)).numpy(),
                                  np.asarray(jax.vmap(jdi.saturate)(u)))
    np.testing.assert_array_equal(di.A, jdi.A)
    np.testing.assert_array_equal(di.B, jdi.B)
    assert di.U_MAX == jdi.U_MAX
    g = np.array([10.0, 0.0, 0.0, 0.0], np.float32)
    np.testing.assert_array_equal(
        di.erf(_t(g), _t(x)).numpy(),
        np.asarray(jax.vmap(jdi.erf, in_axes=(None, 0))(g, x)))
    for kw in ({}, dict(q_pos=2.0, q_vel=0.5, r=0.1)):
        S, K = di.make_lqr(**kw)(_t(x[:3]), _t(u[:3]))
        jS, jK = (np.asarray(a) for a in jdi.make_lqr(**kw)(x[0], u[0]))
        np.testing.assert_allclose(S.numpy(), np.broadcast_to(jS, S.shape),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(K.numpy(), np.broadcast_to(jK, K.shape),
                                   rtol=RTOL, atol=ATOL)
    for obstacles in (True, False):
        jprob = jdi.default_problem(obstacles)
        tprob = di.default_problem(obstacles)
        x[:, 0] = np.linspace(-1.0, 11.0, len(x))
        x[:, 1] = rng.uniform(-4.0, 4.0, len(x))
        want = np.asarray(jax.vmap(jprob["constraints"].is_feasible)(x, u))
        assert 0 < want.sum() < len(want)
        np.testing.assert_array_equal(
            tprob["constraints"].is_feasible(_t(x), _t(u)).numpy(), want)
        for k in ("x0", "goal", "sample_space", "horizon", "dt",
                  "wrap_dims"):
            np.testing.assert_array_equal(np.asarray(tprob[k]),
                                          np.asarray(jprob[k]))
        for k in ("goal_buffer", "search_buffer"):
            np.testing.assert_array_equal(getattr(tprob["constraints"], k),
                                          getattr(jprob["constraints"], k))
    assert tprob["erf"] is torch.subtract
