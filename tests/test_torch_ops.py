"""The port's ops and boat model against the JAX package, on the same numpy
inputs (CPU)."""
import numpy as np
import pytest
import torch

import jax

from lqrrt_tpu.models import boat as jboat
from lqrrt_tpu.ops import angles as jangles
from lqrrt_tpu.ops import collision as jcollision
from lqrrt_tpu.ops import integrate as jintegrate
from lqrrt_tpu_torch import Constraints
from lqrrt_tpu_torch.models import boat
from lqrrt_tpu_torch.ops import angles, collision, integrate

torch.set_num_threads(2)

# f32 on both sides with the same formulas; trig ulps differ by library
RTOL, ATOL = 1e-5, 1e-5


def _states(seed, B=64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-3, 3, (B, 6)).astype(np.float32)
    x[:, 0] *= 15.0
    u = rng.uniform(-800, 800, (B, 3)).astype(np.float32)
    return x, u


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def test_wrap_angle_at_the_seam():
    a = np.array([-np.pi, np.pi, np.pi - 1e-6, -np.pi + 1e-6, 3 * np.pi,
                  -3 * np.pi, 0.0, 7.5, -7.5, 1e-7], np.float32)
    np.testing.assert_array_equal(angles.wrap_angle(_t(a)).numpy(),
                                  np.asarray(jangles.wrap_angle(a)))


@pytest.mark.parametrize("angle_dims", [(), (2,)])
def test_make_erf_matches(angle_dims):
    rng = np.random.default_rng(1)
    xg = rng.uniform(-4, 4, (32, 6)).astype(np.float32)
    x = rng.uniform(-4, 4, (32, 6)).astype(np.float32)
    x[:4, 2] = [np.pi - 0.01, -np.pi + 0.01, np.pi, -np.pi]
    xg[:4, 2] = [-np.pi + 0.01, np.pi - 0.01, -np.pi, np.pi]
    jerf = jangles.make_erf(6, angle_dims)
    terf = angles.make_erf(6, angle_dims)
    assert terf.angle_dims == tuple(angle_dims)
    want = np.asarray(jax.vmap(jerf)(xg, x))
    np.testing.assert_allclose(terf(_t(xg), _t(x)).numpy(), want,
                               rtol=RTOL, atol=ATOL)
    # a shared goal broadcasts against a batch of states
    want1 = np.asarray(jax.vmap(jerf, in_axes=(None, 0))(xg[0], x))
    np.testing.assert_allclose(terf(_t(xg[0]), _t(x)).numpy(), want1,
                               rtol=RTOL, atol=ATOL)


def test_rk4_step_matches():
    x, u = _states(2)
    want = np.asarray(jax.vmap(
        lambda a, b: jintegrate.rk4_step(jboat.f, a, b, 0.05))(x, u))
    got = integrate.rk4_step(boat.f, _t(x), _t(u), 0.05).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_circles_free_and_all_of():
    centers = np.array([[0.0, 0.0], [5.0, 1.0]], np.float32)
    radii = np.array([1.0, 2.0], np.float32)
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 8, (256, 6)).astype(np.float32)
    u = np.zeros((256, 3), np.float32)
    jp = jcollision.circles_free(centers, radii, margin=0.5)
    tp = collision.circles_free(centers, radii, margin=0.5)
    want = np.asarray(jax.vmap(jp)(x, u))
    assert 0 < want.sum() < len(want)
    np.testing.assert_array_equal(tp(_t(x), _t(u)).numpy(), want)
    jq = jcollision.circles_free(centers[:1] + 2.0, radii[:1])
    tq = collision.circles_free(centers[:1] + 2.0, radii[:1])
    want_all = np.asarray(jax.vmap(jcollision.all_of(jp, jq))(x, u))
    got_all = collision.all_of(tp, tq)(_t(x), _t(u)).numpy()
    np.testing.assert_array_equal(got_all, want_all)
    assert collision.all_of()(_t(x), _t(u)).numpy().all()


def test_boat_callbacks_match():
    x, u = _states(4)
    jprob, tprob = jboat.default_problem(), boat.default_problem()
    np.testing.assert_allclose(boat.f(_t(x), _t(u)).numpy(),
                               np.asarray(jax.vmap(jboat.f)(x, u)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(boat.saturate(_t(u)).numpy(),
                               np.asarray(jax.vmap(jboat.saturate)(u)))
    want = np.asarray(jax.vmap(lambda a, b: jboat.dynamics(a, b, 0.05))(x, u))
    np.testing.assert_allclose(boat.dynamics(_t(x), _t(u), 0.05).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    g = np.asarray(jprob["goal"])
    np.testing.assert_allclose(
        tprob["erf"](_t(g), _t(x)).numpy(),
        np.asarray(jax.vmap(jprob["erf"], in_axes=(None, 0))(g, x)),
        rtol=RTOL, atol=ATOL)
    # positions across the buoy field: some feasible, some not
    x[:, 0] = np.linspace(5, 35, len(x))
    x[:, 1] = np.linspace(-8, 8, len(x))
    want_f = np.asarray(jax.vmap(jprob["constraints"].is_feasible)(x, u))
    assert 0 < want_f.sum() < len(want_f)
    np.testing.assert_array_equal(
        tprob["constraints"].is_feasible(_t(x), _t(u)).numpy(), want_f)
    for k in ("x0", "goal", "sample_space", "horizon", "dt", "wrap_dims"):
        np.testing.assert_array_equal(np.asarray(tprob[k]),
                                      np.asarray(jprob[k]))
    np.testing.assert_array_equal(tprob["constraints"].goal_buffer,
                                  jprob["constraints"].goal_buffer)


def test_hard_problem_and_grid():
    jprob, tprob = jboat.hard_problem(), boat.hard_problem()
    for a, b in zip(tprob["obstacles"], jprob["obstacles"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tprob["goal"], jprob["goal"])
    # the grid model is ported (its raster: tests/test_torch_collision.py);
    # an unknown model raises in both packages
    jgrid = jboat.default_problem(obstacle_model="grid")
    tgrid = boat.default_problem(obstacle_model="grid")
    for a, b in zip(tgrid["obstacles"], jgrid["obstacles"]):
        np.testing.assert_array_equal(a, b)
    for make in (boat.default_problem, jboat.default_problem):
        with pytest.raises(ValueError, match="obstacle_model"):
            make(obstacle_model="voxels")


def test_lqr_setup_matches_jax():
    """scipy's CARE vs the JAX sign iteration (accurate to ~1e-4)."""
    jS, jK = (np.asarray(a) for a in jboat.make_lqr()(None, None))
    tS, tK = (t.numpy() for t in boat.make_lqr()(torch.zeros(6),
                                                 torch.zeros(3)))
    np.testing.assert_allclose(tS, jS, rtol=1e-3,
                               atol=1e-3 * np.abs(jS).max())
    np.testing.assert_allclose(tK, jK, rtol=1e-3,
                               atol=1e-3 * np.abs(jK).max())
    # a batch of states gets the same (S, K) on every row
    S, K = boat.make_lqr()(torch.zeros(5, 6), torch.zeros(5, 3))
    assert S.shape == (5, 6, 6) and K.shape == (5, 3, 6)


def test_constraints_record():
    c = Constraints(2, 1, goal_buffer=[0.1, 0.2])
    assert c.is_feasible(torch.zeros(4, 2), torch.zeros(4, 1)).all()
    box = c.sample_space([0, 1], [2, -1])
    np.testing.assert_array_equal(box, [[0, 2], [-1, 1]])
    with pytest.raises(ValueError):
        Constraints(2, 1, goal_buffer=[0.1])
    v = c._feasibility_version
    c.set_feasibility_function(lambda x, u: x[..., 0] > 0)
    assert c._feasibility_version == v + 1
