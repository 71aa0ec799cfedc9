"""The port's batched CARE and per-node LQR against scipy and the JAX
package (CPU), mirroring tests/test_riccati.py.

Tolerances are those of the JAX tests: rtol/atol 2e-3 against scipy's
float64 CARE (fp32 sign iteration), and 2e-3 between the two fp32 solvers
(Gauss-Jordan in JAX, LU here)."""
import numpy as np
import pytest
import scipy.linalg
import torch

import jax
import jax.numpy as jnp

from lqrrt_tpu.models import car as jcar
from lqrrt_tpu.models import quadrotor as jquad
from lqrrt_tpu.ops import riccati as jriccati
from lqrrt_tpu_torch.models import car, quadrotor
from lqrrt_tpu_torch.ops import riccati

torch.set_num_threads(2)


def _systems(seed, n, m, count=4):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((count, n, n)).astype(np.float32)
    B = rng.standard_normal((count, n, m)).astype(np.float32)
    return A, B


@pytest.mark.parametrize("n,m,seed", [(2, 1, 0), (4, 2, 1), (6, 3, 2),
                                      (12, 4, 3)])
def test_batched_care_matches_scipy(n, m, seed):
    A, B = _systems(seed, n, m)
    S, K = riccati.care_lqr(torch.from_numpy(A), torch.from_numpy(B),
                            torch.eye(n), torch.eye(m))
    assert S.shape == (4, n, n) and K.shape == (4, m, n)
    for i in range(len(A)):
        P = scipy.linalg.solve_continuous_are(A[i], B[i], np.eye(n),
                                              np.eye(m))
        np.testing.assert_allclose(S[i].numpy(), P, rtol=2e-3, atol=2e-3)
        # the gain stabilizes the closed loop
        eig = np.linalg.eigvals(A[i] - B[i] @ K[i].numpy())
        assert np.all(eig.real < 0), eig
    # one system unbatched (LAPACK's single and batched LU round
    # differently, so it is held to scipy, not to the batch's row)
    S0 = riccati.solve_care(torch.from_numpy(A[0]), torch.from_numpy(B[0]),
                            torch.eye(n), torch.eye(m))
    assert S0.shape == (n, n)
    np.testing.assert_allclose(S0.numpy(), scipy.linalg.solve_continuous_are(
        A[0], B[0], np.eye(n), np.eye(m)), rtol=2e-3, atol=2e-3)


def test_care_double_integrator():
    A = np.zeros((4, 4), np.float32)
    A[0, 2] = A[1, 3] = 1.0
    B = np.zeros((4, 2), np.float32)
    B[2, 0] = B[3, 1] = 1.0
    Q = np.diag([1, 1, 0.1, 0.1]).astype(np.float32)
    R = 0.1 * np.eye(2, dtype=np.float32)
    P = scipy.linalg.solve_continuous_are(A, B, Q, R)
    S = riccati.solve_care(*(torch.from_numpy(a) for a in (A, B, Q, R)))
    np.testing.assert_allclose(S.numpy(), P, rtol=1e-3, atol=1e-3)
    # the host solver serves the same policy as a constant lqr
    lqr = riccati.make_constant_lqr(A, B, Q, R)
    Sc, Kc = lqr(torch.zeros(3, 4), torch.zeros(3, 2))
    np.testing.assert_allclose(Sc[2].numpy(), P, rtol=1e-5, atol=1e-5)
    assert Kc.shape == (3, 2, 4)


def test_matrix_sign_matches_jax():
    A, B = _systems(7, 6, 3, count=1)
    G = B[0] @ B[0].T
    H = np.block([[A[0], -G], [-np.eye(6), -A[0].T]]).astype(np.float32)
    Z = riccati._matrix_sign(torch.from_numpy(H)).numpy()
    np.testing.assert_allclose(Z @ Z, np.eye(12), atol=1e-3)
    np.testing.assert_allclose(Z, np.asarray(jriccati._matrix_sign(
        jnp.asarray(H))), rtol=2e-3, atol=2e-3)


def test_linearize_batched_and_single():
    def f(x, u):
        return torch.cat([x[..., 2:], u], dim=-1) * torch.cos(x[..., :1])

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-1, 1, (5, 4)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(-1, 1, (5, 2)).astype(np.float32))
    A, B = riccati.linearize(f, x, u)
    assert A.shape == (5, 4, 4) and B.shape == (5, 4, 2)
    assert A.dtype == B.dtype == torch.float32
    for i in range(5):
        jf = (lambda a, b: jnp.concatenate([a[2:], b]) * jnp.cos(a[0]))
        jA, jB = jriccati.linearize(jf, x[i].numpy(), u[i].numpy())
        np.testing.assert_allclose(A[i].numpy(), np.asarray(jA), atol=1e-6)
        np.testing.assert_allclose(B[i].numpy(), np.asarray(jB), atol=1e-6)
        A1, _ = riccati.linearize(f, x[i], u[i])
        np.testing.assert_array_equal(A1.numpy(), A[i].numpy())


@pytest.mark.parametrize("model", ["car", "quadrotor"])
def test_relinearized_lqr_matches_jax(model):
    jm, tm = {"car": (jcar, car), "quadrotor": (jquad, quadrotor)}[model]
    ss = jm.default_problem()["sample_space"]
    rng = np.random.default_rng(5)
    x = rng.uniform(ss[:, 0], ss[:, 1], (64, len(ss))).astype(np.float32)
    u = rng.uniform(-1, 1, (64, tm.NCONTROLS)).astype(np.float32)
    jS, jK = (np.asarray(a) for a in jax.vmap(jm.make_lqr())(x, u))
    S, K = tm.make_lqr()(torch.from_numpy(x), torch.from_numpy(u))
    assert torch.isfinite(S).all() and torch.isfinite(K).all()
    np.testing.assert_allclose(S.numpy(), jS, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(K.numpy(), jK, rtol=2e-3, atol=2e-3)
    # the planner's seed calls it unbatched
    S1, K1 = tm.make_lqr()(torch.from_numpy(x[3]), torch.from_numpy(u[3]))
    assert S1.shape == S.shape[1:] and K1.shape == K.shape[1:]
    np.testing.assert_allclose(S1.numpy(), S[3].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_car_x_map_applies_outside_the_jacobian():
    """At rest the linearization point has |v| = 0.8, and the Jacobian is
    of f itself there: dpx/dv = cos(theta) survives (a clamp inside f would
    zero it)."""
    x = torch.tensor([[1.0, 2.0, 0.3, 0.0], [0.0, 0.0, -1.0, -0.2]])
    xl = car.x_map(x)
    np.testing.assert_allclose(xl[:, 3].numpy(), [0.8, -0.8])
    A, _ = riccati.linearize(car.f, xl, torch.zeros(2, 2))
    np.testing.assert_allclose(A[:, 0, 3].numpy(), np.cos([0.3, -1.0]),
                               rtol=1e-6)
    S, _ = car.make_lqr()(x, torch.zeros(2, 2))
    assert torch.isfinite(S).all()


def _dare_system(n, m, seed):
    rng = np.random.default_rng(seed)
    # A scaled down so that the DARE is comfortably solvable (as the JAX
    # package's test)
    A = (0.5 * rng.standard_normal((n, n))).astype(np.float32)
    B = rng.standard_normal((n, m)).astype(np.float32)
    Q = np.diag(rng.uniform(0.5, 2.0, n)).astype(np.float32)
    R = np.diag(rng.uniform(0.5, 2.0, m)).astype(np.float32)
    return A, B, Q, R


@pytest.mark.parametrize("n,m,seed", [(2, 1, 20), (4, 2, 10), (12, 4, 21)])
def test_dare_matches_scipy_and_jax(n, m, seed):
    """solve_dare / dare_lqr against scipy's float64 solve_discrete_are and
    against the JAX package's dare_lqr on the same (A, B, Q, R): S within
    rtol/atol 2e-3 of scipy's (the JAX test's tolerance) and of JAX's; K
    within 2e-3 of (R + B'SB)^-1 B'SA from scipy's S and of JAX's K."""
    A, B, Q, R = _dare_system(n, m, seed)
    S, K = riccati.dare_lqr(*(torch.from_numpy(v) for v in (A, B, Q, R)))
    assert S.shape == (n, n) and K.shape == (m, n)
    assert S.dtype == K.dtype == torch.float32
    P = scipy.linalg.solve_discrete_are(A, B, Q, R)
    K64 = np.linalg.solve(R + B.T @ P @ B, B.T @ P @ A)
    np.testing.assert_allclose(S.numpy(), P, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(K.numpy(), K64, rtol=2e-3, atol=2e-3)
    jS, jK = jriccati.dare_lqr(*(jnp.asarray(v) for v in (A, B, Q, R)))
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(K.numpy(), np.asarray(jK), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_array_equal(
        riccati.solve_dare(*(torch.from_numpy(v) for v in (A, B, Q, R))),
        S)
    # the discrete closed loop is stable
    assert np.abs(np.linalg.eigvals(A - B @ K.numpy())).max() < 1.0


def test_dare_batched():
    """Leading axes are batch axes: a batch of 3 systems equals each solved
    alone (within 1e-4: LAPACK's batched and single inverses may round
    differently)."""
    systems = [_dare_system(4, 2, s) for s in (30, 31, 32)]
    stack = [torch.from_numpy(np.stack(v)) for v in zip(*systems)]
    S, K = riccati.dare_lqr(*stack)
    assert S.shape == (3, 4, 4) and K.shape == (3, 2, 4)
    for i, sysm in enumerate(systems):
        Si, Ki = riccati.dare_lqr(*(torch.from_numpy(v) for v in sysm))
        np.testing.assert_allclose(S[i].numpy(), Si.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(K[i].numpy(), Ki.numpy(), rtol=1e-4,
                                   atol=1e-4)
