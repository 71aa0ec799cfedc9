"""The port's nearest neighbour against the JAX package (CPU): the plain
blocked scan vs ``make_nearest``, and the plain version of the nn_const
kernel vs ``nearest_const_pallas`` in interpret mode.

Ids must be equal; where one differs, the port's pick is rescored in fp64
and may exceed the reference's pick by at most 1e-4 relative.  Costs:
rtol 1e-4, atol 1e-3 (f32, other summation order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lqrrt_tpu.core.nearest import make_nearest as jmake_nearest
from lqrrt_tpu.ops.angles import make_erf as jmake_erf
from lqrrt_tpu.ops.pallas.nn_kernel import nearest_const_pallas
from lqrrt_tpu_torch.core.nearest import make_nearest
from lqrrt_tpu_torch.ops.angles import make_erf
from lqrrt_tpu_torch.ops.kernels.nn_kernel import nn_const, nn_const_plain

torch.set_num_threads(2)

N, n, B = 256, 6, 16
EXCESS = 1e-4


def _tree(seed, wrap_dim=None, const=False):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-5, 5, (N, n)).astype(np.float32)
    xrand = rng.uniform(-5, 5, (B, n)).astype(np.float32)
    if wrap_dim is not None:
        states[:, wrap_dim] = rng.uniform(-np.pi, np.pi, N)
        xrand[:, wrap_dim] = rng.uniform(-np.pi, np.pi, B)
        xrand[:3, wrap_dim] = [np.pi - 1e-3, -np.pi + 1e-3, -np.pi]
    if const:
        A = rng.normal(size=(n, n)).astype(np.float32)
        S = np.tile((A @ A.T + 0.1 * np.eye(n)).astype(np.float32),
                    (N, 1, 1))
    else:
        A = rng.normal(size=(N, n, n)).astype(np.float32)
        S = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(n,
                                                            dtype=np.float32)
    return states, S.astype(np.float32), xrand


def _cost64(states, S, xrand, ids, wrap_dim):
    e = xrand.astype(np.float64) - states[ids].astype(np.float64)
    if wrap_dim is not None:
        e[:, wrap_dim] = np.mod(e[:, wrap_dim] + np.pi, 2 * np.pi) - np.pi
    return np.einsum("bi,bij,bj->b", e, S[ids].astype(np.float64), e)


def _agree(states, S, xrand, wrap_dim, ids, cost, ids_ref, cost_ref):
    ids, ids_ref = np.asarray(ids), np.asarray(ids_ref)
    flip = ids != ids_ref
    if flip.any():
        c = _cost64(states, S, xrand, ids, wrap_dim)
        c_ref = _cost64(states, S, xrand, ids_ref, wrap_dim)
        excess = (c - c_ref) / np.maximum(np.abs(c_ref), 1e-6)
        assert excess.max() <= EXCESS, (np.flatnonzero(flip), excess.max())
    assert flip.mean() <= 0.05
    np.testing.assert_allclose(np.asarray(cost), np.asarray(cost_ref),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("size", [1, 7, N])
@pytest.mark.parametrize("wrap_dim", [None, 2])
def test_plain_nearest_matches_jax(size, wrap_dim):
    states, S, xrand = _tree(0, wrap_dim)
    dims = () if wrap_dim is None else (wrap_dim,)
    ids_ref, cost_ref = jmake_nearest(jmake_erf(n, dims), block=64)(
        jnp.asarray(states), jnp.asarray(S), jnp.asarray(size),
        jnp.asarray(xrand))
    ids, cost = make_nearest(make_erf(n, dims), block=64)(
        torch.from_numpy(states), torch.from_numpy(S),
        torch.tensor(size, dtype=torch.int32), torch.from_numpy(xrand))
    assert ids.dtype == torch.int32 and ids.shape == (B,)
    assert int(ids.max()) < size
    _agree(states, S, xrand, wrap_dim, ids, cost, ids_ref, cost_ref)


@pytest.mark.parametrize("size", [1, 7, N])
@pytest.mark.parametrize("wrap_dim", [None, 2])
def test_nn_const_plain_matches_pallas(size, wrap_dim):
    states, S, xrand = _tree(7, wrap_dim, const=True)
    ids_ref, cost_ref = nearest_const_pallas(
        jnp.asarray(states), jnp.asarray(S), jnp.asarray(size),
        jnp.asarray(xrand), block=64, wrap_dim=wrap_dim, interpret=True)
    sz = torch.tensor(size, dtype=torch.int32)
    ids, cost = nn_const(torch.from_numpy(states), torch.from_numpy(S), sz,
                         torch.from_numpy(xrand), wrap_dim=wrap_dim)
    assert int(ids.max()) < size
    _agree(states, S, xrand, wrap_dim, ids, cost, ids_ref, cost_ref)
    # the blocked scan's block size does not change the answer
    ids2, cost2 = nn_const_plain(torch.from_numpy(states),
                                 torch.from_numpy(S), sz,
                                 torch.from_numpy(xrand), wrap_dim, block=64)
    np.testing.assert_array_equal(ids2.numpy(), ids.numpy())
    np.testing.assert_array_equal(cost2.numpy(), cost.numpy())


def test_nn_const_wrap_seam():
    states = np.zeros((8, n), np.float32)
    states[0, 2] = np.pi - 0.05
    states[1, 2] = 1.0
    S = np.tile(np.eye(n, dtype=np.float32), (8, 1, 1))
    xrand = np.zeros((8, n), np.float32)
    xrand[:, 2] = -np.pi + 0.05
    ids, cost = nn_const(torch.from_numpy(states), torch.from_numpy(S),
                         torch.tensor(2, dtype=torch.int32),
                         torch.from_numpy(xrand), wrap_dim=2)
    assert int(ids[0]) == 0           # 0.1 rad around the seam beats 1 rad
    np.testing.assert_allclose(float(cost[0]), 0.1 ** 2, rtol=1e-3)


def test_root_pad_ties_resolve_to_row_zero():
    """Rows 1..P-1 are bit-identical copies of the root: row 0 must win."""
    rng = np.random.default_rng(5)
    P = 64
    states = np.tile(rng.uniform(-1, 1, (1, n)).astype(np.float32), (P, 1))
    A = rng.normal(size=(n, n)).astype(np.float32)
    S = np.tile((A @ A.T + np.eye(n)).astype(np.float32), (P, 1, 1))
    xrand = rng.uniform(-5, 5, (B, n)).astype(np.float32)
    size = torch.tensor(P, dtype=torch.int32)
    ids, _ = nn_const(torch.from_numpy(states), torch.from_numpy(S), size,
                      torch.from_numpy(xrand), wrap_dim=2)
    assert (ids == 0).all()
    ids, _ = make_nearest(make_erf(n, (2,)), block=16)(
        torch.from_numpy(states), torch.from_numpy(S), size,
        torch.from_numpy(xrand))
    assert (ids == 0).all()


def test_nn_const_dead_rows_are_masked_by_index():
    """Non-finite garbage past ``size`` can never be picked."""
    states, S, xrand = _tree(9, 2, const=True)
    states[100:] = np.nan
    ids, cost = nn_const(torch.from_numpy(states), torch.from_numpy(S),
                         torch.tensor(100, dtype=torch.int32),
                         torch.from_numpy(xrand), wrap_dim=2)
    assert int(ids.max()) < 100 and torch.isfinite(cost).all()


def test_nn_const_rejects_bad_inputs():
    states, S, xrand = _tree(1, None, const=True)
    with pytest.raises(TypeError):
        nn_const(torch.from_numpy(states), torch.from_numpy(S),
                 torch.tensor(3, dtype=torch.int64), torch.from_numpy(xrand))
    with pytest.raises(TypeError):
        nn_const(torch.from_numpy(states).double(), torch.from_numpy(S),
                 torch.tensor(3, dtype=torch.int32), torch.from_numpy(xrand))
