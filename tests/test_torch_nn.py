"""The port's nearest neighbour against the JAX package (CPU): the plain
blocked scan vs ``make_nearest``, the plain version of the nn_const kernel
vs ``nearest_const_pallas`` and that of the nn_general kernel vs
``nearest_pallas``, both in interpret mode.

Ids must be equal; where one differs, the port's pick is rescored in fp64
and may exceed the reference's pick by at most 1e-4 relative.  Costs:
rtol 1e-4, atol 1e-3 (f32, other summation order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lqrrt_tpu.core.nearest import make_nearest as jmake_nearest
from lqrrt_tpu.ops.angles import make_erf as jmake_erf
from lqrrt_tpu.ops.pallas.nn_kernel import (nearest_const_pallas,
                                            nearest_pallas)
from lqrrt_tpu_torch.core.nearest import make_nearest
from lqrrt_tpu_torch.ops.angles import make_erf
from lqrrt_tpu_torch.ops.kernels.nn_kernel import (nn_const, nn_const_plain,
                                                   nn_general,
                                                   nn_general_plain)

torch.set_num_threads(2)

N, n, B = 256, 6, 16
EXCESS = 1e-4


def _tree(seed, wrap_dim=None, const=False, n=n):
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


@pytest.mark.parametrize("nn,wrap_dim", [(17, None), (17, 16), (20, None),
                                         (20, 0)])
def test_nn_const_plain_matches_pallas_past_16_states(nn, wrap_dim):
    """n = 17-20: the kernel's instances past the package's models, up to
    the JAX constant-metric kernel's own limit of 20 states."""
    states, S, xrand = _tree(nn, wrap_dim, const=True, n=nn)
    ids_ref, cost_ref = nearest_const_pallas(
        jnp.asarray(states), jnp.asarray(S), jnp.asarray(N),
        jnp.asarray(xrand), block=64, wrap_dim=wrap_dim, interpret=True)
    ids, cost = nn_const(torch.from_numpy(states), torch.from_numpy(S),
                         torch.tensor(N, dtype=torch.int32),
                         torch.from_numpy(xrand), wrap_dim=wrap_dim)
    _agree(states, S, xrand, wrap_dim, ids, cost, ids_ref, cost_ref)


def test_nn_const_rejects_bad_inputs():
    states, S, xrand = _tree(1, None, const=True)
    with pytest.raises(TypeError):
        nn_const(torch.from_numpy(states), torch.from_numpy(S),
                 torch.tensor(3, dtype=torch.int64), torch.from_numpy(xrand))
    with pytest.raises(TypeError):
        nn_const(torch.from_numpy(states).double(), torch.from_numpy(S),
                 torch.tensor(3, dtype=torch.int32), torch.from_numpy(xrand))


# ---- nn_general (kernel C): per-node S ------------------------------------


def _general_tree(seed, nn, N_=N, B_=B, wrap_dim=None):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-5, 5, (N_, nn)).astype(np.float32)
    xrand = rng.uniform(-5, 5, (B_, nn)).astype(np.float32)
    if wrap_dim is not None:
        states[:, wrap_dim] = rng.uniform(-np.pi, np.pi, N_)
        xrand[:, wrap_dim] = rng.uniform(-np.pi, np.pi, B_)
        xrand[:3, wrap_dim] = [np.pi - 1e-3, -np.pi + 1e-3, -np.pi]
    A = rng.normal(size=(N_, nn, nn)).astype(np.float32)
    S = np.einsum("nij,nkj->nik", A, A) + 0.1 * np.eye(nn, dtype=np.float32)
    return states, S.astype(np.float32), xrand


def _jax_refs(states, S, size, xrand, wrap_dim, block=64):
    """(ids, cost) of JAX nearest_pallas (interpret) and make_nearest."""
    nn = states.shape[1]
    args = (jnp.asarray(states), jnp.asarray(S), jnp.asarray(size),
            jnp.asarray(xrand))
    pallas = nearest_pallas(*args, block=block, wrap_dim=wrap_dim,
                            interpret=True)
    dims = () if wrap_dim is None else (wrap_dim,)
    scan = jmake_nearest(jmake_erf(nn, dims), block=block)(*args)
    return [tuple(np.asarray(a) for a in r) for r in (pallas, scan)]


def _general(states, S, size, xrand, wrap_dim, **kw):
    ids, cost = nn_general(torch.from_numpy(states), torch.from_numpy(S),
                           torch.tensor(size, dtype=torch.int32),
                           torch.from_numpy(xrand), wrap_dim=wrap_dim, **kw)
    return ids.numpy(), cost.numpy()


@pytest.mark.parametrize("nn,wrap_dim", [(4, None), (4, 2), (6, None),
                                         (6, 2), (12, None), (12, 5),
                                         (20, 19), (24, None), (24, 3)])
@pytest.mark.parametrize("size", [1, 7, N])
def test_nn_general_plain_matches_pallas_and_scan(nn, wrap_dim, size):
    states, S, xrand = _general_tree(nn + size, nn, wrap_dim=wrap_dim)
    ids, cost = _general(states, S, size, xrand, wrap_dim)
    assert ids.dtype == np.int32 and ids.shape == (B,)
    assert ids.max() < size
    for ids_ref, cost_ref in _jax_refs(states, S, size, xrand, wrap_dim):
        np.testing.assert_array_equal(ids, ids_ref)
        np.testing.assert_allclose(cost, cost_ref, rtol=1e-4, atol=1e-3)
    # the blocked scan's block size does not change the answer
    ids2, cost2 = nn_general_plain(
        torch.from_numpy(states), torch.from_numpy(S),
        torch.tensor(size, dtype=torch.int32), torch.from_numpy(xrand),
        wrap_dim, block=64)
    np.testing.assert_array_equal(ids2.numpy(), ids)
    np.testing.assert_array_equal(cost2.numpy(), cost)


def test_nn_general_many_candidates():
    """B > 1024 (the Pallas kernel's candidate tiling) at a partial size."""
    states, S, xrand = _general_tree(4, 6, N_=128, B_=2048, wrap_dim=2)
    ids, cost = _general(states, S, 100, xrand, 2)
    assert ids.max() < 100
    for ids_ref, cost_ref in _jax_refs(states, S, 100, xrand, 2, block=128):
        np.testing.assert_array_equal(ids, ids_ref)
        np.testing.assert_allclose(cost, cost_ref, rtol=1e-4, atol=1e-3)


def test_nn_general_wrap_seam():
    states = np.zeros((8, 4), np.float32)
    states[0, 2] = np.pi - 0.05
    states[1, 2] = 1.0
    S = np.tile(np.eye(4, dtype=np.float32), (8, 1, 1))
    xrand = np.zeros((8, 4), np.float32)
    xrand[:, 2] = -np.pi + 0.05
    ids, cost = _general(states, S, 2, xrand, 2)
    assert ids[0] == 0                # 0.1 rad around the seam beats 1 rad
    np.testing.assert_allclose(cost[0], 0.1 ** 2, rtol=1e-3)


def test_nn_general_dead_rows_and_root_pad():
    """NaN garbage past ``size`` is never picked; bit-identical root-pad
    copies of row 0 lose every tie to it."""
    states, S, xrand = _general_tree(9, 12, wrap_dim=5)
    states[100:] = np.nan
    S[100:] = np.nan
    ids, cost = _general(states, S, 100, xrand, 5)
    assert ids.max() < 100 and np.isfinite(cost).all()
    states[1:64], S[1:64] = states[0], S[0]
    ids, _ = _general(states, S, 64, xrand, 5)
    assert (ids == 0).all()


def test_nn_general_rejects_bad_inputs():
    states, S, xrand = _general_tree(1, 4)
    with pytest.raises(ValueError, match="N, n, n"):
        _general(states, S[:, :3], 3, xrand, None)
    with pytest.raises(TypeError):
        nn_general(torch.from_numpy(states), torch.from_numpy(S),
                   torch.tensor(3), torch.from_numpy(xrand))


def test_non_finite_cost_drops_only_its_row():
    """One live row with a NaN metric in the middle of a block.  The JAX
    scan's ``jnp.min`` carries the NaN and drops the whole block; the port's
    scans drop only that row and still find the block's nearest rows."""
    nn, bad = 4, 100                  # row 100 lies in block [64, 128)
    states, S, xrand = _general_tree(21, nn)
    xrand[:] = states[64:64 + B] + 0.01          # nearest rows: 64..79
    S[bad] = np.nan
    size = torch.tensor(N, dtype=torch.int32)
    erf = make_erf(nn)
    want = np.arange(64, 64 + B)
    # old result: the reference drops block [64, 128), so no pick lies in it
    jids, _ = jmake_nearest(jmake_erf(nn), block=64)(
        jnp.asarray(states), jnp.asarray(S), jnp.asarray(N),
        jnp.asarray(xrand))
    assert not np.isin(np.asarray(jids), np.arange(64, 128)).any()
    # new result: the block's own nearest rows
    for fn in (make_nearest(erf, block=64),
               lambda *a: nn_general_plain(*a, block=64)):
        ids, cost = fn(torch.from_numpy(states), torch.from_numpy(S), size,
                       torch.from_numpy(xrand))
        np.testing.assert_array_equal(ids.numpy(), want)
        assert torch.isfinite(cost).all()
    # nn_const: a NaN state row (its metric is the shared S[0])
    Sc = np.tile(S[0], (N, 1, 1))
    states_c = states.copy()
    states_c[bad] = np.nan
    ids, cost = nn_const_plain(torch.from_numpy(states_c),
                               torch.from_numpy(Sc), size,
                               torch.from_numpy(xrand), block=64)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert torch.isfinite(cost).all()
