"""Kernel C's prep and merge in plain PyTorch (CPU): the fold of S_j into
the upper triangle of its symmetric part (``nn_general_fold``), the cost
from the folded rows (``nn_general_fold_dist``) and the 64-bit merge keys
(``pack_keys``, ``unpack_keys``, ``EMPTY_KEY``) that the CUDA kernel's
blocks merge with ``atomicMin``.

The fold is exact algebra, so in fp64 its cost equals ``nn_general_dist``
to rounding (1e-12 relative) for symmetric and non-symmetric S.  Keys are
exact: int64 order is (cost, id) order, -0.0 ties +0.0, and unpack inverts
pack bit for bit."""
import math

import numpy as np
import pytest
import torch

from _torch_nn_merge import partitioned_argmin
from lqrrt_tpu_torch.ops.kernels.nn_kernel import (EMPTY_KEY, _mask,
                                                   nn_general_dist,
                                                   nn_general_fold,
                                                   nn_general_fold_dist,
                                                   nn_general_plain,
                                                   pack_keys, unpack_keys)

FP64_RTOL = 1e-12


def _data(n, symmetric, seed, R=64, B=9, dtype=np.float64):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-8, 8, (R, n))
    xr = rng.uniform(-8, 8, (B, n))
    A = rng.normal(size=(R, n, n))
    S = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(n) if symmetric else A
    return (torch.from_numpy(states.astype(dtype)),
            torch.from_numpy(S.astype(dtype)),
            torch.from_numpy(xr.astype(dtype)))


@pytest.mark.parametrize("n", [1, 4, 12, 16])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("wrap", [None, 0, "last"])
def test_fold_cost_equals_dist_fp64(n, symmetric, wrap):
    wrap_dim = n - 1 if wrap == "last" else wrap
    states, S, xr = _data(n, symmetric, seed=n)
    if wrap_dim is not None:   # angles well past one turn
        states[:, wrap_dim] *= 2.0
    rows, perm = nn_general_fold(states, S, wrap_dim)
    assert rows.shape == (states.shape[0], -(-(n + n * (n + 1) // 2) // 4)
                          * 4)
    got = nn_general_fold_dist(rows, xr[:, perm], n, wrap_dim is not None)
    ref = nn_general_dist(states, S, xr, wrap_dim)
    scale = ref.abs().max()
    assert (got - ref).abs().max() <= FP64_RTOL * scale


def test_fold_layout_puts_wrap_dim_first():
    n, wrap_dim = 6, 2
    states, S, _ = _data(n, False, seed=1, R=3)
    rows, perm = nn_general_fold(states, S, wrap_dim)
    assert perm.tolist() == [2, 0, 1, 3, 4, 5]
    torch.testing.assert_close(rows[:, :n], states[:, perm], rtol=0, atol=0)
    Sp = S[:, perm][:, :, perm]
    p = n
    for i in range(n):
        for k in range(i, n):
            want = Sp[:, i, i] if i == k else Sp[:, i, k] + Sp[:, k, i]
            torch.testing.assert_close(rows[:, p], want, rtol=0, atol=0)
            p += 1
    assert (rows[:, p:] == 0).all() and rows.shape[1] % 4 == 0


def test_fold_float32_cost_close_to_dist():
    """The kernel's fp32 arithmetic: only S_ik + S_ki rounds otherwise."""
    states, S, xr = _data(12, False, seed=3, dtype=np.float32)
    rows, perm = nn_general_fold(states, S, 5)
    got = nn_general_fold_dist(rows, xr[:, perm], 12, True)
    ref = nn_general_dist(states.double(), S.double(), xr.double(), 5)
    assert ((got.double() - ref).abs() / ref.abs().max()).max() < 1e-5


def test_keys_order_over_signs_and_zeros():
    cost = torch.tensor([-math.inf, -3.5, -1.0, -1e-30, -0.0, 0.0, 1e-30,
                         1.0, 2.5, math.inf])
    ids = torch.zeros(cost.shape, dtype=torch.int32)
    keys = pack_keys(cost, ids)
    assert (keys[1:] >= keys[:-1]).all()
    assert (keys[1:-1] > keys[:-2]).sum() == len(cost) - 3   # all but 0s
    assert keys[4] == keys[5]          # -0.0 and +0.0 tie, as floats do


def test_keys_ties_go_to_lowest_index():
    cost = torch.tensor([2.0, 2.0, -0.0, 0.0, 2.0])
    ids = torch.tensor([7, 3, 9, 4, 0], dtype=torch.int32)
    keys = pack_keys(cost, ids)
    assert keys[1] < keys[0] and keys[4] < keys[1]
    assert keys[3] < keys[2]
    best = unpack_keys(keys.min().reshape(1))
    assert best[0].item() == 4 and best[1].item() == 0.0


def test_keys_round_trip_exactly():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    cost = torch.from_numpy(bits.view(np.float32).copy())
    cost = cost[torch.isfinite(cost)]
    cost = torch.cat([cost, torch.tensor([math.inf, -math.inf, 0.0,
                                          3.4e38, -3.4e38, 1e-45])])
    ids = torch.from_numpy(rng.integers(0, 2**31 - 1, cost.numel())
                           .astype(np.int32))
    got_ids, got = unpack_keys(pack_keys(cost, ids))
    assert torch.equal(got_ids, ids)
    assert torch.equal(got.view(torch.int32), cost.view(torch.int32))
    order = torch.argsort(pack_keys(cost, ids))
    c, i = cost[order].double(), ids[order].long()
    assert ((c[1:] > c[:-1]) | ((c[1:] == c[:-1]) & (i[1:] > i[:-1]))).all()


def test_empty_key_is_inf_at_row_zero():
    assert EMPTY_KEY == pack_keys(torch.tensor([math.inf]),
                                  torch.tensor([0])).item()
    ids, cost = unpack_keys(torch.tensor([EMPTY_KEY]))
    assert ids.item() == 0 and cost.item() == math.inf
    # every finite cost, and +inf at a later row, loses to nothing only
    # where it is below (+inf, 0)
    assert pack_keys(torch.tensor([3.4e38]), torch.tensor([2**31 - 1])) \
        .item() < EMPTY_KEY


@pytest.mark.parametrize("parts", [1, 3, 7])
def test_partitioned_key_merge_matches_the_scan(parts):
    """The kernel's merge in plain PyTorch: each partition of [0, size)
    scans its rows with a strict '<' and merges (cost, row) keys by their
    minimum.  With root-pad copies of row 0, a NaN S row inside size and
    NaN rows past it, the ids and costs equal the sequential scan's."""
    n, wrap_dim, size = 4, 2, 45
    states, S, xr = _data(n, True, seed=5, R=64, B=12, dtype=np.float32)
    states[1:8] = states[0]            # root pad: rows 1..7 copy row 0
    S[1:8] = S[0]
    xr[:3] = states[0]                 # exact ties at cost 0
    S[20] = math.nan
    S[size:] = math.nan
    states[size + 3:] = math.nan
    rows, perm = nn_general_fold(states, S, wrap_dim)
    cost = nn_general_fold_dist(rows, xr[:, perm], n, True)
    cost = _mask(cost, 0, rows.shape[0], size)
    ids, got = partitioned_argmin(lambda j0, j1: cost[:, j0:j1], size,
                                  xr.shape[0], parts, cost.device)
    ids_ref, ref = nn_general_plain(states, S, torch.tensor(size,
                                                            dtype=torch.int32),
                                    xr, wrap_dim)
    assert ids[:3].tolist() == [0, 0, 0]
    assert torch.equal(ids, ids_ref)
    assert (ids != 20).all()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4)
