"""Kernel A's arithmetic and merge in plain PyTorch (CPU): the permuted,
whitened form of the constant-metric cost (``nn_const_prep``,
``nn_const_dist``), the two-add rounding of the turn count (``_rint``) and
the partitioned 64-bit key merge that the CUDA kernel's blocks make
(``partitioned_argmin``).

In fp64 the permuted form is exact algebra: with the wrap dim first, a turn
moves z_0 only, and the cost equals the unpermuted form of the kernel
before (c = 2pi L[a, :] on every coordinate) to rounding (1e-12 relative).
The partitioned merge gives the sequential scan's ids and costs bit for
bit, at any number of partitions, with root-pad ties and NaN rows."""
import math

import numpy as np
import pytest
import torch

from _torch_nn_merge import partitioned_argmin
from lqrrt_tpu_torch.ops.kernels.nn_kernel import (
    _mask, _perm, _rint, nn_const, nn_const_dist, nn_const_plain,
    nn_const_prep)

FP64_RTOL = 1e-12


def _data(n, seed, R=64, B=9, dtype=np.float64, wrap_dim=None):
    rng = np.random.default_rng(seed)
    states = rng.uniform(-8, 8, (R, n))
    xr = rng.uniform(-8, 8, (B, n))
    if wrap_dim is not None:   # angles well past one turn
        states[:, wrap_dim] = rng.uniform(-3 * np.pi, 3 * np.pi, R)
        xr[:, wrap_dim] = rng.uniform(-np.pi, np.pi, B)
    A = rng.normal(size=(n, n))
    S = A @ A.T + 0.1 * np.eye(n)
    return (torch.from_numpy(states.astype(dtype)),
            torch.from_numpy(S.astype(dtype)),
            torch.from_numpy(xr.astype(dtype)))


def _unpermuted_dist(states, S, xr, wrap_dim):
    """The kernel's earlier form, in the inputs' type: L of the unpermuted
    S, centring on the candidate mean (the wrap dim uncentred), k =
    round((x_a - r_a) / 2pi) and |z - w - k 2pi L[a, :]|^2."""
    n = states.shape[1]
    L = torch.linalg.cholesky(S + 1e-9 * torch.eye(n, dtype=S.dtype))
    center = xr.mean(0)
    if wrap_dim is not None:
        center[wrap_dim] = 0.0
    z, w = (states - center) @ L, (xr - center) @ L
    d = z[None] - w[:, None]
    if wrap_dim is not None:
        k = torch.round((states[None, :, wrap_dim] - xr[:, None, wrap_dim])
                        / (2 * math.pi))
        d = d - k[..., None] * (2 * math.pi * L[wrap_dim])
    return (d * d).sum(-1)


@pytest.mark.parametrize("n", [1, 4, 6, 12, 16])
@pytest.mark.parametrize("wrap", [None, 0, "mid", "last"])
def test_permuted_form_equals_unpermuted_fp64(n, wrap):
    wrap_dim = {None: None, 0: 0, "mid": n // 2, "last": n - 1}[wrap]
    states, S, xr = _data(n, seed=n, wrap_dim=wrap_dim)
    z, w, xp, rp, c0 = nn_const_prep(states, S, xr, wrap_dim)
    assert z.dtype == torch.float64
    got = nn_const_dist(z, w, xp, rp, c0, wrap_dim is not None)
    ref = _unpermuted_dist(states, S, xr, wrap_dim)
    assert (got - ref).abs().max() <= FP64_RTOL * ref.abs().max()


def test_prep_layout_puts_wrap_dim_first():
    n, wrap_dim = 6, 2
    states, S, xr = _data(n, seed=1, wrap_dim=wrap_dim)
    assert _perm(n, wrap_dim) == [2, 0, 1, 3, 4, 5]
    assert _perm(n, -1) == [5, 0, 1, 2, 3, 4]
    assert _perm(n, None) == list(range(n))
    z, w, xp, rp, c0 = nn_const_prep(states, S, xr, wrap_dim)
    perm = _perm(n, wrap_dim)
    L = torch.linalg.cholesky(S[perm][:, perm] + 1e-9 * torch.eye(n,
                                                 dtype=S.dtype))
    torch.testing.assert_close(c0, 2 * math.pi * L[0, 0])
    torch.testing.assert_close(xp, states[:, wrap_dim] / (2 * math.pi))
    torch.testing.assert_close(rp, xr[:, wrap_dim] / (2 * math.pi))
    # one turn of the wrap dim moves the whitened row along z_0 alone
    shifted = states.clone()
    shifted[:, wrap_dim] += 2 * math.pi
    z2 = nn_const_prep(shifted, S, xr, wrap_dim)[0]
    torch.testing.assert_close(z2[:, 1:], z[:, 1:], rtol=0, atol=1e-12)
    torch.testing.assert_close(z2[:, 0] - z[:, 0], c0.expand(len(z)))


def test_rint_is_round_half_even():
    v = torch.tensor([-2.5, -1.5, -0.5, -0.49, 0.0, 0.5, 0.51, 1.5, 2.5,
                      3.4999998, 1e6 + 0.5, 4194303.5, -4194303.5])
    for dtype in (torch.float32, torch.float64):
        x = v.to(dtype)
        assert torch.equal(_rint(x), torch.round(x))
    x = (torch.rand(100000, dtype=torch.float64) - 0.5) * 2 ** 23
    assert torch.equal(_rint(x.float()), torch.round(x.float()))


def test_float32_form_close_to_fp64():
    """The kernel's fp32 arithmetic: the whitening is taken in fp64 and
    rounded once, the difference and its squares in fp32."""
    states, S, xr = _data(6, seed=3, dtype=np.float32, wrap_dim=2)
    got = nn_const_dist(*nn_const_prep(states, S, xr, 2), True)
    ref = _unpermuted_dist(states.double(), S.double(), xr.double(), 2)
    assert ((got.double() - ref).abs() / ref.abs().max()).max() < 1e-6


def _merged(states, S, size, xr, wrap_dim, parts):
    z, w, xp, rp, c0 = nn_const_prep(states, S, xr, wrap_dim)

    def dist(j0, j1):
        cost = nn_const_dist(z[j0:j1], w, xp[j0:j1], rp, c0,
                             wrap_dim is not None)
        return _mask(cost, j0, j1, size)

    return partitioned_argmin(dist, size, xr.shape[0], parts, states.device)


@pytest.mark.parametrize("parts", [1, 3, 7])
@pytest.mark.parametrize("wrap_dim", [None, 2])
def test_partitioned_key_merge_matches_the_scan(parts, wrap_dim):
    """Each partition of [0, size) scans its rows with a strict '<' and
    merges (cost, row) keys by their minimum, as the kernel's blocks do.
    With root-pad copies of row 0, NaN rows inside and past size, the ids
    and costs equal the sequential scan's bit for bit."""
    n, size = 6, 45
    states, S, xr = _data(n, seed=5, R=64, B=12, dtype=np.float32,
                          wrap_dim=wrap_dim)
    states[1:8] = states[0]            # root pad: rows 1..7 copy row 0
    xr[:3] = states[0]                 # exact ties at cost 0
    states[20] = math.nan              # a NaN row inside size
    states[size + 3:] = math.nan       # and past it
    ids, cost = _merged(states, S, size, xr, wrap_dim, parts)
    ids_ref, ref = nn_const_plain(states, S, torch.tensor(
        size, dtype=torch.int32), xr, wrap_dim)
    assert ids[:3].tolist() == [0, 0, 0]
    assert (ids != 20).all() and (ids < size).all()
    assert torch.equal(ids, ids_ref)
    assert torch.equal(cost.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("parts", [1, 3, 7])
def test_size_zero_gives_zero_and_inf(parts):
    states, S, xr = _data(4, seed=2, dtype=np.float32)
    ids, cost = _merged(states, S, 0, xr, None, parts)
    assert (ids == 0).all() and torch.isinf(cost).all() and (cost > 0).all()
    ids, cost = nn_const(states, S, torch.tensor(0, dtype=torch.int32), xr)
    assert (ids == 0).all() and torch.isinf(cost).all() and (cost > 0).all()


@pytest.mark.parametrize("n", [1, 16])
@pytest.mark.parametrize("wrap", [None, 0, "last"])
def test_extreme_n_picks_the_fp64_nearest(n, wrap):
    """n = 1 and n = 16, the kernel's limits: the plain version's picks
    are the fp64 brute force's, or within 1e-5 relative of it."""
    wrap_dim = {None: None, 0: 0, "last": n - 1}[wrap]
    states, S, xr = _data(n, seed=40 + n, R=200, B=32, dtype=np.float32,
                          wrap_dim=wrap_dim)
    size = 150
    ids, cost = nn_const(states, S, torch.tensor(size, dtype=torch.int32),
                         xr, wrap_dim=wrap_dim)
    ref = _unpermuted_dist(states[:size].double(), S.double(), xr.double(),
                           wrap_dim)
    best = ref.min(1).values
    picked = ref[torch.arange(len(xr)), ids.long()]
    assert (ids < size).all()
    assert ((picked - best) / best.abs().clamp(min=1e-6)).max() <= 1e-5
    torch.testing.assert_close(cost.double(), picked, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n", [1, 4, 6, 12, 16])
def test_bound_counts_the_permuted_form(n):
    """Kernel A's bound counts what the permuted function needs a pair:
    3n - 1 flops unwrapped (n subs, a mul, n - 1 FMAs), 4 more wrapped (a
    sub, a rint, the FMA of the turn into z_0); at n = 6 wrapped that is
    E's fp32 form's count, and 0.0841 ms at the planner's shapes."""
    from lqrrt_tpu_torch.tools import kernel_times as kt

    assert kt.const_flops(n, False) == {"fp32": 3 * n - 1}
    assert kt.const_flops(n, True) == {"fp32": 3 * n + 3}
    ms, by = kt.const_bound(n, True)
    assert by == "operations"
    assert ms == pytest.approx(kt.SIZE * kt.B * (3 * n + 3) / 67e12 * 1e3)
    if n == 6:
        assert kt.const_flops(6, True) == kt.expand_flops("fma", 6, True)
        assert round(ms, 4) == 0.0841


def test_ptxas_summary_names_each_instance(tmp_path, monkeypatch):
    """The build's ``ptxas -v`` log gives one line a kernel instance, with
    its template arguments, registers, shared memory and spills."""
    from lqrrt_tpu_torch.ops.kernels import _build
    from lqrrt_tpu_torch.tools import kernel_times as kt

    log = tmp_path / "lib.ptxas.txt"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115"
        "nn_const_kernelILi6ELb1EEEvPKfS2_' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 106 registers, 128 bytes smem, 400 bytes "
        "cmem[0]\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116"
        "nn_expand_kernelILi2ELb0EEEvPKf' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
        "loads\n"
        "ptxas info    : Used 80 registers, 31664 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120"
        "steer_rollout_kernelINS_4BoatEEEvPKfS3_PKii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 96 registers, 852 bytes smem\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120"
        "steer_rollout_kernelINS_6RasterINS_4BoatEEEEEvPKfS5_PKii' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 98 registers, 852 bytes smem\n")
    monkeypatch.setattr(_build, "ptxas_log_path", lambda: log)
    assert kt.ptxas_summary() == [
        "nn_const_kernel<6,1>: 106 registers, 128 B smem, spill 0/0 B",
        "nn_expand_kernel<2,0>: 80 registers, 31664 B smem, spill 8/8 B",
        "steer_rollout_kernel<Boat>: 96 registers, 852 B smem, "
        "spill 0/0 B",
        "steer_rollout_kernel<Raster<Boat>>: 98 registers, 852 B smem, "
        "spill 0/0 B"]
    monkeypatch.setattr(_build, "ptxas_log_path",
                        lambda: tmp_path / "absent.txt")
    assert kt.ptxas_summary() == []
