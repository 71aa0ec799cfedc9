"""Kernel E's plain versions against the JAX experiment (CPU):
``nn_exp``/``nn_hybrid``/``nn_split3`` (lqrrt_tpu_torch/ops/kernels/
nn_hybrid.py) vs ``nearest_const_exp``/``nearest_const_hybrid``/
``nearest_const_split3`` (tools/exp_nn_hybrid_v5.py) in interpret mode, on
the same numpy inputs at boat scale: N = 2048 rows, B = 64 candidates,
``block=512``, the boat's S, sizes 1, 7, 1500 and N, psi wrapped and not.

The expanded cost |z|^2 - 2 w.z cancels down to |z - w|^2, so its rounding
error scales with M_b = (max |z_j| + |w_b|)^2 (``error_scale``), not with
the cost; tolerances that cannot be relative to the cost are stated as a
share of M_b, each with its reason where it is used.  Picks are "equal or
equivalent": where ids differ, both picks are rescored under the true
metric in fp64 and may differ by at most twice the modes' error
(``ERROR``), since each pick is within its mode's error of the minimum."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_nn_merge import partitioned_argmin
from lqrrt_tpu_torch.models import boat
from lqrrt_tpu_torch.ops.kernels.nn_hybrid import (ERROR, MODES,
                                                   error_scale, expand_cost,
                                                   expand_prep,
                                                   nn_expand_plain, nn_exp,
                                                   nn_hybrid, nn_split3,
                                                   split_bf16)
from lqrrt_tpu_torch.ops.kernels.nn_kernel import _mask

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _load_tool():
    """tools/exp_nn_hybrid_v5.py by path (tools/ is not a package).  It
    points JAX's compile cache at .jax_cache/ when imported; the setting is
    put back so that the other tests in this process are unaffected."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "exp_nn_hybrid_v5", REPO / "tools" / "exp_nn_hybrid_v5.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in saved.items():
        jax.config.update(k, v)
    return mod


tool = _load_tool()

N, B, BLOCK = 2048, 64, 512
SIZES = [1, 7, 1500, N]
WRAPS = [None, 2]
S_BOAT = boat.default_problem()["lqr"](torch.zeros(6),
                                       torch.zeros(3))[0].numpy()
# variant -> (port wrapper kwargs, JAX function, its kwargs, mode)
VARIANTS = {
    "exp": (nn_exp, {}, tool.nearest_const_exp, {}, "fma"),
    "highest": (nn_hybrid, {"prec": "highest"}, tool.nearest_const_hybrid,
                {"prec": "highest"}, "fma"),
    "high": (nn_hybrid, {"prec": "high"}, tool.nearest_const_hybrid,
             {"prec": "high"}, "bf16x3"),
    "default": (nn_hybrid, {"prec": "default"}, tool.nearest_const_hybrid,
                {"prec": "default"}, "bf16"),
    "split3": (nn_split3, {}, tool.nearest_const_split3, {}, "bf16x3"),
}


def _data(seed, N_=N, B_=B):
    """States and candidates uniform in the boat's sample space."""
    ss = boat.default_problem()["sample_space"]
    rng = np.random.default_rng(seed)
    states = (ss[:, 0] + rng.random((N_, 6)) * (ss[:, 1] - ss[:, 0]))
    xrand = (ss[:, 0] + rng.random((B_, 6)) * (ss[:, 1] - ss[:, 0]))
    S = np.broadcast_to(S_BOAT, (N_, 6, 6)).copy()
    return states.astype(np.float32), S, xrand.astype(np.float32)


def _port(name, states, S, size, xrand, wrap_dim):
    fn, kw = VARIANTS[name][:2]
    ids, cost = fn(torch.from_numpy(states), torch.from_numpy(S),
                   torch.tensor(size, dtype=torch.int32),
                   torch.from_numpy(xrand), wrap_dim=wrap_dim, **kw)
    return ids.numpy(), cost.numpy()


def _jax(name, states, S, size, xrand, wrap_dim):
    fn, kw = VARIANTS[name][2:4]
    ids, cost = fn(jnp.asarray(states), jnp.asarray(S),
                   jnp.asarray(size, jnp.int32), jnp.asarray(xrand),
                   block=BLOCK, wrap_dim=wrap_dim, interpret=True, **kw)
    return np.asarray(ids), np.asarray(cost)


def _scale(states, S, size, xrand, wrap_dim):
    """M_b of the inputs (numpy, float64)."""
    p = expand_prep(torch.from_numpy(states), torch.from_numpy(S),
                    torch.from_numpy(xrand), wrap_dim)
    return error_scale(p, size).double().numpy()


def _cost64(states, S, xrand, ids, wrap_dim):
    """The true metric of each candidate's pick, in fp64."""
    e = xrand.astype(np.float64) - states[ids].astype(np.float64)
    if wrap_dim is not None:
        e[:, wrap_dim] = np.mod(e[:, wrap_dim] + np.pi, 2 * np.pi) - np.pi
    return np.einsum("bi,ij,bj->b", e, S[0].astype(np.float64), e)


def _exact(states, S, size, xrand, wrap_dim):
    """fp64 brute force: the true nearest live row's cost."""
    e = xrand[:, None, :].astype(np.float64) - states[None, :size]
    if wrap_dim is not None:
        e[..., wrap_dim] = np.mod(e[..., wrap_dim] + np.pi, 2 * np.pi) - np.pi
    return np.einsum("bni,ij,bnj->bn", e, S[0].astype(np.float64), e).min(1)


def _equivalent(states, S, xrand, wrap_dim, ids, ids_ref, tol):
    """Ids equal, or their true fp64 costs within ``tol`` (B,)."""
    flip = ids != ids_ref
    gap = np.abs(_cost64(states, S, xrand, ids, wrap_dim)
                 - _cost64(states, S, xrand, ids_ref, wrap_dim))
    assert (gap[flip] <= tol[flip]).all(), (np.flatnonzero(flip),
                                            (gap / tol).max())


def test_split_bf16_is_the_tools_split():
    """Bit for bit against a numpy transcription of the tool's ``split``
    (exp_nn_hybrid_v5.py:378-382), ties to even and signs included."""
    rng = np.random.default_rng(0)
    a = np.concatenate([
        rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096),
        [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1e-40, -1e-40],
    ]).astype(np.float32)
    # exact ties between two bf16 values: round half to even, both ways
    a = np.concatenate([a, np.array([0x3F808000, 0x3F818000, 0xBF808000,
                                     0x3F80FFFF, 0x3F807FFF],
                                    np.uint32).view(np.float32)])
    ai = a.view(np.uint32).astype(np.uint64)
    want = (((ai + 0x7FFF + ((ai >> 16) & 1)) & 0xFFFF0000)
            .astype(np.uint32).view(np.float32))
    hi, lo = split_bf16(torch.from_numpy(a))
    np.testing.assert_array_equal(hi.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(lo.numpy().view(np.uint32),
                                  (a - want).view(np.uint32))
    # hi is a bf16 value, and round to nearest even, as torch's cast is
    np.testing.assert_array_equal(
        hi.numpy(), torch.from_numpy(a).to(torch.bfloat16).float().numpy())


@pytest.mark.parametrize("wrap_dim", WRAPS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["exp", "highest"])
def test_fp32_variants_match_tool(name, size, wrap_dim):
    """exp and hybrid "highest": fp32 on both sides, so ids equal or
    equivalent, and costs within 1e-4 relative: the same terms, rounded in
    another order by the prep's matrix products and the cross term.  Where
    cancellation leaves a cost small against M_b, a few fp32 ulps of the
    terms dominate, so the bound there is 2^-22 M_b absolute (measured:
    about 2^-24.5 M_b)."""
    states, S, xrand = _data(size)
    ids, cost = _port(name, states, S, size, xrand, wrap_dim)
    ids_ref, cost_ref = _jax(name, states, S, size, xrand, wrap_dim)
    assert ids.dtype == np.int32 and ids.shape == (B,) and ids.max() < size
    M = _scale(states, S, size, xrand, wrap_dim)
    _equivalent(states, S, xrand, wrap_dim, ids, ids_ref, 2 * ERROR["fma"] * M)
    tol = np.maximum(1e-4 * np.abs(cost_ref), 2.0 ** -22 * M)
    assert (np.abs(cost - cost_ref) <= tol).all(), \
        (np.abs(cost - cost_ref) / tol).max()
    # the blocked scan's block size does not change the answer
    ids2, cost2 = nn_expand_plain(
        torch.from_numpy(states), torch.from_numpy(S),
        torch.tensor(size, dtype=torch.int32), torch.from_numpy(xrand),
        wrap_dim, "fma", block=64)
    np.testing.assert_array_equal(ids2.numpy(), ids)
    np.testing.assert_array_equal(cost2.numpy(), cost)


@pytest.mark.parametrize("wrap_dim", WRAPS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", ["split3", "high"])
def test_three_pass_variants_match_tool(name, size, wrap_dim):
    """split3 and hybrid "high" take the same hi/lo products as the tool,
    except that the port (like the card's and the TPU's bf16 pass) rounds
    lo to bf16 while JAX on the CPU multiplies lo in fp32 (its DEFAULT and
    HIGH precisions are fp32 there).  Rounding lo moves each product by at
    most 2^-16 of each operand and the seven products' errors differ in
    sign, so costs agree within 1e-5 M_b (measured: about 3e-6 M_b; not
    1e-5 of the cost, which cancellation makes 1000x smaller than M_b).
    Ids equal or equivalent within the three-pass error."""
    states, S, xrand = _data(100 + size)
    ids, cost = _port(name, states, S, size, xrand, wrap_dim)
    ids_ref, cost_ref = _jax(name, states, S, size, xrand, wrap_dim)
    assert ids.max() < size
    M = _scale(states, S, size, xrand, wrap_dim)
    _equivalent(states, S, xrand, wrap_dim, ids, ids_ref,
                2 * ERROR["bf16x3"] * M)
    assert (np.abs(cost - cost_ref) <= 1e-5 * M).all(), \
        (np.abs(cost - cost_ref) / M).max()


@pytest.mark.parametrize("wrap_dim", WRAPS)
@pytest.mark.parametrize("size", SIZES)
def test_default_excess_within_bf16_bound(size, wrap_dim):
    """hybrid "default" is one bf16 pass on the card, but fp32 in JAX on
    the CPU (its picks equal exp's there).  The port's plain version rounds
    both operands to bf16 (unit roundoff 2^-8), so each pair's cost moves
    by up to (2^-7 + 2^-16) M_b and a pick's fp64 excess over the exact
    nearest stays below 2 * 2^-6 M_b (ERROR["bf16"], with the fp32 sums)."""
    states, S, xrand = _data(200 + size)
    ids, cost = _port("default", states, S, size, xrand, wrap_dim)
    assert ids.max() < size and np.isfinite(cost).all()
    M = _scale(states, S, size, xrand, wrap_dim)
    excess = (_cost64(states, S, xrand, ids, wrap_dim)
              - _exact(states, S, size, xrand, wrap_dim))
    assert (excess <= 2 * ERROR["bf16"] * M).all(), (excess / M).max()
    ids_j, _ = _jax("default", states, S, size, xrand, wrap_dim)
    ids_e, _ = _jax("exp", states, S, size, xrand, wrap_dim)
    np.testing.assert_array_equal(ids_j, ids_e)
    if size == N:
        # the rounding is real: bf16 picks leave the fp32 ones
        assert (ids != ids_e).any()


def _bf16_np(a):
    """a rounded to float32, then to bf16 on its top 16 bits (nearest even,
    the tool's ``split``), as float64."""
    ai = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    hi = ((ai + 0x7FFF + ((ai >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return hi.view(np.float32).astype(np.float64)


def _bf16_costs_np(states, S, size, xrand, wrap_dim):
    """(B, size) costs of one bf16 pass, in numpy and fp64, independent of
    the port: the tool's prep (cholesky, centring, features, wrap terms),
    the depth-8 features rounded to bf16, their products summed exactly,
    and the wrap term and |w|^2 unrounded."""
    S64 = S[0].astype(np.float64)
    L = np.linalg.cholesky(S64 + 1e-9 * np.eye(6))
    center = xrand.astype(np.float64).mean(0)
    if wrap_dim is not None:
        center[wrap_dim] = 0.0
    sc = states[:size].astype(np.float64) - center
    xc = xrand.astype(np.float64) - center
    z, w = sc @ L, xc @ L
    phi = np.concatenate([(z * z).sum(1, keepdims=True), -2.0 * z], 1)
    psi = np.concatenate([np.ones((len(w), 1)), w], 1)
    c = _bf16_np(psi) @ _bf16_np(phi).T + (w * w).sum(1)[:, None]
    if wrap_dim is not None:
        a = wrap_dim
        k = np.round((sc[None, :, a] - xc[:, None, a]) / (2 * np.pi))
        P = -4 * np.pi * (sc @ S64[a])
        Q = 4 * np.pi * (xc @ S64[a])
        c = c + k * (P[None, :] + Q[:, None]) \
            + 4 * np.pi ** 2 * S64[a, a] * k * k
    return c


@pytest.mark.parametrize("wrap_dim", WRAPS)
@pytest.mark.parametrize("size", SIZES)
def test_default_matches_numpy_bf16_reference(size, wrap_dim):
    """hybrid "default" against a numpy reference of one bf16 pass (JAX on
    the CPU has none: its "default" is fp32).  Both round the same
    features to bf16; they differ only by the fp32 rounding of the
    features and of the port's 8-term sum, a few 2^-24 M_b.  So the port's
    pick is within 2 * 2^-16 M_b of the reference's nearest under the
    reference's own costs, and the port's cost within 1e-5 M_b of the
    reference's cost of that pick.  A bf16 slip (an operand rounded
    twice, or not at all, or a broken wrap term) moves costs by ~2^-8 M_b,
    and the test checks that the reference itself sits that far from fp32
    at the full size."""
    states, S, xrand = _data(300 + size)
    ids, cost = _port("default", states, S, size, xrand, wrap_dim)
    M = _scale(states, S, size, xrand, wrap_dim)
    c = _bf16_costs_np(states, S, size, xrand, wrap_dim)
    rows = np.arange(B)
    excess = c[rows, ids] - c.min(1)
    assert (excess <= 2 * 2.0 ** -16 * M).all(), (excess / M).max()
    err = np.abs(cost - c[rows, ids])
    assert (err <= 1e-5 * M).all(), (err / M).max()
    if size == N:
        exact = _exact(states, S, size, xrand, wrap_dim)
        assert (np.abs(c.min(1) - exact) / M).max() > 100 * 1e-5


@pytest.mark.parametrize("name", list(VARIANTS))
def test_wrap_seam(name):
    """0.1 rad across the seam beats 1 rad the long way."""
    states = np.zeros((8, 6), np.float32)
    states[0, 2] = np.pi - 0.05
    states[1, 2] = 1.0
    S = np.tile(np.eye(6, dtype=np.float32), (8, 1, 1))
    xrand = np.zeros((8, 6), np.float32)
    xrand[:, 2] = -np.pi + 0.05
    ids, cost = _port(name, states, S, 2, xrand, 2)
    assert (ids == 0).all()
    # each mode's cost is within its error of the true 0.1^2
    M = _scale(states, S, 2, xrand, 2)
    assert (np.abs(cost - 0.1 ** 2) <= ERROR[VARIANTS[name][4]] * M).all()


@pytest.mark.parametrize("name", list(VARIANTS))
def test_dead_nan_rows_drop_only_themselves(name):
    """NaN rows past ``size`` = 1500, inside the tool's row block [1024,
    1536).  The JAX prep poisons only |z|^2 of a dead row, so its -2 z row
    is NaN, the block's minimum is NaN and the block's live rows 1024..1499
    are lost.  The port masks dead rows by index: each candidate, placed by
    a row of that block, still finds the block's rows."""
    states, S, _ = _data(5)
    size = 1500
    xrand = states[1024:1024 + B] + np.float32(0.01)
    states[size:] = np.nan
    ids_j, _ = _jax(name, states, S, size, xrand, 2)
    assert not np.isin(ids_j, np.arange(1024, 1536)).any()     # JAX
    ids, cost = _port(name, states, S, size, xrand, 2)           # port
    assert ids.max() < size and np.isfinite(cost).all()
    if VARIANTS[name][4] != "bf16":
        np.testing.assert_array_equal(ids, np.arange(1024, 1024 + B))
    else:
        # one bf16 pass picks within its error of the own row
        M = _scale(states[:size], S[:size], size, xrand, 2)
        gap = _cost64(states, S, xrand, ids, 2)
        assert (gap <= 2 * ERROR["bf16"] * M).all()


@pytest.mark.parametrize("block", [16, 1024])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_root_pad_ties_resolve_to_row_zero(name, block):
    """Rows 1..63 are bit-identical copies of row 0: row 0 wins every tie,
    inside a block and across blocks of the plain scan."""
    rng = np.random.default_rng(5)
    P = 64
    states = np.tile(rng.uniform(-1, 1, (1, 6)).astype(np.float32), (P, 1))
    S = np.tile(S_BOAT, (P, 1, 1))
    xrand = rng.uniform(-5, 5, (B, 6)).astype(np.float32)
    mode = VARIANTS[name][4]
    ids, _ = nn_expand_plain(torch.from_numpy(states), torch.from_numpy(S),
                             torch.tensor(P, dtype=torch.int32),
                             torch.from_numpy(xrand), 2, mode, block=block)
    assert (ids == 0).all()
    ids, _ = _port(name, states, S, P, xrand, 2)
    assert (ids == 0).all()


@pytest.mark.parametrize("parts", [1, 3, 7])
@pytest.mark.parametrize("mode", MODES)
def test_partitioned_key_merge_matches_chunk_order(mode, parts):
    """The kernel's merge in plain PyTorch: each partition of [0, size)
    keeps its first minimum of c (without |w|^2), the partitions merge by
    the minimum of their (c, row) keys, and |w|^2 is added after; the
    blocked scan merges its chunks in order.  With root-pad copies of row
    0, NaN rows inside and past size, both give the same ids and costs bit
    for bit, in every mode."""
    size = 300
    states, S, _ = _data(7, N_=512, B_=B)
    states[1:40] = states[0]             # root pad: rows 1..39 copy row 0
    xrand = states[100:100 + B] + np.float32(0.01)
    xrand[:3] = states[0]                # ties among the copies of row 0
    states[250] = np.nan                 # a NaN row inside size
    states[size + 3:] = np.nan           # and past it
    st, Sm, xr = (torch.from_numpy(a) for a in (states, S, xrand))
    p = expand_prep(st, Sm, xr, 2)

    def dist(j0, j1):
        return _mask(expand_cost(p, j0, j1, mode, True), j0, j1, size)

    ids, c = partitioned_argmin(dist, size, B, parts, st.device)
    ids_ref, cost_ref = nn_expand_plain(
        st, Sm, torch.tensor(size, dtype=torch.int32), xr, 2, mode,
        block=128)
    assert ids[:3].tolist() == [0, 0, 0]
    assert (ids != 250).all() and (ids < size).all()
    assert torch.equal(ids, ids_ref)
    assert torch.equal((c + p.w2).view(torch.int32),
                       cost_ref.view(torch.int32))


def test_rejects_bad_inputs():
    states, S, xrand = _data(1, N_=64, B_=8)
    st, Sm, xr = (torch.from_numpy(a) for a in (states, S, xrand))
    sz = torch.tensor(3, dtype=torch.int32)
    for fn in (nn_exp, nn_hybrid, nn_split3):
        with pytest.raises(ValueError, match="n <= 7"):         # n = 8
            fn(torch.zeros(64, 8), torch.eye(8), sz, torch.zeros(8, 8))
        with pytest.raises(TypeError):                           # float64
            fn(st.double(), Sm, sz, xr)
        with pytest.raises(TypeError):                           # int64 size
            fn(st, Sm, torch.tensor(3), xr)
        with pytest.raises(ValueError, match="share a device"):  # mixed
            fn(st, Sm, sz, xr.to("meta"))
        with pytest.raises(ValueError, match="contiguous"):
            fn(st.T.contiguous().T, Sm, sz, xr)
    with pytest.raises(ValueError, match="prec"):
        nn_hybrid(st, Sm, sz, xr, prec="fast")


def test_entry_point_main_on_cpu(monkeypatch):
    """The experiment end to end at a small size on the CPU: every
    variant against the exact scan, and the chained timing loop (cut to
    one chain of two calls)."""
    from lqrrt_tpu_torch.tools import exp_nn_hybrid
    from lqrrt_tpu_torch.tools.exp_nn_hybrid import main

    monkeypatch.setattr(exp_nn_hybrid, "REPS", 2)
    monkeypatch.setattr(exp_nn_hybrid, "OUTER", 1)
    out = main(device="cpu", N=N, B=B, size=1500, seed=0)
    assert out["device"] == "cpu"
    labels = ["kernel A nn_const", "exp", "hybrid[highest]", "hybrid[high]",
              "hybrid[default]", "split3"]
    assert sorted(out["checks"]) == sorted(labels)
    assert sorted(out["ms_per_call"]) == sorted(labels)
    for label, c in out["checks"].items():
        assert c["live"] and c["max_excess"] >= c["mean_excess"] >= 0.0
        assert c["excess_over_bound"] <= 1.0, (label, c)
    assert out["checks"]["exp"]["id_match"] == 1.0
    assert all(ms > 0 for ms in out["ms_per_call"].values())
    with pytest.raises(RuntimeError, match="CUDA"):
        main(device="cuda", N=N, B=B, size=1500)
