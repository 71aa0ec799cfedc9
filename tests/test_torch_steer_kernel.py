"""Kernel D's plain versions against the JAX steer and the JAX kernels (CPU).

The port's steer (``lqrrt_tpu_torch/core/steer.py`` ``make_steer``) is
kernel D's plain version, and the wrappers ``make_steer_kernel`` and
``make_steer_kernel_tree`` (``ops/kernels/steer_kernel.py``) take it for
CPU tensors.  On the same numpy inputs -- ``boat.default_problem()`` at
H = 100, B = 96 candidates from ``branch_batch``, which reaches every branch
of the step (goal stop, infeasible stop, length 0, the psi wrap, saturated
efforts) -- they are held against the JAX scan
(``lqrrt_tpu.core.steer.make_steer(layout="tm")``) and against
``make_steer_pallas`` and ``make_steer_pallas_tree`` (a tree of N = 1024
rows, ``node_block=512``) of ``tools/steer_kernel_experimental.py`` in
interpret mode.  Both sides take the port's boat K.

length, in_goal and reached must be equal, and so x_seq, u_seq and xnew are
compared everywhere: x_seq and xnew within atol 1e-3 (as
tests/test_torch_round.py: fp32 over 100 RK4 steps).  u at step h is
K e(x_h) of the state the step starts from, so it carries that state's
difference times the gain: one ulp of a 40 m position is 3.8e-6, and the
boat's |K| rows sum to at most ~780: ~3e-3.  u_seq is held to 1e-3 plus that
carried difference, step by step (``_u_tol``).  The
Pallas kernels test sum(e * e) <= tol^2 where the scan tests the norm
(ROADMAP section 3); the data keep clear of the threshold.

The car (H = 80), the quadrotor (60) and the double integrator (40) go the
same way on their ``default_problem()`` (``all_of(control_limits,
circles_free)``), flat and tree, against the JAX kernels on each model's
JAX callbacks (``_model_inputs``); the factories build on every model and
on tagged predicates and refuse what the kernel has no device form for.
The CUDA kernel itself runs only on the card (``chip_smoke.py``)."""
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lqrrt_tpu.core.steer import make_steer as jmake_steer
from lqrrt_tpu.models import boat as jboat
from lqrrt_tpu.models import car as jcar
from lqrrt_tpu.models import double_integrator as jdouble_integrator
from lqrrt_tpu.models import quadrotor as jquadrotor
from lqrrt_tpu.ops import collision as jcollision
from lqrrt_tpu_torch.constraints import _all_true
from lqrrt_tpu_torch.core.steer import SteerResult, make_steer
from lqrrt_tpu_torch.models import (boat, car, double_integrator,
                                    quadrotor)
from lqrrt_tpu_torch.ops import collision
from lqrrt_tpu_torch.ops.angles import make_erf
from lqrrt_tpu_torch.ops.kernels import steer_kernel
from lqrrt_tpu_torch.ops.kernels.steer_kernel import (MAX_CIRCLES,
                                                      MAX_THREADS,
                                                      boat_params,
                                                      make_steer_kernel,
                                                      make_steer_kernel_tree,
                                                      rollout_geometry,
                                                      sqrt_threshold)
from lqrrt_tpu_torch.tools import exp_steer_kernel
from lqrrt_tpu_torch.tools.kernel_times import (circle_problems,
                                                many_circles)
from lqrrt_tpu_torch.tools.exp_steer_kernel import (DT, GROUPS, H, TOL,
                                                    boat_K, branch_batch,
                                                    branch_counts,
                                                    steer_args)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-3
B, N, NODE_BLOCK = 96, 1024, 512


def _load_kernel_tool():
    """tools/steer_kernel_experimental.py as a module.  It cannot be
    imported as it stands: its docstring is followed by a second string
    literal, so ``from __future__ import annotations`` (:53) is not at the
    top of the file and Python refuses it with a SyntaxError.  The source is
    read, that one line dropped (the module needs no postponed
    annotations), and the rest run in a fresh module whose ``__file__`` is
    the original path.  The module puts the repo root on ``sys.path``;
    ``sys.path`` and JAX's config are put back afterwards."""
    path = REPO / "tools" / "steer_kernel_experimental.py"
    source = path.read_text().replace(
        "from __future__ import annotations\n", "", 1)
    mod = types.ModuleType("steer_kernel_experimental")
    mod.__file__ = str(path)
    saved_path, saved_cfg = list(sys.path), dict(jax.config.values)
    exec(compile(source, str(path), "exec"), mod.__dict__)
    sys.path[:] = saved_path
    for k, v in saved_cfg.items():
        if jax.config.values.get(k) != v:
            jax.config.update(k, v)
    return mod


tool = _load_kernel_tool()
PROB = boat.default_problem()
JPROB = jboat.default_problem()
GOAL = PROB["goal"]


def _inputs(seed=0):
    """numpy x0, K (B, 3, 6), xtar, and a tree (N rows) holding x0 at
    distinct random rows pids, each row with its own gain (the boat's K
    scaled by 0.5-1.5), so that a wrong row of K shows."""
    x0, xtar, _ = branch_batch(B, seed, PROB)
    K = np.broadcast_to(boat_K(PROB), (B, 3, 6)).copy()
    rng = np.random.default_rng(seed + 1)
    states = rng.uniform(-1.0, 1.0, (N, 6)).astype(np.float32)
    pids = rng.permutation(N)[:B].astype(np.int32)
    states[pids] = x0
    KN = (boat_K(PROB) * rng.uniform(0.5, 1.5, (N, 1, 1))).astype(np.float32)
    return x0, K, xtar, states, KN, pids


def _jargs(tol=TOL):
    return ((JPROB["dynamics"], JPROB["erf"],
             JPROB["constraints"].is_feasible, H, DT, tol),
            dict(saturate=JPROB["saturate"]))


def _port_args(tol=TOL):
    args, kw = steer_args(PROB)
    return args[:5] + (tol,), kw


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _u_tol(x0, K, port, jres):
    """(H, 1, B) tolerance of u_seq: ATOL plus |K|'s largest row sum times
    the largest difference of the state each step starts from."""
    start_p = np.concatenate([x0.T[None], port.x_seq.numpy()[:-1]])
    start_j = np.concatenate([x0.T[None], np.asarray(jres.x_seq)[:-1]])
    dx = np.abs(start_p - start_j).max(axis=1, keepdims=True)
    return ATOL + np.abs(K).sum(-1).max() * dx


def _assert_same(port, jres, x0, K):
    """length, in_goal, reached and the mask equal; x_seq and xnew within
    ATOL, u_seq within ``_u_tol`` (every length agrees, so everywhere)."""
    for field in ("length", "in_goal", "reached", "mask"):
        np.testing.assert_array_equal(getattr(port, field).numpy(),
                                      np.asarray(getattr(jres, field)),
                                      err_msg=field)
    for field in ("x_seq", "xnew"):
        np.testing.assert_allclose(getattr(port, field).numpy(),
                                   np.asarray(getattr(jres, field)),
                                   rtol=0, atol=ATOL, err_msg=field)
    du = np.abs(port.u_seq.numpy() - np.asarray(jres.u_seq))
    assert (du <= _u_tol(x0, K, port, jres)).all(), du.max()


def test_kernel_tool_cannot_be_imported_as_is():
    """Why the loader edits the source: the misplaced __future__ import."""
    path = REPO / "tools" / "steer_kernel_experimental.py"
    with pytest.raises(SyntaxError, match="__future__"):
        compile(path.read_text(), str(path), "exec")
    assert callable(tool.make_steer_pallas)
    assert callable(tool.make_steer_pallas_tree)


@pytest.mark.parametrize("goal_box,per_dim", [(True, False), (True, True),
                                              (False, False)],
                         ids=["goal-norm", "goal-per-dim", "no-goal-norm"])
def test_plain_steer_matches_jax_scan(goal_box, per_dim):
    """The port's steer (kernel D's plain version) against the JAX scan,
    layout "tm": length, xnew, in_goal, reached and x_seq at H = 100."""
    tol = np.full(6, TOL, np.float32) if per_dim else TOL
    x0, K, xtar, *_ = _inputs(1 + per_dim)
    gb = PROB["constraints"].goal_buffer if goal_box else None
    args, kw = _port_args(tol)
    port = make_steer(*args, saturate=kw["saturate"], goal_buffer=gb)(
        *_t(x0, K, xtar), *(_t(GOAL) if goal_box else []))
    jargs, jkw = _jargs(tol)
    jsteer = jax.jit(jmake_steer(*jargs, goal_buffer=gb, layout="tm",
                                 **jkw))
    jres = jsteer(x0, K, xtar, *([GOAL] if goal_box else []))
    _assert_same(port, jres, x0, K)
    counts = branch_counts(port, x0, xtar)
    assert counts["infeasible stop"] and counts["length 0"] \
        and counts["saturated"] and counts["psi wrapped"]
    assert bool(counts["goal stop"]) == goal_box


def _assert_held_tail(x_seq, u_seq, length):
    """For every rollout that stops (length < H): the stored x constant
    from step max(length - 1, 0) on, the stored u from step length on --
    the commits are a prefix, and a state that no longer changes gives the
    same u.  (The kernel stores that tail without recomputing it.)"""
    x_seq, u_seq = np.asarray(x_seq), np.asarray(u_seq)
    stopped = 0
    for b, L in enumerate(np.asarray(length)):
        if L == H:
            continue
        stopped += 1
        x0 = max(int(L) - 1, 0)
        np.testing.assert_array_equal(
            x_seq[x0:, :, b], np.broadcast_to(x_seq[x0, :, b], (H - x0, 6)),
            err_msg=f"x of candidate {b} (length {L})")
        np.testing.assert_array_equal(
            u_seq[L:, :, b], np.broadcast_to(u_seq[L, :, b], (H - L, 3)),
            err_msg=f"u of candidate {b} (length {L})")
    assert stopped >= B // 3


@pytest.mark.parametrize("impl", ["port", "jax"])
@pytest.mark.parametrize("goal_box,per_dim", [(True, False), (True, True),
                                              (False, False)],
                         ids=["goal-norm", "goal-per-dim", "no-goal-norm"])
def test_stopped_rollout_holds_its_tail(goal_box, per_dim, impl):
    """The held tail, on the port's steer and on the JAX scan, on
    ``branch_batch`` data (goal, arrived and infeasible stops, length 0)."""
    tol = np.full(6, TOL, np.float32) if per_dim else TOL
    x0, K, xtar, *_ = _inputs(3 + per_dim)
    gb = PROB["constraints"].goal_buffer if goal_box else None
    goal = [GOAL] if goal_box else []
    if impl == "port":
        args, kw = _port_args(tol)
        res = make_steer(*args, saturate=kw["saturate"], goal_buffer=gb)(
            *_t(x0, K, xtar, *goal))
    else:
        jargs, jkw = _jargs(tol)
        res = jax.jit(jmake_steer(*jargs, goal_buffer=gb, layout="tm",
                                  **jkw))(x0, K, xtar, *goal)
    _assert_held_tail(res.x_seq, res.u_seq, res.length)


@pytest.mark.parametrize("B", [1, 31, 8191, 8192])
def test_rollout_geometry_covers_each_candidate_once(B):
    """rollout_geometry's grid: thread t takes candidate t; each candidate
    exactly once, no block without a candidate, blocks of a multiple of 32
    threads up to MAX_THREADS, and at B = 8192 at least one block an SM of
    the H100."""
    sms = 132
    threads, blocks = rollout_geometry(B, sms)
    assert threads % 32 == 0 and 32 <= threads <= MAX_THREADS
    t = np.arange(blocks * threads)
    assert np.array_equal(np.bincount(t[t < B], minlength=B),
                          np.ones(B, np.int64))
    assert (blocks - 1) * threads < B
    if B == 8192:
        assert blocks >= sms


def test_launch_geometry_ignores_block_and_batch_tile(monkeypatch):
    """Every factory's block and batch_tile (the Pallas tile) launch the
    same geometry, rollout_geometry's for B and the SM count."""
    seen = []
    monkeypatch.setattr(steer_kernel, "_launch",
                        lambda name, *a: seen.append(a[-2:]))
    monkeypatch.setattr(steer_kernel, "sm_count", lambda dev: 132)
    monkeypatch.setattr(steer_kernel, "LAUNCHES",
                        dict.fromkeys(steer_kernel.VARIANTS, 0))
    x0, K, xtar = _t(*_inputs(0)[:3])
    args, kw = steer_args(PROB)
    for block in (32, 64, 256, 512, 1024):
        spec = steer_kernel._Spec(*args, **kw, block=block)
        spec.launch(x0, K, None, xtar, torch.from_numpy(GOAL), "flat")
    assert seen == [rollout_geometry(B, 132)] * 5


@pytest.mark.parametrize("tol", [0.05, 0.5, 1.0, 3.0, 1e-20, 0.0, 1e19,
                                 3e38, -1.0, np.inf, np.nan])
def test_sqrt_threshold_gives_the_norm_test(tol):
    """The kernel's scalar converged test, sum <= sqrt_threshold(tol), is
    sqrt(sum) <= tol for every float32 sum near the threshold, at 0, at
    inf and NaN, and on random sums (numpy's float32 sqrt is IEEE's, as
    torch's is on either device)."""
    T = sqrt_threshold(tol)
    t = np.float32(tol)
    near, lo = [T] if np.isfinite(T) else [np.float32(0)], [T]
    with np.errstate(over="ignore"):
        for _ in range(64):
            near.append(np.nextafter(near[-1], np.float32(np.inf)))
            lo.append(np.nextafter(lo[-1], np.float32(-np.inf)))
    rng = np.random.default_rng(1)
    s = np.concatenate([
        np.asarray(near + lo, np.float32),
        np.float32([0.0, -0.0, np.inf, np.nan, 3.4e38, 1e-45]),
        (rng.random(4096) * max(float(t) ** 2 * 4, 1.0)).astype(np.float32)
        if np.isfinite(t) and t > 0 else np.zeros(0, np.float32)])
    s = s[~(s < 0)]
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(s <= T, np.sqrt(s) <= t)


def test_flat_wrapper_matches_pallas_interpret():
    """make_steer_kernel on CPU tensors against make_steer_pallas in
    interpret mode (the tool's configuration: goal box, scalar tol)."""
    x0, K, xtar, *_ = _inputs(0)
    args, kw = _port_args()
    launches = dict(steer_kernel.LAUNCHES)
    port = make_steer_kernel(*args, **kw)(*_t(x0, K, xtar, GOAL))
    assert steer_kernel.LAUNCHES == launches      # the CPU launches nothing
    jargs, jkw = _jargs()
    jres = tool.make_steer_pallas(
        *jargs, goal_buffer=JPROB["constraints"].goal_buffer,
        interpret=True, **jkw)(jnp.asarray(x0), jnp.asarray(K),
                               jnp.asarray(xtar), jnp.asarray(GOAL))
    _assert_same(port, jres, x0, K)


def test_tree_wrapper_matches_pallas_tree_interpret():
    """make_steer_kernel_tree on CPU tensors (the index gather, then the
    plain steer) against make_steer_pallas_tree in interpret mode, from a
    tree of N = 1024 rows."""
    x0, _, xtar, states, KN, pids = _inputs(0)
    args, kw = _port_args()
    steer = make_steer_kernel_tree(*args, **kw)
    assert steer.takes_tree
    port = steer(*_t(states, KN, pids, xtar, GOAL))
    jargs, jkw = _jargs()
    jres = tool.make_steer_pallas_tree(
        *jargs, goal_buffer=JPROB["constraints"].goal_buffer,
        node_block=NODE_BLOCK, interpret=True, **jkw)(
            jnp.asarray(states), jnp.asarray(KN), jnp.asarray(pids),
            jnp.asarray(xtar), jnp.asarray(GOAL))
    _assert_same(port, jres, x0, KN[pids])
    flat = make_steer_kernel(*args, **kw)(*_t(x0, KN[pids], xtar, GOAL))
    for a, b in zip(port, flat):
        assert torch.equal(a, b)


MODELS = {"car": (car, jcar), "quadrotor": (quadrotor, jquadrotor),
          "double_integrator": (double_integrator, jdouble_integrator)}


def _model_inputs(name, seed=0, n_rows=N):
    """numpy x0, K (B, m, n), xtar, and a tree (n_rows rows, each with its
    own gain from the port's lqr) holding x0 at distinct random rows pids,
    for a model's ``default_problem()``.  Candidate b is in group b % 4:
    near (xtar 0.02 from x0: arrived at once), goal (x0 0.5-2.5 m short of
    the goal in x: the goal stop) or free.  Free rows of the car and the
    double integrator draw x0 and xtar in the sample space; the
    quadrotor's start near hover (roll, pitch, velocities and rates at 0.2
    of the sample space) with targets within 2 m and 0.5 rad of yaw, across
    the yaw seam for some, since a tumbling quadrotor turns one ulp into
    metres within 60 steps and no two platforms' roundings would agree."""
    prob = MODELS[name][0].default_problem()
    ss, goal = prob["sample_space"], prob["goal"]
    n, m = prob["constraints"].nstates, prob["constraints"].ncontrols
    rng = np.random.default_rng(seed)

    def uniform(k):
        x = ss[:, 0] + rng.random((k, n)) * (ss[:, 1] - ss[:, 0])
        if name == "quadrotor":
            x[:, [3, 4, 6, 7, 8, 9, 10, 11]] *= 0.2
        return x

    x0 = uniform(B)
    if name == "quadrotor":
        xtar = x0.copy()
        xtar[:, :3] += rng.uniform(-2.0, 2.0, (B, 3))
        xtar[:, [3, 4, 6, 7, 8, 9, 10, 11]] = 0.0
        yaw = x0[:, 5] + rng.uniform(-0.5, 0.5, B)
        xtar[:, 5] = (yaw + np.pi) % (2 * np.pi) - np.pi
    else:
        xtar = uniform(B)
    group = np.arange(B) % 4
    d = rng.normal(size=(B, n))
    near = x0 + 0.02 * d / np.linalg.norm(d, axis=1, keepdims=True)
    short = np.tile(goal, (B, 1))
    short[:, 0] -= rng.uniform(0.5, 2.5, B)
    x0 = np.where((group == 2)[:, None], short, x0).astype(np.float32)
    xtar = np.where((group == 1)[:, None], near,
                    np.where((group == 2)[:, None], goal, xtar)).astype(
                        np.float32)
    states = uniform(n_rows).astype(np.float32)
    pids = rng.permutation(n_rows)[:B].astype(np.int32)
    states[pids] = x0

    def gains(x):
        return prob["lqr"](torch.from_numpy(x), torch.zeros(m))[1].expand(
            len(x), m, n).contiguous().numpy()

    return prob, x0, gains(x0), xtar, states, gains(states), pids


@pytest.mark.parametrize("variant", ["flat", "tree"])
@pytest.mark.parametrize("name", list(MODELS))
def test_model_wrappers_match_pallas_interpret(name, variant):
    """make_steer_kernel and make_steer_kernel_tree of the car (H = 80),
    the quadrotor (60) and the double integrator (40) on CPU tensors (the
    plain steer) against make_steer_pallas and make_steer_pallas_tree in
    interpret mode on each model's JAX callbacks and default problem:
    all_of(control_limits, circles_free), its goal box and saturate.
    length, in_goal, reached and the mask equal; x_seq and xnew within
    ATOL; u_seq within ``_u_tol``.  The rollouts reach the goal, arrived
    and infeasible stops and the full horizon."""
    prob, x0, K, xtar, states, KN, pids = _model_inputs(name)
    jprob = MODELS[name][1].default_problem()
    H = int(round(prob["horizon"] / prob["dt"]))
    args = (prob["dynamics"], prob["erf"], prob["constraints"].is_feasible,
            H, prob["dt"], TOL)
    kw = dict(saturate=prob["saturate"],
              goal_buffer=prob["constraints"].goal_buffer)
    jargs = (jprob["dynamics"], jprob["erf"],
             jprob["constraints"].is_feasible, H, jprob["dt"], TOL)
    jkw = dict(saturate=jprob["saturate"],
               goal_buffer=jprob["constraints"].goal_buffer, interpret=True)
    goal = prob["goal"]
    if variant == "flat":
        port = make_steer_kernel(*args, **kw)(*_t(x0, K, xtar, goal))
        jres = tool.make_steer_pallas(*jargs, **jkw)(
            jnp.asarray(x0), jnp.asarray(K), jnp.asarray(xtar),
            jnp.asarray(goal))
    else:
        steer = make_steer_kernel_tree(*args, **kw)
        port = steer(*_t(states, KN, pids, xtar, goal))
        jres = tool.make_steer_pallas_tree(*jargs, node_block=NODE_BLOCK,
                                           **jkw)(
            jnp.asarray(states), jnp.asarray(KN), jnp.asarray(pids),
            jnp.asarray(xtar), jnp.asarray(goal))
        K = KN[pids]
    _assert_same(port, jres, x0, K)
    length, stopped = port.length.numpy(), port.length.numpy() < H
    reached, in_goal = port.reached.numpy(), port.in_goal.numpy()
    assert in_goal.any() and (~in_goal & reached & stopped).any()
    assert (~in_goal & ~reached & stopped).any() and (length == H).any()


def _rows(res, sel):
    """The candidates ``sel`` of a SteerResult."""
    return SteerResult(res.x_seq[..., sel], res.u_seq[..., sel],
                       res.mask[:, sel], res.length[sel], res.xnew[sel],
                       res.reached[sel], res.in_goal[sel])


def _jax_tree(states, KN, pids, xtar):
    jargs, jkw = _jargs()
    return tool.make_steer_pallas_tree(
        *jargs, goal_buffer=JPROB["constraints"].goal_buffer,
        node_block=NODE_BLOCK, interpret=True, **jkw)(
            jnp.asarray(states), jnp.asarray(KN), jnp.asarray(pids),
            jnp.asarray(xtar), jnp.asarray(GOAL))


def test_tree_pids_out_of_range_give_nan_rows():
    """Pids -1, -N, N and N + 7 give on the CPU what they give on the card:
    a NaN start row and gain, so an empty, unreached rollout of NaN x and
    u (length 0, not in the goal), and no pid wraps around (a pid in
    [-N, 0) must not read row N + pid).  The other rows equal the plain
    steer from their gathered rows, bit for bit.  The JAX tree kernel's
    one-hot gather matches no row for such a pid and gives it a zero start
    and gain instead: a rollout that holds x = 0 for all H steps (a
    deliberate difference, ROADMAP section 3)."""
    _, _, xtar, states, KN, pids = _inputs(0)
    pids[:4] = (-1, -N, N, N + 7)
    args, kw = _port_args()
    port = make_steer_kernel_tree(*args, **kw)(
        *_t(states, KN, pids, xtar, GOAL))
    bad, good = slice(0, 4), slice(4, None)
    rows = _rows(port, bad)
    assert torch.equal(rows.length, torch.zeros(4, dtype=torch.int32))
    assert not rows.reached.any() and not rows.in_goal.any()
    for field in (rows.x_seq, rows.u_seq, rows.xnew):
        assert field.isnan().all()
    safe = pids.copy()
    safe[bad] = 0
    ref = make_steer(*args, **kw)(*_t(states[safe], KN[safe], xtar, GOAL))
    for a, b in zip(_rows(port, good), _rows(ref, good)):
        assert torch.equal(a, b)
    jres = _jax_tree(states, KN, pids, xtar)
    np.testing.assert_array_equal(np.asarray(jres.x_seq)[..., bad], 0.0)
    np.testing.assert_array_equal(np.asarray(jres.length)[bad], H)


@pytest.mark.parametrize("variant", ["flat", "tree"])
def test_nan_start_rows_without_obstacles_run_the_horizon(variant):
    """Without obstacles the predicate is all-true, so a NaN start row (a
    NaN x0, or a pid outside [0, N)) is never infeasible: the rollout
    commits NaN at every step (length H, NaN x and u, not reached, not in
    the goal), which the card must give too (``chip_smoke.py``'s D repairs
    at 0 circles).  The flat rows against the JAX scan on the same
    problem: the same lengths and NaN entries, the finite rows within the
    tolerances of ``_assert_same``."""
    prob, jprob = (boat.default_problem(obstacles=False),
                   jboat.default_problem(obstacles=False))
    x0, K, xtar, states, KN, pids = _inputs(0)
    args, kw = steer_args(prob)
    bad = slice(0, 4)
    if variant == "flat":
        x0[bad] = np.nan
        port = make_steer_kernel(*args, **kw)(*_t(x0, K, xtar, GOAL))
    else:
        pids[bad] = (-1, -N, N, N + 7)
        port = make_steer_kernel_tree(*args, **kw)(
            *_t(states, KN, pids, xtar, GOAL))
    rows = _rows(port, bad)
    assert torch.equal(rows.length, torch.full((4,), H, dtype=torch.int32))
    assert not rows.reached.any() and not rows.in_goal.any()
    for field in (rows.x_seq, rows.u_seq, rows.xnew):
        assert field.isnan().all()
    assert not port.x_seq[..., 4:].isnan().any()
    if variant == "flat":
        jsteer = jax.jit(jmake_steer(
            jprob["dynamics"], jprob["erf"],
            jprob["constraints"].is_feasible, H, DT, TOL,
            goal_buffer=jprob["constraints"].goal_buffer, layout="tm",
            saturate=jprob["saturate"]))
        jres = jsteer(x0, K, xtar, GOAL)
        np.testing.assert_array_equal(port.length.numpy(),
                                      np.asarray(jres.length))
        for field in ("x_seq", "u_seq", "xnew"):
            np.testing.assert_array_equal(
                getattr(port, field).isnan().numpy(),
                np.isnan(np.asarray(getattr(jres, field))), err_msg=field)
        good = slice(4, None)
        _assert_same(_rows(port, good), jsteer(x0[good], K[good],
                                               xtar[good], GOAL),
                     x0[good], K[good])


@pytest.mark.parametrize("label", ["0 circles", "7 circles", "10 circles",
                                   "64 circles"])
def test_circle_problems_match_jax_scan(label):
    """``kernel_times.circle_problems``, which the card's checks run at
    each path of the circles test: the circle count, the default buoys
    last at 64 (``branch_batch``'s buoy group stops on circles past the
    first 8), the factories take each, and the port's steer on each
    matches the JAX scan with the same circles (``_assert_same``)."""
    prob = circle_problems()[label]
    circles = prob["constraints"].is_feasible.circles
    k = int(label.split()[0])
    assert len(circles[1]) == k <= MAX_CIRCLES
    jprob = {"0 circles": lambda: jboat.default_problem(obstacles=False),
             "7 circles": lambda: JPROB, "10 circles": jboat.hard_problem,
             "64 circles": lambda: JPROB}[label]()
    jfeas = jprob["constraints"].is_feasible
    if k == 64:
        centers, radii = many_circles()
        np.testing.assert_array_equal(centers[-7:], PROB["obstacles"][0])
        np.testing.assert_array_equal(circles[0], centers)
        jfeas = jcollision.circles_free(centers, radii, margin=1.0)
    x0, xtar, _ = branch_batch(B, 3, prob)
    K = np.broadcast_to(boat_K(prob), (B, 3, 6)).copy()
    args, kw = steer_args(prob)
    make_steer_kernel(*args, **kw)
    make_steer_kernel_tree(*args, **kw)
    port = make_steer(*args, **kw)(*_t(x0, K, xtar, GOAL))
    jres = jax.jit(jmake_steer(
        jprob["dynamics"], jprob["erf"], jfeas, H, DT, TOL,
        goal_buffer=jprob["constraints"].goal_buffer, layout="tm",
        saturate=jprob["saturate"]))(x0, K, xtar, GOAL)
    _assert_same(port, jres, x0, K)
    counts = branch_counts(port, x0, xtar)
    assert bool(counts["infeasible stop"]) == bool(k)


def test_dead_nan_rows_drop_only_themselves():
    """A NaN in tree rows no pid points at (one in states, one in K)
    changes none of the port's rollouts, which gather by index.  The JAX
    tree kernel gathers with a one-hot matmul, and 0 * NaN is NaN, so the
    same rows poison every candidate's start (a deliberate difference,
    ROADMAP section 3)."""
    _, _, xtar, states, KN, pids = _inputs(0)
    dead = np.setdiff1d(np.arange(N), pids)[:2]
    states_nan, KN_nan = states.copy(), KN.copy()
    states_nan[dead[0]] = np.nan
    KN_nan[dead[1]] = np.nan
    args, kw = _port_args()
    steer = make_steer_kernel_tree(*args, **kw)
    clean = steer(*_t(states, KN, pids, xtar, GOAL))
    port = steer(*_t(states_nan, KN_nan, pids, xtar, GOAL))
    for a, b in zip(port, clean):
        assert torch.equal(a, b)
    assert not port.x_seq.isnan().any()
    jres = _jax_tree(states_nan, KN_nan, pids, xtar)
    assert np.isnan(np.asarray(jres.x_seq)).any(axis=(0, 1)).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_branch_batch_reaches_every_branch(seed):
    """Every group of branch_batch shows its branch in the plain steer."""
    x0, xtar, group = branch_batch(4 * len(GROUPS), seed, PROB)
    args, kw = steer_args(PROB)
    res = make_steer(*args, **kw)(*_t(x0, np.broadcast_to(
        boat_K(PROB), (len(x0), 3, 6)), xtar, GOAL))
    counts = branch_counts(res, x0, xtar)
    assert min(counts.values()) > 0, counts
    length = res.length.numpy()
    name = np.array(GROUPS)[group]
    assert (length[name == "near"] == 0).all()
    assert res.in_goal.numpy()[name == "goal"].any()
    buoy = name == "buoy"
    assert ((length[buoy] < H) & ~res.reached.numpy()[buoy]).any()
    assert (np.abs(xtar[name == "wrap", 2] - x0[name == "wrap", 2])
            > np.pi).all()


def test_mask_is_the_commit_prefix():
    """Commits are a prefix, so the kernel's wrapper derives mask from
    length: the plain steer's per-step commits say the same."""
    x0, K, xtar, *_ = _inputs(3)
    args, kw = steer_args(PROB)
    res = make_steer(*args, **kw)(*_t(x0, K, xtar, GOAL))
    prefix = torch.arange(H)[:, None] < res.length[None, :]
    assert torch.equal(res.mask, prefix)


@pytest.mark.parametrize("model", [car, quadrotor], ids=["car", "quadrotor"])
def test_factory_refuses_models_without_device_functions(model):
    """A dynamics the kernel has no device functions for (the model's own
    f under Euler, not its RK4 ``dynamics``) is refused; the model's
    ``dynamics`` builds (test_factory_builds_tagged_models_and_predicates)."""
    from lqrrt_tpu_torch.ops.integrate import discretize

    prob = model.default_problem()
    args = (discretize(model.f, "euler"), prob["erf"],
            prob["constraints"].is_feasible, 10, prob["dt"], 0.05)
    for factory in (make_steer_kernel, make_steer_kernel_tree):
        with pytest.raises(NotImplementedError, match="device functions"):
            factory(*args, saturate=prob["saturate"],
                    goal_buffer=prob["constraints"].goal_buffer)


@pytest.mark.parametrize("pred", [
    collision.all_of(collision.circles_free([[1.0, 2.0]], [0.5]),
                     lambda x, u: x[..., 0] < 50.0),
    collision.state_box([-50.0, -50.0], [50.0, 50.0], dims=(0, 1)),
    lambda x, u: x[..., 0] < 50.0,
], ids=["all_of", "control_limits", "lambda"])
def test_factory_refuses_untagged_predicates(pred):
    """A predicate with no tag the kernel reads is refused: an all_of
    holding a lambda, a box on the state (``state_box``, which is not
    ``control_limits``) and a lambda."""
    args, kw = steer_args(PROB)
    for factory in (make_steer_kernel, make_steer_kernel_tree):
        with pytest.raises(NotImplementedError, match="circles tag"):
            factory(*args[:2], pred, *args[3:], **kw)


def _boat_pred(kind):
    c, r = PROB["obstacles"]
    limits = collision.control_limits(-boat.WRENCH_MAX, boat.WRENCH_MAX)
    return {"all_of": collision.all_of(collision.circles_free(c, r)),
            "control_limits": limits,
            "all_of-both": collision.all_of(
                limits, collision.all_of(collision.circles_free(c[:3], r[:3]),
                                         collision.circles_free(c[3:],
                                                                r[3:])))
            }[kind]


@pytest.mark.parametrize("case", ["car", "quadrotor", "double_integrator",
                                  "all_of", "control_limits", "all_of-both"])
def test_factory_builds_tagged_models_and_predicates(case):
    """The car, the quadrotor and the double integrator build on their
    ``default_problem()`` predicates (all_of(control_limits,
    circles_free)), and the boat on an all_of of circles, on
    control_limits alone, and on nested all_ofs of both: the spec's n, m,
    circles (concatenated in order) and box."""
    if case in ("car", "quadrotor", "double_integrator"):
        model = {"car": car, "quadrotor": quadrotor,
                 "double_integrator": double_integrator}[case]
        prob = model.default_problem()
        H = int(round(prob["horizon"] / prob["dt"]))
        args = (prob["dynamics"], prob["erf"],
                prob["constraints"].is_feasible, H, prob["dt"], 0.05)
        kw = dict(saturate=prob["saturate"],
                  goal_buffer=prob["constraints"].goal_buffer)
        centers, radii = prob["obstacles"]
        margin = {"car": 0.5, "quadrotor": 0.3, "double_integrator": 0.1}[case]
        box = (model.U_MIN, model.U_MAX_VEC) if case != "double_integrator" \
            else (-np.full(2, model.U_MAX), np.full(2, model.U_MAX))
    else:
        args, kw = steer_args(PROB)
        args = args[:2] + (_boat_pred(case),) + args[3:]
        centers, radii = PROB["obstacles"]
        margin = 0.0
        box = (-boat.WRENCH_MAX, boat.WRENCH_MAX)
        if case == "all_of":
            box = None
    for factory in (make_steer_kernel, make_steer_kernel_tree):
        assert callable(factory(*args, **kw))
    spec = steer_kernel._Spec(*args, kw["saturate"], kw["goal_buffer"], 64)
    n, m = (6, 3) if args[0] is boat.dynamics else {
        "car": (4, 2), "quadrotor": (12, 4), "double_integrator": (4, 2)}[case]
    assert (spec.n, spec.m, spec.H) == (n, m, args[3])
    if case == "control_limits":
        assert spec.ncirc == 0
    else:
        circles = spec.circles.value
        np.testing.assert_array_equal(circles[:, :2], centers)
        np.testing.assert_allclose(circles[:, 2], (radii + margin) ** 2,
                                   rtol=1e-6)
    if box is None:
        assert spec.limits is None
    else:
        np.testing.assert_array_equal(spec.limits.value,
                                      np.stack(box).astype(np.float32))


def test_nested_control_limits_intersect():
    """Two control_limits in an all_of give the intersection of their boxes,
    the same predicate."""
    a = collision.control_limits([-1.0, -2.0], [3.0, 1.0])
    b = collision.control_limits([-2.0, -1.0], [2.0, 2.0])
    circles, box, grid = steer_kernel.predicate_parts(
        collision.all_of(a, b))
    assert circles.shape == (0, 3) and grid is None
    np.testing.assert_array_equal(box[0], [-1.0, -1.0])
    np.testing.assert_array_equal(box[1], [2.0, 1.0])
    u = torch.from_numpy(np.random.default_rng(0).uniform(
        -3, 3, (4096, 2)).astype(np.float32))
    u[0, 0] = float("nan")
    lo, hi = (torch.from_numpy(v) for v in box)
    assert torch.equal(collision.all_of(a, b)(u, u),
                       ((u >= lo) & (u <= hi)).all(-1))


@pytest.mark.parametrize("change", ["erf", "saturate-none",
                                    "saturate-other", "pos-dims",
                                    "circles", "erf-untagged",
                                    "grid-pos-dims"])
def test_factory_refuses_what_the_kernel_does_not_compute(change):
    args, kw = steer_args(PROB)
    args, kw = list(args), dict(kw)
    if change == "erf":
        args[1] = make_erf(6)                       # psi not wrapped
    elif change == "erf-untagged":
        # the double integrator wraps nothing: torch.subtract builds, an
        # erf without an angle_dims tag does not
        prob = double_integrator.default_problem()
        args = [prob["dynamics"], lambda a, b: a - b,
                prob["constraints"].is_feasible, 10, prob["dt"], 0.05]
        kw = dict(saturate=prob["saturate"])
        assert callable(make_steer_kernel(*args[:1], torch.subtract,
                                          *args[2:], **kw))
    elif change == "saturate-none":
        kw["saturate"] = None
    elif change == "saturate-other":
        kw["saturate"] = lambda u: u.clamp(-100.0, 100.0)
    elif change == "pos-dims":
        args[2] = collision.circles_free([[1.0, 2.0]], [0.5],
                                         pos_dims=(1, 0))
    elif change == "grid-pos-dims":
        args[2] = collision.OccupancyGrid(np.zeros((4, 4)), [0.0, 0.0], 1.0,
                                          pos_dims=(1, 0)).feasibility()
    else:
        n = MAX_CIRCLES + 1
        args[2] = collision.circles_free(np.zeros((n, 2)), np.ones(n))
    with pytest.raises(NotImplementedError):
        make_steer_kernel(*args, **kw)


def test_circles_tag_carries_the_margin():
    centers = np.array([[1.0, 2.0], [3.0, -4.0]], np.float32)
    radii = np.array([0.5, 2.0], np.float32)
    pred = collision.circles_free(centers, radii, margin=1.0)
    tag_centers, tag_r2 = pred.circles
    np.testing.assert_array_equal(tag_centers, centers)
    np.testing.assert_allclose(tag_r2, (radii + 1.0) ** 2)
    assert pred.pos_dims == (0, 1)
    # the boat problem's predicate: its buoys, radii + 1 m
    c, r = PROB["obstacles"]
    pc, pr2 = PROB["constraints"].is_feasible.circles
    np.testing.assert_array_equal(pc, c)
    np.testing.assert_allclose(pr2, (r + 1.0) ** 2)
    # the all-true default counts as zero circles, and the kernel takes it
    assert _all_true.circles[0].shape == (0, 2)
    args, kw = steer_args(PROB)
    x0, K, xtar, *_ = _inputs(4)
    free = make_steer_kernel(*args[:2], _all_true, *args[3:], **kw)(
        *_t(x0, K, xtar, GOAL))
    ref = make_steer(*args[:2], _all_true, *args[3:], **kw)(
        *_t(x0, K, xtar, GOAL))
    assert torch.equal(free.x_seq, ref.x_seq)
    assert not branch_counts(free, x0, xtar)["infeasible stop"]


@pytest.mark.parametrize("model", ["car", "quadrotor",
                                   "double_integrator"])
def test_model_params_are_the_model_constants(model):
    """The params packers give the models' constants as float32 in the
    kernel's order (the enums of csrc/<model>_device.cuh)."""
    if model == "car":
        p = steer_kernel.car_params()
        assert p.shape == (7,)
        assert (p[0], p[1]) == (np.float32(car.A_MAX),
                                np.float32(car.DELTA_MAX))
        # PyTorch's CUDA division by a Python float multiplies by the
        # float reciprocal
        assert p[2] == np.float32(1.0) / np.float32(car.WHEELBASE)
        np.testing.assert_array_equal(p[3:5], car.U_MIN)
        np.testing.assert_array_equal(p[5:7], car.U_MAX_VEC)
    elif model == "quadrotor":
        p = steer_kernel.quadrotor_params()
        assert p.shape == (16,)
        np.testing.assert_array_equal(
            p[:5], np.float32([quadrotor.HOVER_T, quadrotor.T_MAX,
                               quadrotor.TAU_MAX, quadrotor.G, 0.2]))
        np.testing.assert_array_equal(p[5:8], quadrotor.INERTIA)
        np.testing.assert_array_equal(p[8:12], quadrotor.U_MIN)
        np.testing.assert_array_equal(p[12:16], quadrotor.U_MAX_VEC)
    else:
        p = steer_kernel.double_integrator_params()
        np.testing.assert_array_equal(p, [double_integrator.U_MAX])
    assert p.dtype == np.float32


def test_predicate_tags():
    """control_limits carries its box as float32 numpy and all_of its
    parts; the tags change nothing the predicates compute."""
    lo, hi = [-1.0, -0.5], [2.0, 0.5]
    lim = collision.control_limits(lo, hi)
    tag_lo, tag_hi = lim.control_limits
    assert tag_lo.dtype == tag_hi.dtype == np.float32
    np.testing.assert_array_equal(tag_lo, lo)
    np.testing.assert_array_equal(tag_hi, hi)
    circ = collision.circles_free([[0.0, 0.0]], [1.0])
    both = collision.all_of(lim, circ)
    assert both.parts == (lim, circ)
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -2, 2, (512, 4)).astype(np.float32))
    u = x[:, :2]
    want = (((u >= torch.tensor(lo)) & (u <= torch.tensor(hi))).all(-1)
            & (x[:, :2].pow(2).sum(-1) > 1.0))
    assert torch.equal(both(x, u), want)
    assert collision.all_of().parts == ()


def test_boat_params_are_the_model_constants():
    p = boat_params()
    assert p.dtype == np.float32 and p.shape == (14,)
    assert (p[0], p[1]) == (boat.M_MASS, boat.M_SWAY)
    np.testing.assert_array_equal(p[2:5], boat._Minv)
    np.testing.assert_array_equal(p[5:8], boat.D_LIN)
    np.testing.assert_array_equal(p[8:11], boat.D_QUAD)
    np.testing.assert_array_equal(p[11:14], boat.WRENCH_MAX)


@pytest.mark.parametrize("bad", ["float64", "non-contiguous", "shape",
                                 "no-goal", "pids-int64", "block"])
def test_wrappers_check_their_inputs(bad):
    x0, K, xtar, states, KN, pids = _t(*_inputs(5))
    goal = torch.from_numpy(GOAL)
    args, kw = steer_args(PROB)
    flat = make_steer_kernel(*args, **kw)
    tree = make_steer_kernel_tree(*args, **kw)
    with pytest.raises((TypeError, ValueError)):
        if bad == "float64":
            flat(x0.double(), K, xtar, goal)
        elif bad == "non-contiguous":
            flat(x0, K.transpose(1, 2).contiguous().transpose(1, 2), xtar,
                 goal)
        elif bad == "shape":
            flat(x0[:-1], K, xtar, goal)
        elif bad == "no-goal":
            flat(x0, K, xtar)
        elif bad == "pids-int64":
            tree(states, KN, pids.long(), xtar, goal)
        else:
            make_steer_kernel(*args, block=48, **kw)


def test_entry_point_main_on_cpu(monkeypatch, capsys):
    """The experiment end to end at a small size on the CPU, where every
    block size and the tree cell take the plain version."""
    monkeypatch.setattr(exp_steer_kernel, "REPS", 1)
    monkeypatch.setattr(exp_steer_kernel, "PLAIN_REPS", 1)
    out = exp_steer_kernel.main(device="cpu", B=64, N=1024)
    printed = capsys.readouterr().out
    assert printed.count("len_eq 1.0") == len(exp_steer_kernel.BLOCKS) + 1
    assert out["device"] == "cpu" and out["plain_ms"] > 0
    assert sorted(out["kernel"]) == sorted(exp_steer_kernel.BLOCKS)
    for c in list(out["kernel"].values()) + [out["tree"]]:
        assert c["len_eq"] == 1.0 and c["max_dx"] == 0.0 and c["ms"] > 0
    with pytest.raises(RuntimeError, match="CUDA"):
        exp_steer_kernel.main(device="cuda", B=64, N=1024)


@pytest.mark.parametrize("model", ["car", "quadrotor", "double_integrator"])
def test_entry_point_main_on_cpu_models(model, monkeypatch, capsys):
    """The experiment's ``--model`` cells at a small size on the CPU
    (``kernel_times.model_steer_inputs``: the model's own horizon, lqr and
    problem), where every block size and the tree cell take the plain
    version."""
    monkeypatch.setattr(exp_steer_kernel, "REPS", 1)
    monkeypatch.setattr(exp_steer_kernel, "PLAIN_REPS", 1)
    out = exp_steer_kernel.main(device="cpu", B=32, N=128, model=model)
    prob = MODELS[model][0].default_problem()
    assert out["model"] == model
    assert out["H"] == int(round(prob["horizon"] / prob["dt"]))
    assert f"exp_steer_kernel [{model}]" in capsys.readouterr().out
    for c in list(out["kernel"].values()) + [out["tree"]]:
        assert c["len_eq"] == 1.0 and c["max_dx"] == 0.0
    with pytest.raises(ValueError, match="unknown model"):
        exp_steer_kernel.main(device="cpu", B=32, N=128, model="plane")
