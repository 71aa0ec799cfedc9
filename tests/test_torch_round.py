"""Round lockstep on the boat (its circles and its occupancy grid) and the
car (CPU): a tree grown by JAX rounds
is carried into the port with ``interop``, and the same numpy candidates go
through JAX ``make_expand`` + ``commit_candidates`` and through the port's.

Candidates and committed rows must agree on >= 99% of rows; a differing
nearest pick is judged by its fp64 metric excess (<= 1e-4 relative).
Rollout states where lengths agree: atol 1e-3 (f32 over 100 RK4 steps).
The car's per-node (S, K) come from two fp32 CARE solvers (Gauss-Jordan in
JAX, LU here): rtol/atol 2e-3, as in tests/test_riccati.py.  With a per-node
S, an empty-rollout row (a copy of its parent's state) no longer ties its
parent exactly: their S differ in the last bits, so either may win.  Such a
pick is equivalent: the same state, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lqrrt_tpu.core import rounds as jrounds
from lqrrt_tpu.core.tree import TreeArrays as JTree
from lqrrt_tpu.core.tree import best_node as jbest_node
from lqrrt_tpu.core.tree import init_tree as jinit_tree
from lqrrt_tpu.models import boat as jboat
from lqrrt_tpu.models import car as jcar
from lqrrt_tpu.planner import _chunk_stats as jchunk_stats
from lqrrt_tpu_torch import interop
from lqrrt_tpu_torch.core import rounds
from lqrrt_tpu_torch.core.tree import best_node
from lqrrt_tpu_torch.models import boat, car
from lqrrt_tpu_torch.ops.kernels.nn_kernel import (make_nearest_const,
                                                   make_nearest_general)
from lqrrt_tpu_torch.planner import _chunk_stats

torch.set_num_threads(2)

B, CAP, SLACK, PAD, H = 512, 4096, 1024, 512, 100
GOAL = np.array([6.0, 0.0, 0.0, 0.0, 0.0, 0.0], np.float32)
WRAP = np.array([False, False, True, False, False, False])


def _xrand(rng, prob):
    lo, hi = prob["sample_space"][:, 0], prob["sample_space"][:, 1]
    x = rng.uniform(lo, hi, (B, 6)).astype(np.float32)
    x[:, 0] *= 0.3                     # keep candidates near the young tree
    take = rng.uniform(size=(B, 6)) < np.array([0.3, 0.3, 0, 0, 0, 0])
    return np.where(take, GOAL, x).astype(np.float32)


def _lockstep(model):
    """JAX rounds on the boat with obstacle model ``model``: the tree
    after three, the fourth round's candidates and the tree after it."""
    jprob = jboat.default_problem(obstacle_model=model)
    jS, jK = (np.asarray(a) for a in jprob["lqr"](None, None))
    jspec = jrounds.RoundSpec(nstates=6, ncontrols=3, batch=B,
                              horizon_steps=H, capacity=CAP, dt=0.05,
                              slack=SLACK, commit_all=True, lane_block=PAD)
    gb = jprob["constraints"].goal_buffer
    jexpand = jax.jit(jrounds.make_expand(
        jspec, jprob["dynamics"], jprob["lqr"], jprob["erf"],
        jprob["constraints"].is_feasible, 0.05, gb, wrap_mask=WRAP,
        saturate=jprob["saturate"]))
    jcommit = jax.jit(lambda t, c: jrounds.commit_candidates(jspec, t, c))
    x0 = jnp.zeros(6, jnp.float32)
    e0 = jprob["erf"](jnp.asarray(GOAL), x0)
    tree = jinit_tree(CAP, H, 6, 3, x0, jnp.asarray(jS), jnp.asarray(jK),
                      e0 @ jnp.asarray(jS) @ e0, False, slack=SLACK,
                      root_pad=PAD)
    rng = np.random.default_rng(0)
    for _ in range(3):
        tree = jcommit(tree, jexpand(tree, jnp.asarray(_xrand(rng, jprob)),
                                     jnp.asarray(GOAL)))
    tree_np = jax.device_get(tree)
    xr = _xrand(rng, jprob)
    jc = jax.device_get(jexpand(tree, jnp.asarray(xr), jnp.asarray(GOAL)))
    jafter = jax.device_get(jcommit(tree, jexpand(tree, jnp.asarray(xr),
                                                  jnp.asarray(GOAL))))
    return dict(jS=jS, jK=jK, tree_np=tree_np, xr=xr, jc=jc,
                jafter=jafter, gb=gb, model=model)


@pytest.fixture(scope="module")
def lockstep():
    return _lockstep("circles")


@pytest.fixture(scope="module")
def grid_lockstep():
    return _lockstep("grid")


def _port_round(d, nearest_fn, is_feasible=None):
    tprob = boat.default_problem(obstacle_model=d["model"])
    if is_feasible is None:
        is_feasible = tprob["constraints"].is_feasible
    spec = rounds.RoundSpec(nstates=6, ncontrols=3, batch=B, horizon_steps=H,
                            capacity=CAP, dt=0.05, slack=SLACK)
    expand = rounds.make_expand(
        spec, tprob["dynamics"], interop.lqr_from_numpy(d["jS"], d["jK"]),
        tprob["erf"], is_feasible, 0.05, d["gb"],
        wrap_mask=WRAP, saturate=tprob["saturate"], nearest_fn=nearest_fn)
    tree = interop.tree_from_numpy(d["tree_np"], device="cpu")
    c = expand(tree, torch.from_numpy(d["xr"]), torch.from_numpy(GOAL))
    return tree, c, rounds.commit_candidates(spec, tree, c)


def _nn_excess(tree_np, xr, ids, ids_ref, S=None):
    """fp64 relative metric excess of picks ``ids`` over ``ids_ref`` under
    one shared S, or under the tree's per-node S when S is None."""
    st = np.asarray(tree_np.state, np.float64)
    S = np.asarray(tree_np.S if S is None else S, np.float64)

    def cost(i):
        e = xr.astype(np.float64) - st[i]
        e[:, 2] = np.mod(e[:, 2] + np.pi, 2 * np.pi) - np.pi
        Si = S[i] if S.ndim == 3 else np.broadcast_to(S, (len(i),) + S.shape)
        return np.einsum("bi,bij,bj->b", e, Si, e)
    c, c_ref = cost(ids), cost(ids_ref)
    return np.max((c - c_ref) / np.maximum(np.abs(c_ref), 1e-6))


@pytest.mark.parametrize("nn", ["plain", "nn_const"])
def test_round_lockstep(lockstep, nn):
    _check_lockstep(lockstep, nn)


@pytest.mark.parametrize("nn", ["plain", "nn_const"])
def test_grid_round_lockstep(grid_lockstep, nn):
    """The same round on the grid boat (boat.default_problem(obstacle_model=
    "grid")): the same candidates and rows as the JAX round, and the grid
    really stops rollouts (lengths differ from an obstacle-free round)."""
    _check_lockstep(grid_lockstep, nn)
    _, free, _ = _port_round(grid_lockstep, None,
                             lambda x, u: torch.ones(x.shape[:-1],
                                                     dtype=torch.bool))
    length = np.asarray(grid_lockstep["jc"].length)
    assert (free.length.numpy() > length).sum() >= 100


def _check_lockstep(d, nn):
    jc, jt = d["jc"], d["jafter"]
    fn = None if nn == "plain" else make_nearest_const(wrap_dim=2)
    tree, c, after = _port_round(d, fn)
    assert after is tree                          # committed in place

    pids, jpids = c.pids.numpy(), np.asarray(jc.pids)
    assert np.mean(pids == jpids) >= 0.99
    assert _nn_excess(d["tree_np"], d["xr"], pids, jpids, S=d["jS"]) <= 1e-4
    length, jlength = c.length.numpy(), np.asarray(jc.length)
    same = (pids == jpids) & (length == jlength)
    assert same.mean() >= 0.99
    assert np.mean(c.in_goal.numpy() == np.asarray(jc.in_goal)) >= 0.99
    assert np.asarray(jc.in_goal).any()           # the goal box is exercised
    np.testing.assert_allclose(c.x_seq.numpy()[:, :, same],
                               np.asarray(jc.x_seq)[:, :, same], atol=1e-3)
    np.testing.assert_allclose(c.u_seq.numpy()[:, :, same],
                               np.asarray(jc.u_seq)[:, :, same],
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(c.xnew.numpy()[same],
                               np.asarray(jc.xnew)[same], atol=1e-3)
    np.testing.assert_allclose(c.gcost.numpy()[same],
                               np.asarray(jc.gcost)[same], rtol=1e-3,
                               atol=1e-3)

    got = interop.tree_to_numpy(after)
    assert int(got["size"]) == int(jt.size)
    assert bool(got["goal_found"]) == bool(jt.goal_found)
    rows = (np.asarray(jt.parent) == got["parent"]) & (
        np.asarray(jt.edge_len) == got["edge_len"])
    assert rows.mean() >= 0.99
    for f in ("in_goal", "n_children"):
        assert np.mean(got[f] == np.asarray(getattr(jt, f))) >= 0.99
    # parent time + length * dt: equal up to XLA's fused multiply-add (1 ulp)
    np.testing.assert_allclose(got["node_time"][rows],
                               np.asarray(jt.node_time)[rows], rtol=2e-7,
                               atol=0)
    np.testing.assert_allclose(got["state"][rows],
                               np.asarray(jt.state)[rows], atol=1e-3)
    np.testing.assert_allclose(got["edge_x"][:, :, rows],
                               np.asarray(jt.edge_x)[:, :, rows], atol=1e-3)


def test_make_round_with_xrand_gen_matches_expand_and_commit(lockstep):
    """make_round drawing its candidates from ``xrand_gen`` commits the same
    tree as expand + commit_candidates on those candidates."""
    d = lockstep
    tprob = boat.default_problem()
    spec = rounds.RoundSpec(nstates=6, ncontrols=3, batch=B, horizon_steps=H,
                            capacity=CAP, dt=0.05, slack=SLACK)
    round_fn = rounds.make_round(
        spec, tprob["dynamics"], interop.lqr_from_numpy(d["jS"], d["jK"]),
        tprob["erf"], tprob["constraints"].is_feasible, 0.05, d["gb"],
        wrap_mask=WRAP, saturate=tprob["saturate"],
        xrand_gen=lambda gen, batch: torch.from_numpy(d["xr"][:batch]))
    tree = interop.tree_from_numpy(d["tree_np"], device="cpu")
    out = round_fn(tree, torch.Generator(), torch.from_numpy(GOAL), None,
                   None, None)
    _, _, want = _port_round(d, None)
    got, want = interop.tree_to_numpy(out), interop.tree_to_numpy(want)
    for f in got:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_stats_and_best_node_on_carried_tree(lockstep):
    d = lockstep
    jtree = JTree(**{f: jnp.asarray(getattr(d["tree_np"], f))
                     for f in JTree._fields})
    tree = interop.tree_from_numpy(d["tree_np"], device="cpu")
    assert int(best_node(tree)) == int(jbest_node(jtree))
    np.testing.assert_array_equal(_chunk_stats(tree).numpy(),
                                  np.asarray(jchunk_stats(jtree)))


def test_interop_round_trip(lockstep):
    d = lockstep
    back = interop.tree_to_numpy(
        interop.tree_from_numpy(d["tree_np"], device="cpu"))
    for f in JTree._fields:
        a = np.asarray(getattr(d["tree_np"], f))
        assert back[f].dtype == a.dtype, f
        np.testing.assert_array_equal(back[f], a)
    # the JAX tree rebuilds from the port's dict
    JTree(**{f: jnp.asarray(v) for f, v in back.items()})


# ---- the car: a per-node (re-linearized) lqr -------------------------------

CAR_GOAL = np.array([6.0, 0.0, 0.0, 0.0], np.float32)
CAR_WRAP = np.array([False, False, True, False])
CAR_H = 80


def _car_xrand(rng, prob):
    lo, hi = prob["sample_space"][:, 0], prob["sample_space"][:, 1]
    x = rng.uniform(lo, hi, (B, 4)).astype(np.float32)
    x[:, 0] *= 0.3                     # keep candidates near the young tree
    take = rng.uniform(size=(B, 4)) < np.array([0.3, 0.3, 0, 0])
    return np.where(take, CAR_GOAL, x).astype(np.float32)


@pytest.fixture(scope="module")
def car_lockstep():
    jprob = jcar.default_problem()
    jspec = jrounds.RoundSpec(nstates=4, ncontrols=2, batch=B,
                              horizon_steps=CAR_H, capacity=CAP, dt=0.05,
                              slack=SLACK, commit_all=True, lane_block=PAD)
    gb = jprob["constraints"].goal_buffer
    jexpand = jax.jit(jrounds.make_expand(
        jspec, jprob["dynamics"], jprob["lqr"], jprob["erf"],
        jprob["constraints"].is_feasible, 0.05, gb, wrap_mask=CAR_WRAP,
        saturate=jprob["saturate"]))
    jcommit = jax.jit(lambda t, c: jrounds.commit_candidates(jspec, t, c))
    x0 = jnp.asarray(jprob["x0"])
    S0, K0 = jprob["lqr"](x0, jnp.zeros(2, jnp.float32))
    e0 = jprob["erf"](jnp.asarray(CAR_GOAL), x0)
    tree = jinit_tree(CAP, CAR_H, 4, 2, x0, S0, K0, e0 @ S0 @ e0, False,
                      slack=SLACK, root_pad=PAD)
    rng = np.random.default_rng(1)
    for _ in range(3):
        tree = jcommit(tree, jexpand(tree,
                                     jnp.asarray(_car_xrand(rng, jprob)),
                                     jnp.asarray(CAR_GOAL)))
    tree_np = jax.device_get(tree)
    xr = _car_xrand(rng, jprob)
    jc_dev = jexpand(tree, jnp.asarray(xr), jnp.asarray(CAR_GOAL))
    return dict(tree_np=tree_np, xr=xr, jc=jax.device_get(jc_dev),
                jafter=jax.device_get(jcommit(tree, jc_dev)), gb=gb)


@pytest.mark.parametrize("nn", ["plain", "nn_general"])
def test_car_round_lockstep(car_lockstep, nn):
    d = car_lockstep
    jc, jt = d["jc"], d["jafter"]
    tprob = car.default_problem()
    spec = rounds.RoundSpec(nstates=4, ncontrols=2, batch=B,
                            horizon_steps=CAR_H, capacity=CAP, dt=0.05,
                            slack=SLACK)
    expand = rounds.make_expand(
        spec, tprob["dynamics"], tprob["lqr"], tprob["erf"],
        tprob["constraints"].is_feasible, 0.05, d["gb"], wrap_mask=CAR_WRAP,
        saturate=tprob["saturate"],
        nearest_fn=None if nn == "plain" else make_nearest_general(2))
    tree = interop.tree_from_numpy(d["tree_np"], device="cpu")
    # the carried tree holds a per-node S and K, one per row
    assert not np.allclose(tree.S[0].numpy(), tree.S[PAD].numpy())
    c = expand(tree, torch.from_numpy(d["xr"]), torch.from_numpy(CAR_GOAL))
    after = rounds.commit_candidates(spec, tree, c)

    pids, jpids = c.pids.numpy(), np.asarray(jc.pids)
    st = np.asarray(d["tree_np"].state)
    equiv = (st[pids] == st[jpids]).all(1)        # the same id or its copy
    assert equiv.all() and np.mean(pids == jpids) >= 0.9
    assert _nn_excess(d["tree_np"], d["xr"], pids, jpids) <= 1e-4
    length, jlength = c.length.numpy(), np.asarray(jc.length)
    same = equiv & (length == jlength)
    assert same.mean() >= 0.99
    assert np.mean(c.in_goal.numpy() == np.asarray(jc.in_goal)) >= 0.99
    np.testing.assert_allclose(c.x_seq.numpy()[:, :, same],
                               np.asarray(jc.x_seq)[:, :, same], atol=1e-3)
    np.testing.assert_allclose(c.xnew.numpy()[same],
                               np.asarray(jc.xnew)[same], atol=1e-3)
    for f in ("S_new", "K_new", "gcost"):
        np.testing.assert_allclose(getattr(c, f).numpy()[same],
                                   np.asarray(getattr(jc, f))[same],
                                   rtol=2e-3, atol=2e-3, err_msg=f)

    got = interop.tree_to_numpy(after)
    assert int(got["size"]) == int(jt.size)
    assert bool(got["goal_found"]) == bool(jt.goal_found)
    jparent = np.asarray(jt.parent)
    new = np.arange(int(d["tree_np"].size), int(jt.size))
    rows = np.ones(len(jparent), bool)
    rows[new] = ((st[got["parent"][new]] == st[jparent[new]]).all(1)
                 & (np.asarray(jt.edge_len)[new] == got["edge_len"][new]))
    rows[:int(d["tree_np"].size)] = (jparent == got["parent"])[
        :int(d["tree_np"].size)]
    assert rows.mean() >= 0.99
    assert np.mean(got["in_goal"] == np.asarray(jt.in_goal)) >= 0.99
    np.testing.assert_allclose(got["state"][rows],
                               np.asarray(jt.state)[rows], atol=1e-3)
    np.testing.assert_allclose(got["edge_x"][:, :, rows],
                               np.asarray(jt.edge_x)[:, :, rows], atol=1e-3)
    # per-node (S, K) land on their own rows (a mix-up of rows would show)
    for f in ("S", "K"):
        np.testing.assert_allclose(got[f][rows], np.asarray(getattr(jt, f))
                                   [rows], rtol=2e-3, atol=2e-3, err_msg=f)


def test_car_interop_round_trip(car_lockstep):
    d = car_lockstep
    back = interop.tree_to_numpy(
        interop.tree_from_numpy(d["tree_np"], device="cpu"))
    for f in JTree._fields:
        a = np.asarray(getattr(d["tree_np"], f))
        assert back[f].dtype == a.dtype, f
        np.testing.assert_array_equal(back[f], a)
    assert back["S"].shape == (CAP + SLACK, 4, 4)
    assert back["K"].shape == (CAP + SLACK, 2, 4)
    JTree(**{f: jnp.asarray(v) for f, v in back.items()})


def test_tree_from_numpy_defaults_to_the_card():
    """Like ``Planner``, the carrier of the JAX package's state puts it on
    the card unless the caller asks for the CPU (no card needed here)."""
    import inspect

    from lqrrt_tpu_torch import Planner

    default = inspect.signature(interop.tree_from_numpy) \
        .parameters["device"].default
    assert default == "cuda"
    assert default == inspect.signature(Planner).parameters["device"].default
