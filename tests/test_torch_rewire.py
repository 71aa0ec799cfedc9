"""The port's refinement against the JAX package (CPU): pointer-doubling
node times, the time-masked nearest neighbour, the rewire, the refine
commit, one refine round in lockstep, and ``refine_mode="leaf_rewire"``
end to end on the double integrator.

Tolerances: node times bit for bit (the same fp32 sums in the same
order); integer fields exactly; float fields within 1e-5 absolute (the
same steer in fp32 on two platforms; states of a few metres).  Where a
zero-length row is displaced (re-parented or replaced), ``n_children``
differs from JAX's by design: the port leaves such a row out of its old
parent's count, which never counted it, and JAX subtracts it all the same.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lqrrt_tpu
from lqrrt_tpu.core import rounds as jrounds
from lqrrt_tpu.core.commit import commit_batch_refine as jcommit_refine
from lqrrt_tpu.core.rewire import make_nearest_pred as jmake_nearest_pred
from lqrrt_tpu.core.rewire import make_rewire as jmake_rewire
from lqrrt_tpu.core.rewire import recompute_node_times as jrecompute
from lqrrt_tpu.core.tree import TreeArrays as JTree
from lqrrt_tpu.core.tree import init_tree as jinit_tree
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu_torch import Planner, interop
from lqrrt_tpu_torch.core import rounds
from lqrrt_tpu_torch.core.commit import commit_batch_refine
from lqrrt_tpu_torch.core.rewire import (make_nearest_pred, make_rewire,
                                         recompute_node_times)
from lqrrt_tpu_torch.models import double_integrator as di

torch.set_num_threads(2)

ATOL = 1e-5
INT_FIELDS = ("parent", "edge_len", "n_children", "in_goal", "size",
              "goal_found")


def _port(jtree):
    return interop.tree_from_numpy(jax.device_get(jtree), device="cpu")


def _snapshot(tree):
    """Copies of the tree's fields (tree_to_numpy shares CPU memory)."""
    return {f: v.copy() for f, v in interop.tree_to_numpy(tree).items()}


def _assert_same(tree, jtree, skip=()):
    """Every field of the port's tree against the JAX tree's."""
    want = jax.device_get(jtree)._asdict()
    for f, got in interop.tree_to_numpy(tree).items():
        if f in skip:
            continue
        if f in INT_FIELDS:
            np.testing.assert_array_equal(got, want[f], err_msg=f)
        else:
            np.testing.assert_allclose(got, want[f], rtol=0, atol=ATOL,
                                       err_msg=f)


def _real_children(parent, edge_len, size):
    """Children with a real (edge_len >= 1) incoming edge, per row."""
    out = np.zeros(len(parent), np.int64)
    for i in range(1, size):
        if edge_len[i] >= 1 and parent[i] >= 0:
            out[parent[i]] += 1
    return out


# ------------------------------------------------------------ node times

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recompute_node_times_bit_equal_on_random_forests(seed):
    """tests/test_rewire.py:19: a random forest, rows in any order (a
    parent may sit at a higher row), bit for bit against JAX and within
    1e-5 of a host walk."""
    rng = np.random.default_rng(seed)
    N, live = 257, 200
    perm = np.concatenate([[0], 1 + rng.permutation(live - 1)])
    parent = np.full(N, -1, np.int32)
    edge_len = np.zeros(N, np.int32)
    for k in range(1, live):       # node perm[k] hangs below an earlier one
        parent[perm[k]] = perm[rng.integers(0, k)]
        edge_len[perm[k]] = rng.integers(0, 40)
    dt = 0.05
    got = recompute_node_times(torch.from_numpy(parent),
                               torch.from_numpy(edge_len), dt).numpy()
    want = np.asarray(jrecompute(jnp.asarray(parent), jnp.asarray(edge_len),
                                 dt))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    host = np.zeros(N)
    for k in range(1, live):
        i = perm[k]
        host[i] = host[parent[i]] + edge_len[i] * dt
    np.testing.assert_allclose(got, host, rtol=0, atol=1e-5)


def test_recompute_node_times_deep_chain():
    """tests/test_rewire.py:38: depth N - 1, the worst case of pointer
    doubling, bit for bit against JAX."""
    N = 64
    parent = np.arange(-1, N - 1, dtype=np.int32)
    edge_len = np.ones(N, np.int32)
    edge_len[0] = 0
    got = recompute_node_times(torch.from_numpy(parent),
                               torch.from_numpy(edge_len), 0.1).numpy()
    want = np.asarray(jrecompute(jnp.asarray(parent), jnp.asarray(edge_len),
                                 0.1))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got, 0.1 * np.arange(N), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------ masked nearest

def test_nearest_pred_masks():
    """tests/test_rewire.py:49: the parent mask, the strict time mask (the
    target itself is excluded) and the live mask, on both packages."""
    states = np.array([[0.0, 0], [1, 0], [2, 0], [3, 0], [10, 10], [0, 0],
                       [0, 0], [0, 0]], np.float32)
    S = np.broadcast_to(np.eye(2, dtype=np.float32), (8, 2, 2)).copy()
    node_time = np.array([0.0, 1.0, 2.0, 3.0, 0.5, 0, 0, 0], np.float32)
    nearest = make_nearest_pred(torch.subtract, block=8)
    jnearest = jmake_nearest_pred(jnp.subtract, block=8)
    for excl, want in (([2], 1), ([-1], 2)):
        got, _ = nearest(*map(torch.from_numpy, (states, S, node_time)),
                         torch.tensor(5), torch.from_numpy(states[3:4]),
                         torch.from_numpy(node_time[3:4]),
                         torch.tensor(excl), 0.05)
        jgot, _ = jnearest(*map(jnp.asarray, (states, S, node_time)),
                           jnp.asarray(5), jnp.asarray(states[3:4]),
                           jnp.asarray(node_time[3:4]), jnp.asarray(excl),
                           0.05)
        assert int(got[0]) == int(jgot[0]) == want


def test_nearest_pred_matches_jax_with_ties():
    """Integer states with repeated rows and an identity S give exact ties
    on both platforms: ids and costs equal JAX's (the first index wins),
    over blocks of 16 with a live bound, times and parents masked."""
    rng = np.random.default_rng(3)
    N, B, n = 64, 24, 3
    base = rng.integers(-3, 4, (16, n)).astype(np.float32)
    states = base[rng.integers(0, 16, N)]
    S = np.broadcast_to(np.eye(n, dtype=np.float32), (N, n, n)).copy()
    node_time = rng.integers(0, 10, N).astype(np.float32) * 0.5
    x_t = base[rng.integers(0, 16, B)] + 0.5
    time_t = rng.integers(1, 12, B).astype(np.float32) * 0.5
    time_t[:3] = 0.0                       # no predecessor: id 0, cost inf
    excl = rng.integers(0, N, B).astype(np.int32)
    ids, cost = make_nearest_pred(torch.subtract, block=16)(
        *map(torch.from_numpy, (states, S, node_time)), torch.tensor(50),
        *map(torch.from_numpy, (x_t, time_t, excl)), 0.05)
    jids, jcost = jmake_nearest_pred(jnp.subtract, block=16)(
        *map(jnp.asarray, (states, S, node_time)), jnp.asarray(50),
        *map(jnp.asarray, (x_t, time_t, excl)), 0.05)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(cost.numpy(), np.asarray(jcost))
    assert np.isinf(cost.numpy()).any() and np.isfinite(cost.numpy()).any()


def test_nearest_pred_nan_row_drops_only_itself():
    """A NaN state row costs NaN: the port drops that row only; JAX's
    jnp.min carries the NaN and drops its whole block, so it misses the
    nearest row beside it."""
    states = np.array([[0.0, 0], [5, 5], [np.nan, 0], [1, 0]], np.float32)
    S = np.broadcast_to(np.eye(2, dtype=np.float32), (4, 2, 2)).copy()
    node_time = np.zeros(4, np.float32)
    args = (states, S, node_time)
    x_t, time_t, excl = (np.array([[1.1, 0]], np.float32),
                         np.array([1.0], np.float32), np.array([-1]))
    ids, _ = make_nearest_pred(torch.subtract, block=2)(
        *map(torch.from_numpy, args), torch.tensor(4),
        *map(torch.from_numpy, (x_t, time_t, excl)), 0.05)
    jids, _ = jmake_nearest_pred(jnp.subtract, block=2)(
        *map(jnp.asarray, args), jnp.asarray(4),
        *map(jnp.asarray, (x_t, time_t, excl)), 0.05)
    assert int(ids[0]) == 3 and int(jids[0]) == 0


# --------------------------------------------------------------- rewire

H, DT, TOL = 200, 0.05, 0.05


def _rest_tree(seed, size=40, capacity=64, dup_row=None):
    """A tree of rest states [px, py, 0, 0] with inflated edge times, so
    that steering between stored states converges and rewires fire.  With
    ``dup_row``, that row is a zero-length copy of its parent (as the
    dense commit stores an empty rollout), left out of the parent's count.
    Returns the numpy fields."""
    rng = np.random.default_rng(seed)
    S, K = (np.asarray(a) for a in jdi.make_lqr()(None, None))
    n, m = 4, 2
    state = np.zeros((capacity, n), np.float32)
    parent = np.full(capacity, -1, np.int32)
    edge_len = np.zeros(capacity, np.int32)
    node_time = np.zeros(capacity, np.float32)
    edge_x = np.zeros((H, n, capacity), np.float32)
    for i in range(1, size):
        p = rng.integers(0, i)
        parent[i] = p
        if i == dup_row:
            state[i] = state[p]
        else:
            state[i, :2] = rng.uniform(-2.5, 2.5, 2)
            edge_len[i] = rng.integers(60, 150)
        node_time[i] = node_time[p] + np.float32(edge_len[i] * DT)
        edge_x[:, :, i] = state[i]
    return dict(
        state=state, S=np.broadcast_to(S, (capacity, n, n)).copy(),
        K=np.broadcast_to(K, (capacity, m, n)).copy(), parent=parent,
        edge_x=edge_x, edge_u=np.zeros((H, m, capacity), np.float32),
        edge_len=edge_len, node_time=node_time,
        in_goal=np.zeros(capacity, bool),
        goal_cost=rng.uniform(1, 50, capacity).astype(np.float32),
        n_children=_real_children(parent, edge_len, size).astype(np.int32),
        size=np.int32(size), goal_found=np.bool_(False))


def _rewires(batch, capacity=64):
    prob, jprob = di.default_problem(False), jdi.default_problem(False)
    spec = rounds.RoundSpec(nstates=4, ncontrols=2, batch=batch,
                            horizon_steps=H, capacity=capacity, dt=DT,
                            nn_block=16)
    rw = make_rewire(spec, prob["dynamics"], prob["lqr"], prob["erf"],
                     prob["constraints"].is_feasible, TOL, batch=batch,
                     saturate=prob["saturate"])
    jrw = jax.jit(jmake_rewire(spec, jprob["dynamics"], jprob["lqr"],
                               jprob["erf"],
                               jprob["constraints"].is_feasible, TOL,
                               batch=batch, saturate=jprob["saturate"]))
    return rw, jrw


def _jax_start(key, size, capacity):
    nlive = max(min(size, capacity) - 1, 1)
    return int(jax.random.randint(key, (), 0, nlive, dtype=jnp.int32))


@pytest.mark.parametrize("batch", [16, 64])
def test_rewire_matches_jax_without_zero_length_rows(batch):
    """One rewire call from JAX's window start: every field equal.  At
    batch 64 the window repeats rows past live - 1 (those repeats are
    invalid and must not disturb the rows they repeat)."""
    rw, jrw = _rewires(batch)
    d = _rest_tree(5)
    jt = JTree(**{k: jnp.asarray(v) for k, v in d.items()})
    key = jax.random.PRNGKey(3)
    jout = jrw(jt, key)
    out = rw(_port(jt), start=torch.tensor(_jax_start(key, 40, 64)))
    _assert_same(out, jout)
    moved = np.flatnonzero(out.parent.numpy() != d["parent"])
    assert len(moved) >= 3, moved           # the rewire fired
    size = int(out.size)
    np.testing.assert_array_equal(
        out.n_children.numpy(),
        _real_children(out.parent.numpy(), out.edge_len.numpy(), size))


def test_rewire_zero_length_row_keeps_the_count():
    """A zero-length row re-parented onto a shorter edge: every field as
    JAX's but n_children, where the port's equals the real count and
    JAX's is one lower at the row's old parent (rewire.py:170 decrements a
    child that was never counted)."""
    dup = 30
    rw, jrw = _rewires(64)
    d = _rest_tree(5, dup_row=dup)
    jt = JTree(**{k: jnp.asarray(v) for k, v in d.items()})
    key = jax.random.PRNGKey(3)
    jout = jax.device_get(jrw(jt, key))
    out = rw(_port(jt), start=torch.tensor(_jax_start(key, 40, 64)))
    _assert_same(out, jout, skip=("n_children",))
    old_p = d["parent"][dup]
    assert out.parent[dup] != old_p and out.edge_len[dup] >= 1
    real = _real_children(out.parent.numpy(), out.edge_len.numpy(), 40)
    np.testing.assert_array_equal(out.n_children.numpy(), real)
    diff = real - np.asarray(jout.n_children)
    assert list(np.flatnonzero(diff)) == [old_p] and diff[old_p] == 1


def test_rewire_noop_on_tiny_tree():
    """tests/test_rewire.py:149: a root-only tree is left as it is."""
    rw, _ = _rewires(4, capacity=16)
    prob = di.default_problem(False)
    x0 = torch.zeros(4)
    S0, K0 = prob["lqr"](x0, torch.zeros(2))
    from lqrrt_tpu_torch.core.tree import init_tree
    tree = init_tree(16, H, 4, 2, x0, S0, K0, torch.tensor(1e3),
                     torch.tensor(False))
    before = _snapshot(tree)
    rw(tree, gen=torch.Generator().manual_seed(1))
    for f, v in interop.tree_to_numpy(tree).items():
        np.testing.assert_array_equal(v, before[f], err_msg=f)


# --------------------------------------------------------- refine commit

def _hand_tree(zero_len_victim=False):
    """tests/test_core.py:239's tree: 0 -> {1, 2}; 1 -> {3, 4}; leaves 2
    (bad), 3 and 4 (goal), with real edges; or row 2 as a zero-length row,
    left out of row 0's count."""
    N, H2, n, m = 8, 2, 2, 1
    t = jinit_tree(N, H2, n, m, jnp.zeros(n), jnp.eye(n), jnp.zeros((m, n)),
                   50.0, False)
    edge_len = jnp.asarray([0, 1, 0 if zero_len_victim else 1, 1, 1, 0, 0,
                            0], jnp.int32)
    return t._replace(
        size=jnp.asarray(5, jnp.int32),
        parent=t.parent.at[1:5].set(jnp.asarray([0, 0, 1, 1])),
        edge_len=edge_len,
        goal_cost=t.goal_cost.at[1:5].set(
            jnp.asarray([8.0, 10.0, 5.0, 0.5])),
        in_goal=t.in_goal.at[4].set(True),
        n_children=t.n_children.at[0].set(1 if zero_len_victim else 2)
        .at[1].set(2),
        node_time=t.node_time.at[1:5].set(0.5),
        goal_found=jnp.asarray(True))


def _hand_candidates(in_goal=(False, False, False)):
    B, H2, n, m = 3, 2, 2, 1
    return dict(
        pids=np.array([3, 0, 1], np.int32),          # node 3 a parent here
        length=np.array([1, 1, 0], np.int32),        # candidate 2 empty
        x_seq=np.ones((H2, n, B), np.float32),
        u_seq=np.ones((H2, m, B), np.float32),
        xnew=np.arange(B * n, dtype=np.float32).reshape(B, n) + 100.0,
        S_new=np.tile(np.eye(n, dtype=np.float32)[None], (B, 1, 1)),
        K_new=np.zeros((B, m, n), np.float32),
        in_goal=np.array(in_goal), gcost=np.array([1.0, 20.0, 0.1],
                                                  np.float32))


def _refine_both(jt, c):
    tree = _port(jt)
    commit_batch_refine(tree, 0.1, jt.state.shape[0],
                        *(torch.from_numpy(np.asarray(v))
                          for v in c.values()))
    jout = jcommit_refine(jt, 0.1, jt.state.shape[0],
                          *(jnp.asarray(v) for v in c.values()))
    return tree, jout


def test_refine_commit_matches_jax():
    """tests/test_core.py:234: only leaf 2 is replaceable (3 is a batch
    parent, 4 in the goal); candidate 0 takes it; the root, interior,
    goal and parent rows are untouched; size stays.  Every field as JAX's;
    then a goal candidate replaces the same row again."""
    jt = _hand_tree()
    tree, jout = _refine_both(jt, _hand_candidates())
    _assert_same(tree, jout)
    assert int(tree.size) == 5 and int(tree.parent[2]) == 3
    np.testing.assert_allclose(tree.state[2].numpy(), [100.0, 101.0])
    assert float(tree.goal_cost[2]) == 1.0
    np.testing.assert_allclose(float(tree.node_time[2]), 0.6, atol=1e-6)
    assert int(tree.n_children[0]) == 1 and int(tree.n_children[3]) == 1
    tree2, jout2 = _refine_both(jout, _hand_candidates((True, False, False)))
    _assert_same(tree2, jout2)
    assert bool(tree2.in_goal[2]) and int(tree2.size) == 5


def test_refine_commit_zero_length_victim_keeps_the_count():
    """Leaf 2 a zero-length row (not in row 0's count of 1): the port
    leaves row 0 at its one real child; JAX takes it to 0, so row 0 would
    look like a leaf with a real child (commit.py:252)."""
    tree, jout = _refine_both(_hand_tree(zero_len_victim=True),
                              _hand_candidates())
    _assert_same(tree, jout, skip=("n_children",))
    real = _real_children(tree.parent.numpy(), tree.edge_len.numpy(), 5)
    np.testing.assert_array_equal(tree.n_children.numpy(), real)
    assert int(tree.n_children[0]) == 1 and int(jout.n_children[0]) == 0


def test_refine_commit_equal_scores_replace_the_lower_row_first():
    """Six leaves with one cost-to-go: the two best candidates replace
    rows 1 and 2, the lower rows first, as lax.top_k orders equal scores."""
    N, n, m, B = 16, 2, 1, 2
    t = jinit_tree(N, 2, n, m, jnp.zeros(n), jnp.eye(n), jnp.zeros((m, n)),
                   50.0, False)
    t = t._replace(size=jnp.asarray(7, jnp.int32),
                   parent=t.parent.at[1:7].set(0),
                   edge_len=t.edge_len.at[1:7].set(3),
                   goal_cost=t.goal_cost.at[1:7].set(10.0),
                   n_children=t.n_children.at[0].set(6))
    c = dict(pids=np.zeros(B, np.int32), length=np.array([2, 2], np.int32),
             x_seq=np.ones((2, n, B), np.float32),
             u_seq=np.ones((2, m, B), np.float32),
             xnew=np.array([[1.0, 1.0], [2.0, 2.0]], np.float32),
             S_new=np.tile(np.eye(n, dtype=np.float32)[None], (B, 1, 1)),
             K_new=np.zeros((B, m, n), np.float32),
             in_goal=np.zeros(B, bool),
             gcost=np.array([2.0, 1.0], np.float32))
    tree, jout = _refine_both(t, c)
    _assert_same(tree, jout)
    np.testing.assert_array_equal(tree.state[1:3].numpy(),
                                  [[2.0, 2.0], [1.0, 1.0]])
    assert (tree.state[3:7] == 0).all()


def _one_candidate(pid, gcost):
    n, m = 2, 1
    return dict(pids=np.array([pid], np.int32), length=np.array([2],
                                                                np.int32),
                x_seq=np.ones((2, n, 1), np.float32),
                u_seq=np.ones((2, m, 1), np.float32),
                xnew=np.array([[7.0, 7.0]], np.float32),
                S_new=np.eye(n, dtype=np.float32)[None],
                K_new=np.zeros((1, m, n), np.float32),
                in_goal=np.zeros(1, bool),
                gcost=np.array([gcost], np.float32))


def test_refine_commit_keeps_a_row_with_zero_length_children():
    """0 -> 1 (real edge) -> 2 (a zero-length copy of row 1, not in its
    count), rows 1 and 2 at one cost-to-go.  JAX takes row 1 (n_children 0,
    the lower row): row 2 then holds a state its parent no longer has.  The
    port keeps row 1, which a live row names as parent, and replaces row 2;
    every zero-length row still holds its parent's state."""
    N, n, m = 8, 2, 1
    t = jinit_tree(N, 2, n, m, jnp.zeros(n), jnp.eye(n), jnp.zeros((m, n)),
                   50.0, False)
    t = t._replace(size=jnp.asarray(3, jnp.int32),
                   state=t.state.at[1:3].set(3.0),
                   parent=t.parent.at[1:3].set(jnp.asarray([0, 1])),
                   edge_len=t.edge_len.at[1].set(2),
                   goal_cost=t.goal_cost.at[1:3].set(10.0),
                   n_children=t.n_children.at[0].set(1))
    tree, jout = _refine_both(t, _one_candidate(0, 1.0))
    j_state = np.asarray(jout.state)
    assert int(jout.parent[1]) == 0 and (j_state[1] == 7.0).all()
    assert (j_state[2] != j_state[1]).any()        # JAX: row 2 is stale
    got = tree.state.numpy()
    assert (got[1] == 3.0).all() and (got[2] == 7.0).all()
    assert int(tree.parent[2]) == 0 and int(tree.edge_len[2]) == 2
    np.testing.assert_array_equal(
        tree.n_children.numpy(),
        _real_children(tree.parent.numpy(), tree.edge_len.numpy(), 3))


def test_refine_commit_root_copies_are_not_victims():
    """A tree with ``root_pad = 4``: rows 1-3 are inert root copies, cost-
    to-go +inf.  JAX ranks them the worst victims and refuses the pairing
    (``isfinite(v_worst)``), so a better candidate replaces nothing; the
    port never takes a root copy and replaces the worst leaf."""
    N, n, m = 16, 2, 1
    t = jinit_tree(N, 2, n, m, jnp.zeros(n), jnp.eye(n), jnp.zeros((m, n)),
                   50.0, False, root_pad=4)
    t = t._replace(size=jnp.asarray(7, jnp.int32),
                   state=t.state.at[4:7].set(2.0),
                   parent=t.parent.at[4:7].set(0),
                   edge_len=t.edge_len.at[4:7].set(3),
                   goal_cost=t.goal_cost.at[4:7].set(
                       jnp.asarray([10.0, 30.0, 20.0])),
                   n_children=t.n_children.at[0].set(3))
    tree, jout = _refine_both(t, _one_candidate(0, 1.0))
    np.testing.assert_array_equal(np.asarray(jout.state), np.asarray(
        t.state))                                   # JAX: nothing replaced
    port, want = interop.tree_to_numpy(tree), jax.device_get(jout)._asdict()
    for f in ("state", "S", "K", "parent", "edge_len", "node_time",
              "in_goal", "goal_cost"):            # all rows but row 5
        np.testing.assert_array_equal(np.delete(port[f], 5, 0),
                                      np.delete(want[f], 5, 0), err_msg=f)
    for f in ("n_children", "size", "goal_found"):
        np.testing.assert_array_equal(port[f], want[f], err_msg=f)
    got = tree.state.numpy()
    assert (got[5] == 7.0).all() and float(tree.goal_cost[5]) == 1.0
    assert int(tree.parent[5]) == 0 and int(tree.edge_len[5]) == 2


# -------------------------------------------------- one refine round

CAP, B_ROUND = 256, 512


def _grown_di_tree():
    """A full JAX tree of the double integrator: one dense commit-all
    round of 512 candidates fills the 256 rows; 16 candidates sit at the
    root, so rows 1-16 are zero-length copies of it."""
    jprob = jdi.default_problem()
    spec = jrounds.RoundSpec(nstates=4, ncontrols=2, batch=B_ROUND,
                             horizon_steps=40, capacity=CAP, dt=0.05,
                             nn_block=128, slack=B_ROUND, commit_all=True)
    S, K = jprob["lqr"](None, None)
    goal = jnp.asarray(jprob["goal"])
    e0 = goal - jnp.zeros(4)
    tree = jinit_tree(CAP, 40, 4, 2, jnp.zeros(4), S, K, e0 @ S @ e0, False,
                      slack=B_ROUND)
    rng = np.random.default_rng(8)
    for _ in range(2):
        xr = rng.uniform(jprob["sample_space"][:, 0],
                         jprob["sample_space"][:, 1], (B_ROUND, 4))
        xr[:, 2:] *= 0.1
        xr[:16] = 0.0              # at the root: zero-length copies of it
        grow = jax.jit(jrounds.make_round(
            spec, jprob["dynamics"], jprob["lqr"], jprob["erf"],
            jprob["constraints"].is_feasible, TOL,
            jprob["constraints"].goal_buffer,
            xrand_gen=lambda k, nb, xr=xr: jnp.asarray(xr[:nb], jnp.float32),
            saturate=jprob["saturate"]))
        tree = grow(tree, jax.random.PRNGKey(0), goal, None, None, None)
    return spec, tree


def test_refine_round_lockstep():
    """The planner's refine chunk (one round, ``make_refine_round`` fed by
    the planner's sampler through xrand_gen) against JAX's
    ``make_refine_round`` on a full tree: 256 candidates replace leaves,
    256 targets are rewired.  The window covers every live row whatever
    its start, so both packages rewire the same targets.  Integer fields
    equal and floats within 1e-5, but ``n_children`` at the old parents of
    displaced zero-length rows: there the port's count is the real one and
    JAX's is lower by the number displaced."""
    jprob, prob = jdi.default_problem(), di.default_problem()
    jspec, jt = _grown_di_tree()
    assert int(jt.size) == CAP
    rng = np.random.default_rng(9)
    half = B_ROUND // 2
    xr = rng.uniform(jprob["sample_space"][:, 0],
                     jprob["sample_space"][:, 1], (half, 4)).astype(
                         np.float32)
    xr[:, 2:] = 0.0
    common = (jprob["dynamics"], jprob["lqr"], jprob["erf"],
              jprob["constraints"].is_feasible, TOL,
              jprob["constraints"].goal_buffer)
    jround = jrounds.make_refine_round(
        jspec, *common, xrand_gen=lambda k, nb: jnp.asarray(xr[:nb]),
        saturate=jprob["saturate"])
    goal = jprob["goal"]
    jout = jax.device_get(jax.jit(jround)(jt, jax.random.PRNGKey(4),
                                          jnp.asarray(goal), None, None,
                                          None))
    drawn = []

    def xrand_gen(gen, nb):
        drawn.append(nb)
        return torch.from_numpy(xr[:nb])

    planner = Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                      horizon=2.0, dt=0.05, goal0=goal, error_tol=TOL,
                      printing=False, batch_size=B_ROUND, capacity=CAP,
                      nn_block=128, saturate=prob["saturate"],
                      rounds_per_chunk=1, refine_mode="leaf_rewire",
                      device="cpu")
    chunk = planner._get_chunk(xrand_gen, 0, commit="refine")
    tree = _port(jt)
    before = _snapshot(tree)
    chunk(tree, torch.from_numpy(goal), None, None, None)
    assert drawn == [half]
    _assert_same(tree, jout, skip=("n_children",))
    after = interop.tree_to_numpy(tree)
    changed = (after["parent"] != before["parent"]) | (
        after["edge_len"] != before["edge_len"])
    assert changed[:CAP].sum() >= 10, changed.sum()   # the round did work
    displaced = np.flatnonzero(changed & (before["edge_len"] == 0))
    assert len(displaced) >= 1
    want_diff = np.zeros(len(changed), np.int64)
    np.add.at(want_diff, before["parent"][displaced], 1)
    np.testing.assert_array_equal(
        after["n_children"].astype(np.int64) - jout.n_children, want_diff)
    np.testing.assert_array_equal(
        after["n_children"],
        _real_children(after["parent"], after["edge_len"], CAP))


# ------------------------------------------------ leaf_rewire end to end

def _clock(n_chunks):
    calls = {"n": 0}

    def clock():
        calls["n"] += 1
        return 0.0 if calls["n"] <= n_chunks + 1 else 1e9
    return clock


def _leaf_rewire(pkg_planner, prob, n_chunks, **kw):
    p = pkg_planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                    horizon=prob["horizon"], dt=prob["dt"],
                    goal0=prob["goal"], printing=False, batch_size=64,
                    capacity=256, nn_block=128, saturate=prob["saturate"],
                    seed=7, rounds_per_chunk=2, refine_mode="leaf_rewire",
                    **kw)
    p.sys_time = _clock(n_chunks)
    p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                  pruning=False, specific_time=1.0)
    return p


def _tree_faults(t, dynamics):
    """(rows whose n_children is below their real count, rows whose real
    incoming edge does not start at its parent's state, zero-length rows
    whose state is not their parent's) of a numpy tree dict."""
    size = int(t["size"])
    parent, edge_len = t["parent"][:size], t["edge_len"][:size]
    real = _real_children(parent, edge_len, size)
    under = np.flatnonzero(t["n_children"][:size] < real[:size])
    rows = np.flatnonzero((edge_len >= 1) & (np.arange(size) >= 1))
    x1 = dynamics(t["state"][parent[rows]], t["edge_u"][0, :, rows])
    bad = rows[np.abs(x1 - t["edge_x"][0, :, rows]).max(1) > 1e-4]
    dup = np.flatnonzero((edge_len == 0) & (parent >= 0)
                         & (np.arange(size) >= 1))
    stale = dup[(t["state"][dup] != t["state"][parent[dup]]).any(1)]
    return under, bad, stale


def _port_dyn(prob):
    return lambda x, u: prob["dynamics"](
        torch.from_numpy(np.ascontiguousarray(x)),
        torch.from_numpy(np.ascontiguousarray(u)), prob["dt"]).numpy()


def test_leaf_rewire_refines_past_capacity():
    """tests/test_planner_e2e.py:392 on the port (CPU): once the tree
    fills, the budget runs refine chunks on the same tree: the refine
    chunk is built (key index 3), no restart, the goal, and more budget
    never lengthens the plan; the plan is feasible and dynamically
    consistent."""
    prob = di.default_problem()
    short = _leaf_rewire(Planner, prob, 10, device="cpu")
    long = _leaf_rewire(Planner, prob, 40, device="cpu")
    assert short.plan_reached_goal and long.plan_reached_goal
    assert any(k[3] == "refine" for k in long._chunk_cache), \
        list(long._chunk_cache)
    assert long.stats["restarts"] == 0
    assert long.stats["plan_duration_s"] <= \
        short.stats["plan_duration_s"] + 1e-6
    x, u = long.x_seq, long.u_seq
    assert prob["constraints"].is_feasible(torch.from_numpy(x[1:]),
                                           torch.from_numpy(u)).all()
    err = np.abs(_port_dyn(prob)(x[:-1], u) - x[1:]).max(1)
    assert np.median(err) < 1e-3 and err.max() < 0.2, err.max()


@pytest.fixture(scope="module")
def seed7_trees():
    """The trees of both packages after the shapes of
    tests/test_planner_e2e.py:392 (seed 7, 40 chunks), with each package's
    tree faults (``_tree_faults``)."""
    prob, jprob = di.default_problem(), jdi.default_problem()
    jp = _leaf_rewire(lqrrt_tpu.Planner, jprob, 40)
    jt = jax.device_get(jp._device_tree)._asdict()
    jdyn = jax.jit(jax.vmap(lambda x, u: jprob["dynamics"](x, u,
                                                           jprob["dt"])))
    j_faults = _tree_faults(
        jt, lambda x, u: np.asarray(jdyn(jnp.asarray(x), jnp.asarray(u))))
    p = _leaf_rewire(Planner, prob, 40, device="cpu")
    assert p.stats["rounds"] > 20 and any(
        k[3] == "refine" for k in p._chunk_cache)
    t = interop.tree_to_numpy(p._device_tree)
    return j_faults, t, _tree_faults(t, _port_dyn(prob))


def test_child_counts_jax_undercounts_and_the_port_does_not(seed7_trees):
    """At the shapes of tests/test_planner_e2e.py:392 (seed 7, 40 chunks)
    the JAX tree has rows whose n_children is below their real child
    count (commit.py:252, rewire.py:170); the port's has none, and every
    real edge of it starts at its parent's state."""
    (j_under, _, _), t, (under, bad, _) = seed7_trees
    assert len(j_under) > 0
    assert len(under) == 0 and len(bad) == 0, (under, bad)
    np.testing.assert_array_equal(
        t["n_children"][:256],
        _real_children(t["parent"], t["edge_len"], 256)[:256])


def test_zero_length_rows_hold_their_parents_state_jax_does_not(
        seed7_trees):
    """The same run: JAX replaced a row whose only children were
    zero-length rows (commit.py:242-245), so a zero-length row holds a
    state its parent no longer has; in the port every zero-length row
    holds its parent's state exactly."""
    (_, _, j_stale), _, (_, _, stale) = seed7_trees
    assert len(j_stale) > 0
    assert len(stale) == 0, stale


def test_leaf_rewire_with_a_grid_raises():
    """The reference's ValueError for leaf_rewire with a feasibility_grid
    (lqrrt_tpu/planner.py:251); without the grid the mode is ported; a
    feasibility_grid alone needs a mesh, as the reference's
    (lqrrt_tpu/planner.py:123-125)."""
    prob = di.default_problem()
    args = (prob["dynamics"], prob["lqr"], prob["constraints"])
    with pytest.raises(ValueError, match="leaf_rewire"):
        Planner(*args, horizon=2.0, refine_mode="leaf_rewire",
                feasibility_grid=object(), device="cpu")
    Planner(*args, horizon=2.0, refine_mode="leaf_rewire", device="cpu")
    with pytest.raises(ValueError, match="requires mesh"):
        Planner(*args, horizon=2.0, device="cpu", feasibility_grid=object())
