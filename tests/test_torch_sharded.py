"""The candidate-sharded rounds (``lqrrt_tpu_torch/parallel/sharded.py``,
``parallel/mesh.py``) against the JAX package's, on the CPU.

JAX runs its per-device bodies under ``shard_map`` on 2 of the conftest's
8 virtual CPU devices; the port runs a 2-rank gloo job (spawned once for
the module, ``tests/_torch_mesh_worker.py``).  Each side's rank r reads
row r of the same numpy candidate table (JAX through
``jax.lax.axis_index``), so the trees must match row for row at the
round-lockstep tolerances of tests/test_torch_round.py: the gather and the
topk collectives over three rounds from the seed tree, and one refine
round (half the batch replaces leaves, the rewire from JAX's window
start) on a full tree with no zero-length row and no root copy, where
neither refine repair of ROADMAP section 3 arises.  After eight rounds
from each rank's own generator every rank's tree is equal bit for bit.
The masked scatter ``commit_batch`` is held field for field against
JAX's, overflow included; cheap checks run in one process on a world-1
gloo group.
"""
import inspect
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import _torch_mesh_worker as W
from lqrrt_tpu.core import rounds as jrounds
from lqrrt_tpu.core.commit import commit_batch as jcommit_batch
from lqrrt_tpu.core.tree import TreeArrays as JTree
from lqrrt_tpu.core.tree import init_tree as jinit_tree
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu.parallel import mesh as jmesh
from lqrrt_tpu.parallel import sharded as jsharded
from lqrrt_tpu_torch import interop
from lqrrt_tpu_torch.core import commit, rounds
from lqrrt_tpu_torch.core.tree import TreeArrays
from lqrrt_tpu_torch.models import double_integrator as di
from lqrrt_tpu_torch.parallel import mesh as meshlib
from lqrrt_tpu_torch.parallel import sharded

torch.set_num_threads(2)

LOCAL_B = W.B // 2


def _jspec(**kw):
    return jrounds.RoundSpec(W.N_X, W.N_U, W.B, W.H, W.CAP, W.DT,
                             nn_block=W.BLK, slack=W.SLACK, **kw)


def _jseed(cap=W.CAP, slack=W.SLACK, x0=None):
    jprob = jdi.default_problem()
    S0, K0 = jprob["lqr"](None, None)
    x0 = jnp.zeros(W.N_X) if x0 is None else jnp.asarray(x0)
    return jinit_tree(cap, W.H, W.N_X, W.N_U, x0, S0, K0, 1e9, False,
                      slack=slack)


def _flat(tree, prefix):
    t = jax.device_get(tree)
    return {f"{prefix}/{f}": np.asarray(getattr(t, f)) for f in JTree._fields}


def _jax_rounds(collective, commit_mode, table, tree, keys, axis="dp"):
    """JAX's per-device body under shard_map on 2 devices (4 on a 2 x 2
    hosts x chips mesh for a tuple ``axis``), fed row ``axis_index`` of
    each round's table; the tree after each round."""
    jprob = jdi.default_problem()
    spec = _jspec(commit_all=True)
    mesh = (jmesh.make_mesh(2) if axis == "dp"
            else jmesh.make_mesh_2d(2, 2, axes=axis))

    def dev(t, key, goal, tab):
        body = jsharded.make_sharded_round_body(
            spec, jsharded.mesh_axis_size(mesh, axis), jprob["dynamics"],
            jprob["lqr"], jprob["erf"], jprob["constraints"].is_feasible,
            W.TOL, jprob["constraints"].goal_buffer,
            saturate=jprob["saturate"],
            xrand_gen=lambda k, b: tab[jax.lax.axis_index(axis)],
            collective=collective, topk=W.TOPK, commit=commit_mode,
            axis=axis)
        return body(t, key, goal, None, None, None)

    fn = jax.jit(jsharded.shard_map(dev, mesh=mesh, in_specs=(P(),) * 4,
                                    out_specs=P(), check_vma=False))
    goal = jnp.asarray(jprob["goal"])
    out = []
    for r, key in enumerate(keys):
        tree = fn(tree, key, goal, jnp.asarray(table[r]))
        out.append(jax.device_get(tree))
    return out


def _full_tree():
    """A full JAX tree grown by the sorted dense commit (no zero-length
    row) from a seed with no root copies."""
    jprob = jdi.default_problem()
    rf = jax.jit(jrounds.make_round(
        _jspec(), jprob["dynamics"], jprob["lqr"], jprob["erf"],
        jprob["constraints"].is_feasible, W.TOL,
        jprob["constraints"].goal_buffer, saturate=jprob["saturate"]))
    tree = _jseed()
    ss = jnp.asarray(jprob["sample_space"])
    gb = jnp.full((W.N_X,), 0.2)
    goal = jnp.asarray(jprob["goal"])
    for r in range(40):
        tree = rf(tree, jax.random.PRNGKey(100 + r), goal, ss, gb, goal)
        if int(tree.size) >= W.CAP:
            break
    assert int(tree.size) == W.CAP
    assert (np.asarray(tree.edge_len)[1:W.CAP] >= 1).all()
    return tree


def _table(rng, shape):
    jprob = jdi.default_problem()
    lo, hi = jprob["sample_space"][:, 0], jprob["sample_space"][:, 1]
    x = rng.uniform(lo, hi, shape + (W.N_X,)).astype(np.float32)
    x[..., 0] *= 0.5                   # keep candidates near the young tree
    take = rng.uniform(size=shape + (W.N_X,)) < 0.2
    return np.where(take, jprob["goal"], x).astype(np.float32)


def _jax_start(key, size, capacity):
    nlive = max(min(size, capacity) - 1, 1)
    return int(jax.random.randint(key, (), 0, nlive, dtype=jnp.int32))


@pytest.fixture(scope="module")
def job():
    """The port's 2-rank job and JAX's side on the same inputs."""
    rng = np.random.default_rng(21)
    jprob = jdi.default_problem()
    jS, jK = (np.asarray(a) for a in jprob["lqr"](None, None))
    seed = _jseed()
    full = _full_tree()
    lock_table = _table(rng, (W.R_ROUNDS, 2, LOCAL_B))
    lock4_table = _table(rng, (W.R_ROUNDS, 4, W.B // 4))
    refine_table = _table(rng, (1, 2, LOCAL_B // 2))
    keys = [jax.random.PRNGKey(7 + r) for r in range(W.R_ROUNDS)]
    rkey = jax.random.PRNGKey(31)
    start = _jax_start(jax.random.split(rkey)[1], W.CAP, W.CAP)
    inputs = dict(jS=jS, jK=jK, **_flat(seed, "lock/tree0"),
                  **_flat(full, "refine/tree0"), **{
                      "lock/table": lock_table,
                      "lock4/table": lock4_table,
                      "refine/table": refine_table,
                      "refine/start": np.array(start)})
    tmp2 = tempfile.mkdtemp(prefix="torch_sharded2_")
    tmp4 = tempfile.mkdtemp(prefix="torch_sharded4_")
    p2 = W.spawn(2, inputs, ["gather", "topk", "refine", "replicas",
                             "refusals"], tmp2)
    p4 = W.spawn(4, inputs, ["gather2d", "replicas"], tmp4)
    want = {c: _jax_rounds(c, "grow", lock_table, seed, keys)
            for c in ("gather", "topk")}
    want["refine"] = _jax_rounds("gather", "refine", refine_table, full,
                                 [rkey])
    want["gather2d"] = _jax_rounds("gather", "grow", lock4_table, seed, keys,
                                   axis=("host", "dp"))
    return (W.collect(p2, tmp2, timeout=240), W.collect(p4, tmp4,
                                                        timeout=240), want)


def _port_round(got, case, r):
    return {f: got[f"{case}/r{r}/{f}"] for f in JTree._fields}


@pytest.mark.parametrize("collective", ["gather", "topk", "gather2d"])
def test_sharded_round_lockstep_with_jax(job, collective):
    """gather and topk at 2 ranks; gather2d over both dims of a 2 x 2
    hosts x chips mesh (4 ranks, the rows host-major as JAX's)."""
    got2, got4, want = job
    got = got4 if collective == "gather2d" else got2
    for r in range(W.R_ROUNDS):
        for rank_out in got:
            W.assert_lockstep(_port_round(rank_out, collective, r),
                              want[collective][r])
    size = int(want[collective][-1].size)
    if collective == "topk":       # k rows a round
        assert size == 1 + W.R_ROUNDS * W.TOPK
    else:                          # every candidate row lands (commit-all)
        assert size == 1 + W.R_ROUNDS * W.B


def test_sharded_refine_round_lockstep_with_jax(job):
    got, _, want = job
    full = _full_tree()
    before = np.asarray(full.parent)
    for rank in (0, 1):
        tree = _port_round(got[rank], "refine", 0)
        W.assert_lockstep(tree, want["refine"][0])
        assert (tree["parent"] != before).sum() >= 5     # the round did work


@pytest.mark.parametrize("world", [2, 4])
def test_replicas_bitwise_equal_after_eight_rounds(job, world):
    got = job[0] if world == 2 else job[1]
    for c in ("gather", "topk"):
        for f in JTree._fields:
            for r in range(1, world):
                np.testing.assert_array_equal(
                    got[0][f"replicas/{c}/{f}"], got[r][f"replicas/{c}/{f}"],
                    err_msg=f"{c} {f} rank {r}")
        assert int(got[0][f"replicas/{c}/size"]) > 8 * (
            W.TOPK if c == "topk" else W.B) // 2
        # the ranks drew different shards
        draws = {got[r][f"replicas/{c}/first_draw"].tobytes()
                 for r in range(world)}
        assert len(draws) == world


def test_refusals_on_two_ranks(job):
    got = job[0]
    for rank in (0, 1):
        assert "must divide by the mesh 'dp' axis size 2" in str(
            got[rank]["refusals/batch"])
        assert "no 'nope' axis" in str(got[rank]["refusals/axis"])


# ---- the masked scatter commit --------------------------------------------

def _scatter_case(seed, size):
    rng = np.random.default_rng(seed)
    N, B, Hc, n, m = 24, 10, 3, 4, 2
    f32 = np.float32
    tree = dict(
        state=rng.normal(size=(N, n)).astype(f32),
        S=rng.normal(size=(N, n, n)).astype(f32),
        K=rng.normal(size=(N, m, n)).astype(f32),
        parent=rng.integers(-1, N, N).astype(np.int32),
        edge_x=rng.normal(size=(Hc, n, N)).astype(f32),
        edge_u=rng.normal(size=(Hc, m, N)).astype(f32),
        edge_len=rng.integers(0, Hc + 1, N).astype(np.int32),
        node_time=rng.uniform(0, 5, N).astype(f32),
        in_goal=rng.random(N) < 0.2,
        goal_cost=rng.uniform(0, 9, N).astype(f32),
        n_children=rng.integers(0, 3, N).astype(np.int32),
        size=np.array(size, np.int32), goal_found=np.array(False))
    length = rng.integers(0, Hc + 1, B).astype(np.int32)
    length[:2] = 1
    cands = (rng.integers(0, max(size, 1), B).astype(np.int32), length,
             rng.normal(size=(Hc, n, B)).astype(f32),
             rng.normal(size=(Hc, m, B)).astype(f32),
             rng.normal(size=(B, n)).astype(f32),
             rng.normal(size=(B, n, n)).astype(f32),
             rng.normal(size=(B, m, n)).astype(f32),
             rng.random(B) < 0.5, rng.uniform(0, 9, B).astype(f32))
    return tree, cands


@pytest.mark.parametrize("seed,size", [(0, 3), (1, 19), (2, 22), (3, 24)])
def test_commit_batch_equals_jax(seed, size):
    """Every field equal to JAX's ``commit_batch``: room for all, and
    candidates past the N rows dropped (size saturates at N)."""
    tree, cands = _scatter_case(seed, size)
    want = jax.device_get(jax.jit(lambda t, *c: jcommit_batch(t, W.DT, *c))(
        JTree(**{k: jnp.asarray(v) for k, v in tree.items()}),
        *(jnp.asarray(c) for c in cands)))
    pt = interop.tree_from_numpy(tree, device="cpu")
    out = commit.commit_batch(pt, W.DT, *(torch.from_numpy(c)
                                          for c in cands))
    assert out is pt
    got = interop.tree_to_numpy(out)
    for f in JTree._fields:
        if f != "node_time":
            np.testing.assert_array_equal(got[f], np.asarray(getattr(want, f)),
                                          err_msg=f)
    np.testing.assert_allclose(got["node_time"], np.asarray(want.node_time),
                               rtol=2e-7, atol=0)
    n_valid = int((cands[1] >= 1).sum())
    assert int(got["size"]) == min(size + n_valid, 24)
    if size + n_valid > 24:
        assert int(got["size"]) == 24          # the overflow was dropped


def test_commit_candidates_selects_as_jax():
    """slack >= batch: the dense commit-all, or the sorted dense commit
    with ``commit_all=False``; less slack: the masked scatter."""
    tree, cands = _scatter_case(4, 5)
    c = rounds.Candidates(*(torch.from_numpy(a) for a in cands))
    spec = rounds.RoundSpec(4, 2, 10, 3, 12, W.DT, slack=12)
    seen = []
    for name in ("commit_batch", "commit_batch_dense",
                 "commit_batch_dense_all"):
        fn = getattr(rounds, name)
        setattr(rounds, name, lambda *a, _n=name, _f=fn, **k: (
            seen.append(_n), _f(*a, **k))[1])
    try:
        for kw in (dict(), dict(commit_all=False)):
            rounds.commit_candidates(
                spec, interop.tree_from_numpy(tree, device="cpu"), c, **kw)
        rounds.commit_candidates(spec._replace(slack=4),
                                 interop.tree_from_numpy(tree, device="cpu"),
                                 c)
    finally:
        for name in ("commit_batch", "commit_batch_dense",
                     "commit_batch_dense_all"):
            setattr(rounds, name, getattr(commit, name))
    assert seen == ["commit_batch_dense_all", "commit_batch_dense",
                    "commit_batch"]


def test_commit_batch_dense_one_tree_equals_the_fleet_form():
    """The sorted dense commit on one tree is its scenario-axis form on a
    scenario axis of 1."""
    tree, cands = _scatter_case(5, 9)
    one = interop.tree_from_numpy(tree, device="cpu")
    commit.commit_batch_dense(one, W.DT, 20, *(torch.from_numpy(c)
                                               for c in cands))
    fleet = TreeArrays(*(t[None] for t in interop.tree_from_numpy(
        tree, device="cpu")))
    commit.commit_batch_dense(fleet, W.DT, 20, *(torch.from_numpy(c)[None]
                                                 for c in cands))
    for f, a, b in zip(TreeArrays._fields, one, fleet):
        assert torch.equal(a, b[0]), f


# ---- one process, a world-1 gloo group -------------------------------------

@pytest.fixture(scope="module")
def world1():
    init = tempfile.mktemp(prefix="torch_sharded_store_")
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    yield meshlib.make_mesh(1, device_type="cpu")
    dist.destroy_process_group()


def test_world1_gather_round_equals_the_plain_round(world1):
    """One rank: the gather round is the plain round bit for bit (the
    all-gather is a copy), and topk commits the k best in score order."""
    prob = di.default_problem()
    spec = rounds.RoundSpec(W.N_X, W.N_U, W.B, W.H, W.CAP, W.DT,
                            nn_block=W.BLK, slack=W.SLACK)
    xr = torch.from_numpy(_table(np.random.default_rng(2), (W.B,)))
    args = (prob["dynamics"], prob["lqr"], prob["erf"],
            prob["constraints"].is_feasible, W.TOL,
            prob["constraints"].goal_buffer)
    goal = torch.from_numpy(prob["goal"])
    seed = interop.tree_from_numpy(jax.device_get(_jseed()), device="cpu")
    base = interop.tree_from_numpy(interop.tree_to_numpy(seed), device="cpu")
    plain = rounds.make_round(spec, *args, saturate=prob["saturate"],
                              xrand_gen=lambda g, b: xr)
    plain(base, None, goal, None, None, None)
    mesh_t = interop.tree_from_numpy(interop.tree_to_numpy(seed),
                                     device="cpu")
    sharded.make_sharded_round(spec, world1, *args,
                               saturate=prob["saturate"],
                               xrand_gen=lambda g, b: xr)(
        mesh_t, None, goal, None, None, None)
    for f, a, b in zip(TreeArrays._fields, base, mesh_t):
        assert torch.equal(a, b), f
    # topk: the k best candidates by score, in ascending score order
    top = interop.tree_from_numpy(interop.tree_to_numpy(seed), device="cpu")
    c = rounds.make_expand(spec, *args, saturate=prob["saturate"])(
        top, xr, goal)
    order = torch.sort(sharded.candidate_scores(top, c, W.DT),
                       stable=True).indices[:W.TOPK]
    sharded.make_sharded_round(spec, world1, *args,
                               saturate=prob["saturate"],
                               xrand_gen=lambda g, b: xr, collective="topk",
                               topk=W.TOPK)(top, None, goal, None, None,
                                            None)
    assert int(top.size) == 1 + W.TOPK
    np.testing.assert_array_equal(top.state[1:1 + W.TOPK].numpy(),
                                  c.xnew[order].numpy())


def test_mesh_helpers_and_refusals(world1, monkeypatch):
    assert meshlib.axis_size(world1, "dp") == 1
    assert meshlib.axis_index(world1, "dp") == 0
    assert sharded.mesh_axis_size(world1, ("dp",)) == 1
    with pytest.raises(ValueError, match="no 'map' axis"):
        meshlib.axis_size(world1, "map")
    with pytest.raises(ValueError, match="n_devices=2"):
        meshlib.make_mesh(2, device_type="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        meshlib.make_mesh(device_type="cuda")       # no CUDA here
    assert meshlib.agree_any(True, False) == [True, False]
    assert meshlib.agree_first(3, 4) == [3, 4]
    # the backend follows the device type: a gloo world has no CUDA mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="nccl"):
        meshlib.make_mesh(device_type="cuda")
    meshlib.init_distributed("localhost:1", 1, 0)   # one process: a no-op


def test_signatures_follow_jax():
    """The bodies take the mesh where JAX takes n_dev, and (as every port
    round) a generator where JAX takes a key; no steer_fn hook."""
    js = list(inspect.signature(jsharded.make_sharded_round).parameters)
    ps = list(inspect.signature(sharded.make_sharded_round).parameters)
    assert ps == [p for p in js if p != "steer_fn"]
    js = list(inspect.signature(jsharded.make_sharded_round_body).parameters)
    ps = list(inspect.signature(sharded.make_sharded_round_body).parameters)
    assert ps == ["mesh" if p == "n_dev" else p for p in js
                  if p != "steer_fn"]
