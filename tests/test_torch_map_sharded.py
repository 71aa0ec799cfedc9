"""The map-sharded rounds (``lqrrt_tpu_torch/parallel/map_sharded.py``)
against the JAX package's, on the CPU: the wall-with-a-gap grid of
tests/test_map_sharded.py on the double integrator.

JAX runs ``make_map_sharded_round`` on 2 of the conftest's 8 virtual CPU
devices and ``make_dp_map_round_body`` under ``shard_map`` on a 2 x 2
(dp, map) mesh; the port runs a 2-rank and a 4-rank gloo job (spawned once
each, ``tests/_torch_mesh_worker.py``).  Both draw the same numpy
candidates (the map round's sampler returns its sample space, which holds
them; the dp x map body's ``xrand_gen`` reads its dp row of a table), so
the trees must match row for row at the round-lockstep tolerances.  After
eight dp x map rounds from each dp row's own generator, the 4 ranks' trees
are equal bit for bit.  On one rank, the truncation is exact: the
map-sharded round commits what the plain round commits with the whole grid
checked while steering.
"""
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
from lqrrt_tpu.core.tree import TreeArrays as JTree
from lqrrt_tpu.core.tree import init_tree as jinit_tree
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu.parallel import map_sharded as jmap
from lqrrt_tpu.parallel import mesh as jmesh
from lqrrt_tpu.parallel.sharded import shard_map
from lqrrt_tpu_torch import interop
from lqrrt_tpu_torch.core import rounds
from lqrrt_tpu_torch.models import double_integrator as di
from lqrrt_tpu_torch.ops.collision import grid_free_data
from lqrrt_tpu_torch.parallel import map_sharded as pm
from lqrrt_tpu_torch.parallel import mesh as meshlib

torch.set_num_threads(2)


def _jspec():
    return jrounds.RoundSpec(W.N_X, W.N_U, W.MB, W.H, W.MCAP, W.DT,
                             nn_block=W.BLK, slack=W.MB)


def _jseed():
    jprob = jdi.default_problem(obstacles=False)
    S0, K0 = jprob["lqr"](None, None)
    return jinit_tree(W.MCAP, W.H, W.N_X, W.N_U, jnp.asarray(W.GRID_X0), S0,
                      K0, 1e9, False, slack=W.MB)


def _table(rng, shape):
    lo, hi = W.GRID_SS[:, 0], W.GRID_SS[:, 1]
    x = rng.uniform(lo, hi, shape + (W.N_X,)).astype(np.float32)
    take = rng.uniform(size=shape + (W.N_X,)) < np.array([0.3, 0.3, 0, 0])
    return np.where(take, W.GRID_GOAL, x).astype(np.float32)


def _flat(tree, prefix):
    t = jax.device_get(tree)
    return {f"{prefix}/{f}": np.asarray(getattr(t, f)) for f in JTree._fields}


def _jax_map_rounds(table, sgrid):
    """JAX's map-sharded round on 2 map devices, its sampler returning the
    sample space: the table's round."""
    jprob = jdi.default_problem(obstacles=False)
    mesh = jmesh.make_mesh(2, axis="map")
    zeros = jnp.zeros(W.N_X)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jmap, "sample_batch", lambda key, nb, ss, gb, bt: ss)
        rf = jax.jit(jmap.make_map_sharded_round(
            _jspec(), mesh, sgrid, jprob["dynamics"], jprob["lqr"],
            jprob["erf"], lambda x, u: jnp.bool_(True), W.TOL,
            jprob["constraints"].goal_buffer))
        tree, out = _jseed(), []
        for xr in table:
            tree = rf(tree, jnp.asarray(sgrid.occ_sharded),
                      jax.random.PRNGKey(0), jnp.asarray(W.GRID_GOAL),
                      jnp.asarray(xr), zeros, zeros)
            out.append(jax.device_get(tree))
    return out


def _jax_dp_map_rounds(table, sgrid):
    """JAX's dp x map body under shard_map on a 2 x 2 mesh, each dp row
    reading its row of the round's table."""
    jprob = jdi.default_problem(obstacles=False)
    mesh = jmesh.make_mesh_dp_map(2, 2)

    def dev(t, slab, key, goal, tab):
        body = jmap.make_dp_map_round_body(
            _jspec(), 2, 2, sgrid, jprob["dynamics"], jprob["lqr"],
            jprob["erf"], lambda x, u: jnp.bool_(True), W.TOL,
            jprob["constraints"].goal_buffer,
            xrand_gen=lambda k, b: tab[jax.lax.axis_index("dp")])
        return body(t, slab, key, goal, None, None, None)

    fn = jax.jit(shard_map(dev, mesh=mesh,
                           in_specs=(P(), P("map"), P(), P(), P()),
                           out_specs=P(), check_vma=False))
    tree, out = _jseed(), []
    for tab in table:
        tree = fn(tree, jnp.asarray(sgrid.occ_sharded),
                  jax.random.PRNGKey(0), jnp.asarray(W.GRID_GOAL),
                  jnp.asarray(tab))
        out.append(jax.device_get(tree))
    return out


@pytest.fixture(scope="module")
def jobs():
    rng = np.random.default_rng(12)
    jprob = jdi.default_problem(obstacles=False)
    jS, jK = (np.asarray(a) for a in jprob["lqr"](None, None))
    occ, origin, res = W.grid_world()
    sgrid = jmap.ShardedGrid(occ, origin, res, n_shards=2)
    map_table = _table(rng, (2, W.MB))
    dp_table = _table(rng, (2, 2, W.MB // 2))
    seed = _flat(_jseed(), "map/tree0")
    inputs = dict(jS=jS, jK=jK, **seed, **{"map/table": map_table,
                                           "dpmap/table": dp_table},
                  **{k.replace("map/", "dpmap/", 1): v
                     for k, v in seed.items()})
    tmp2 = tempfile.mkdtemp(prefix="torch_map2_")
    tmp4 = tempfile.mkdtemp(prefix="torch_map4_")
    p2 = W.spawn(2, inputs, ["map"], tmp2)
    p4 = W.spawn(4, inputs, ["dp_map"], tmp4)
    want_map = _jax_map_rounds(map_table, sgrid)
    want_dp = _jax_dp_map_rounds(dp_table, sgrid)
    return dict(map=(W.collect(p2, tmp2, timeout=240), want_map),
                dp_map=(W.collect(p4, tmp4, timeout=240), want_dp))


def _round(got, case, r):
    return {f: got[f"{case}/r{r}/{f}"] for f in JTree._fields}


@pytest.mark.parametrize("case", ["map", "dp_map"])
def test_map_rounds_lockstep_with_jax(jobs, case):
    got, want = jobs[case]
    for r, w in enumerate(want):
        for rank_out in got:
            W.assert_lockstep(_round(rank_out, case, r), w)
    size = int(want[-1].size)
    assert 1 < size < 1 + 2 * W.MB        # some rollouts were cut to nothing
    # every committed node is off the wall
    occ, origin, res = W.grid_world()
    st = np.asarray(want[-1].state)[:size]
    grid = pm.ShardedGrid(occ, origin, res, n_shards=1)
    assert not grid.occupied_host(st[:, :2]).any()


def test_dp_map_replicas_bitwise_equal(jobs):
    got, _ = jobs["dp_map"]
    for f in JTree._fields:
        for r in range(1, 4):
            np.testing.assert_array_equal(got[0][f"dp_map/replicas/{f}"],
                                          got[r][f"dp_map/replicas/{f}"],
                                          err_msg=f"rank {r} {f}")
    assert int(got[0]["dp_map/replicas/size"]) > W.MB


# ---- ShardedGrid alone ------------------------------------------------------

def test_sharded_grid_verdicts_equal_jax():
    """Host and slab verdicts against JAX's at points across the map, its
    edges and outside it; at 3 shards (64 rows: padded rows occupied);
    NaN is occupied in the port (the grid boat's repair)."""
    occ, origin, res = W.grid_world()
    rng = np.random.default_rng(3)
    p = rng.uniform(-2.0, 18.0, (4000, 2)).astype(np.float32)
    p[:8] = [[0, 0], [15.99, 15.99], [16, 1], [1, 16], [-0.01, 3],
             [7.0, 6.0], [7.99, 7.99], [8.0, 8.0]]
    for n in (1, 2, 3):
        jg = jmap.ShardedGrid(occ, origin, res, n_shards=n)
        pg = pm.ShardedGrid(occ, origin, res, n_shards=n)
        np.testing.assert_array_equal(pg.occ_sharded, jg.occ_sharded)
        np.testing.assert_array_equal(pg.occupied_host(p),
                                      jg.occupied_host(p))
        local_any = np.zeros(len(p), bool)
        for d in range(n):
            jl, joob = jg.occupied_local(jnp.asarray(p), jnp.asarray(
                jg.occ_sharded[d]), d)
            pl, poob = pg.occupied_local(torch.from_numpy(p),
                                         pg.slab(d, "cpu"), d)
            np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
            np.testing.assert_array_equal(poob.numpy(), np.asarray(joob))
            local_any |= pl.numpy()
        np.testing.assert_array_equal(local_any | poob.numpy(),
                                      pg.occupied_host(p))
    nan = np.array([[np.nan, 3.0], [3.0, np.nan]], np.float32)
    assert pg.occupied_host(nan).all()
    _, oob = pg.occupied_local(torch.from_numpy(nan), pg.slab(0, "cpu"), 0)
    assert oob.all()


def test_slab_past_float32_integers():
    """A slab of more than 2^24 cells (4100 x 4100): an occupied cell at
    an odd flat index past 2^24, where a float32 index would round to a
    neighbour, reads occupied, and its free neighbours free, as the host
    grid says."""
    Hc = Wc = 4100
    occ = np.zeros((Hc, Wc), bool)
    occ[4096, [1, 7]] = True                  # flat 16,793,601 and 607
    grid = pm.ShardedGrid(occ, [0.0, 0.0], 1.0, n_shards=1)
    assert 4096 * Wc + 1 > 2 ** 24
    p = np.array([[x + 0.5, 4096.5] for x in range(10)], np.float32)
    local, oob = grid.occupied_local(torch.from_numpy(p),
                                     grid.slab(0, "cpu"), 0)
    want = grid.occupied_host(p)
    np.testing.assert_array_equal(want, np.isin(np.arange(10), [1, 7]))
    np.testing.assert_array_equal((local | oob).numpy(), want)


# ---- one process: the truncation is exact ---------------------------------

@pytest.fixture(scope="module")
def map1():
    init = tempfile.mktemp(prefix="torch_map_store_")
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    yield meshlib.make_mesh(1, axis="map", device_type="cpu")
    dist.destroy_process_group()


def test_truncation_is_exact(map1):
    """One map shard: three map-sharded rounds (steering with no
    predicate, cut at the grid) against the plain expand + sorted commit
    steering under ``grid_free_data`` on the whole grid: the same rows,
    and the same rollouts up to each edge's length."""
    prob = di.default_problem(obstacles=False)
    occ, origin, res = W.grid_world()
    spec = rounds.RoundSpec(W.N_X, W.N_U, W.MB, W.H, W.MCAP, W.DT,
                            nn_block=W.BLK, slack=W.MB)
    grid = pm.ShardedGrid(occ, origin, res, n_shards=1)
    data = torch.from_numpy(occ)
    pred = grid_free_data(origin, res)
    args = (prob["dynamics"], prob["lqr"], prob["erf"])
    free = lambda x, u: torch.ones(x.shape[:-1], dtype=torch.bool)  # noqa
    rf = pm.make_map_sharded_round(spec, map1, grid, *args, free, W.TOL,
                                   prob["constraints"].goal_buffer)
    expand = rounds.make_expand(spec, *args,
                                lambda x, u: pred(x, u, data), W.TOL,
                                prob["constraints"].goal_buffer)
    seed = interop.tree_from_numpy(jax.device_get(_jseed()), device="cpu")
    a = interop.tree_from_numpy(interop.tree_to_numpy(seed), device="cpu")
    b = interop.tree_from_numpy(interop.tree_to_numpy(seed), device="cpu")
    goal = torch.from_numpy(W.GRID_GOAL)
    rng = np.random.default_rng(5)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        xr = torch.from_numpy(_table(rng, (W.MB,)))
        g0 = gen.get_state()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pm, "sample_batch", lambda g, nb, ss, gb, bt: xr)
            rf(a, grid.slab(0, "cpu"), gen, goal, None, None, None)
        gen.set_state(g0)
        rounds.commit_candidates(spec, b, expand(b, xr, goal),
                                 commit_all=False)
    size = int(b.size)
    assert int(a.size) == size > 1
    for f in ("parent", "edge_len", "in_goal", "n_children", "goal_found",
              "state", "node_time", "goal_cost", "S", "K"):
        assert torch.equal(getattr(a, f)[:size] if f != "goal_found"
                           else a.goal_found,
                           getattr(b, f)[:size] if f != "goal_found"
                           else b.goal_found), f
    lens = b.edge_len[:size]
    for i in range(1, size):
        ln = int(lens[i])
        assert torch.equal(a.edge_x[:ln, :, i], b.edge_x[:ln, :, i])
        assert torch.equal(a.edge_u[:ln, :, i], b.edge_u[:ln, :, i])
    # the grid cut some rollouts short
    assert (lens < W.H).sum() > 0
