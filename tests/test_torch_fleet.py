"""The scenario-parallel fleet (``lqrrt_tpu_torch/parallel/fleet.py``)
against the JAX package's ``FleetPlanner``, on the CPU at small sizes.

The same numpy inputs go through both: the sorted dense commit over a
scenario axis (every field exact: the commit only copies), the seeded
fleet (S and K within 2e-3, as tests/test_riccati.py), the fleet round
(trees row for row over three rounds on the double integrator and the
boat, with tests/test_torch_round.py's tolerances), plans, the batched
extraction on a fleet grown in JAX, and the budget on a fake clock.
"""
import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lqrrt_tpu.core import rounds as jrounds
from lqrrt_tpu.core.commit import commit_batch_dense as jcommit_dense
from lqrrt_tpu.core.nearest import make_nearest as jmake_nearest
from lqrrt_tpu.core.tree import TreeArrays as JTree
from lqrrt_tpu.models import boat as jboat
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu.parallel.fleet import FleetPlanner as JFleet
from lqrrt_tpu_torch import interop
from lqrrt_tpu_torch.core import commit, rounds
from lqrrt_tpu_torch.core.nearest import make_nearest
from lqrrt_tpu_torch.core.sampling import sample_batch
from lqrrt_tpu_torch.core.tree import TreeArrays, best_node, init_tree
from lqrrt_tpu_torch.demos import fleet_demo
from lqrrt_tpu_torch.models import boat, double_integrator as di
from lqrrt_tpu_torch.ops.collision import circles_free_data, grid_free_data
from lqrrt_tpu_torch.parallel import FleetPlanner

torch.set_num_threads(2)

DT = 0.05


def _jtree(d) -> JTree:
    return JTree(**{f: jnp.asarray(np.asarray(d[f])) for f in JTree._fields})


def _np(tree) -> dict:
    if isinstance(tree, TreeArrays):
        return {k: v.copy() for k, v in interop.tree_to_numpy(tree).items()}
    return {f: np.asarray(getattr(tree, f)) for f in JTree._fields}


# ---- the sorted dense commit over a scenario axis -------------------------

CS, CB, CCAP, CSLACK, CH, CN, CM = 7, 16, 48, 16, 5, 4, 2


def _dense_case(seed):
    """Seven scenario trees and candidates: all valid, none valid, size =
    limit - 3, a full tree, valid-first and invalid-first alternation
    (both orders of the sort's ties), and a random mix."""
    rng = np.random.default_rng(seed)
    S, B, N = CS, CB, CCAP + CSLACK
    f32 = np.float32
    size = np.array([1, 9, CCAP - 3, CCAP, 20, 33, 14], np.int32)
    tree = dict(
        state=rng.normal(size=(S, N, CN)).astype(f32),
        S=rng.normal(size=(S, N, CN, CN)).astype(f32),
        K=rng.normal(size=(S, N, CM, CN)).astype(f32),
        parent=rng.integers(-1, N, (S, N)).astype(np.int32),
        edge_x=rng.normal(size=(S, CH, CN, N)).astype(f32),
        edge_u=rng.normal(size=(S, CH, CM, N)).astype(f32),
        edge_len=rng.integers(0, CH + 1, (S, N)).astype(np.int32),
        node_time=rng.uniform(0, 5, (S, N)).astype(f32),
        in_goal=rng.random((S, N)) < 0.2,
        goal_cost=rng.uniform(0, 9, (S, N)).astype(f32),
        n_children=rng.integers(0, 3, (S, N)).astype(np.int32),
        size=size, goal_found=np.array([0, 0, 0, 1, 0, 0, 0], bool))
    alt = np.arange(B) % 2
    length = rng.integers(1, CH + 1, (S, B))
    length[1] = 0                                   # n_valid = 0
    length[2] *= rng.random(B) < 0.6
    length[4] *= alt == 0                           # valid first
    length[5] *= alt == 1                           # invalid first
    length[6] *= rng.random(B) < 0.5
    cands = (
        np.stack([rng.integers(0, s, B) for s in size]).astype(np.int32),
        length.astype(np.int32),
        rng.normal(size=(S, CH, CN, B)).astype(f32),
        rng.normal(size=(S, CH, CM, B)).astype(f32),
        rng.normal(size=(S, B, CN)).astype(f32),
        rng.normal(size=(S, B, CN, CN)).astype(f32),
        rng.normal(size=(S, B, CM, CN)).astype(f32),
        rng.random((S, B)) < 0.3,
        rng.uniform(0, 9, (S, B)).astype(f32))
    return tree, cands


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_commit_batch_dense_equals_jax(seed):
    tree, cands = _dense_case(seed)
    jfn = jax.jit(jax.vmap(lambda t, *c: jcommit_dense(t, DT, CCAP, *c)))
    want = _np(jfn(_jtree(tree), *(jnp.asarray(c) for c in cands)))
    ptree = interop.tree_from_numpy(tree, device="cpu")
    out = commit.commit_batch_dense(ptree, DT, CCAP,
                                    *(torch.from_numpy(c) for c in cands))
    assert out is ptree                              # in place
    got = _np(out)
    for f in JTree._fields:
        if f != "node_time":
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    # node_time = parent's + length * dt, the one field with arithmetic:
    # XLA fuses it into one multiply-add, so JAX's may differ by an ulp;
    # the port's is fp32's two roundings, exactly
    np.testing.assert_allclose(got["node_time"], want["node_time"],
                               rtol=2e-7, atol=0)
    sc = np.arange(CS)[:, None]
    t_new = (tree["node_time"][sc, cands[0]]
             + cands[1].astype(np.float32) * np.float32(DT))
    rows = np.minimum(tree["size"], CCAP)[:, None] + np.arange(CB)
    rank = np.argsort(cands[1] < 1, axis=1, kind="stable")
    np.testing.assert_array_equal(got["node_time"][sc, rows],
                                  np.take_along_axis(t_new, rank, 1))
    # the cases the batch was built for
    n_valid = (cands[1] >= 1).sum(1)
    assert n_valid[1] == 0 and got["size"][1] == tree["size"][1]
    assert got["size"][2] == min(CCAP - 3 + n_valid[2], CCAP)
    assert got["size"][3] == CCAP                    # full: commits nothing
    np.testing.assert_array_equal(got["n_children"][3],
                                  tree["n_children"][3])


def test_commit_batch_dense_sorted_rows():
    """Valid rows land first in batch order, then the empty ones, at the
    scenario's start; rows past the limit go to the slack and count no
    child."""
    tree, cands = _dense_case(3)
    got = _np(commit.commit_batch_dense(
        interop.tree_from_numpy(tree, device="cpu"), DT, CCAP,
        *(torch.from_numpy(c) for c in cands)))
    for s in range(CS):
        valid = cands[1][s] >= 1
        order = np.concatenate([np.flatnonzero(valid),
                                np.flatnonzero(~valid)])
        start = min(tree["size"][s], CCAP)
        rows = start + np.arange(CB)
        np.testing.assert_array_equal(got["parent"][s, rows],
                                      cands[0][s, order])
        np.testing.assert_array_equal(got["edge_x"][s][..., rows],
                                      cands[2][s][..., order])
        committed = valid[order] & (rows < CCAP)
        added = np.bincount(cands[0][s, order][committed], minlength=CCAP +
                            CSLACK)
        np.testing.assert_array_equal(
            got["n_children"][s], tree["n_children"][s] + added)


# ---- seeding, sampling, the fleet's NN scan --------------------------------

def _fleets(jprob, tprob, S, **kw):
    common = dict(horizon=1.0, dt=DT, n_scenarios=S, saturate=None, **kw)
    jf = JFleet(jprob["dynamics"], jprob["lqr"], jprob["erf"],
                jprob["constraints"].is_feasible,
                jprob["constraints"].goal_buffer,
                wrap_dims=jprob.get("wrap_dims", ()), **common)
    pf = FleetPlanner(tprob["dynamics"], tprob["lqr"], tprob["erf"],
                      tprob["constraints"].is_feasible,
                      tprob["constraints"].goal_buffer,
                      wrap_dims=tprob.get("wrap_dims", ()), device="cpu",
                      **common)
    return jf, pf


@pytest.mark.parametrize("model", ["double_integrator", "boat"])
def test_seeded_fleet_equals_jax(model):
    jprob, tprob = ((jdi.default_problem(), di.default_problem())
                    if model == "double_integrator"
                    else (jboat.default_problem(), boat.default_problem()))
    n = tprob["constraints"].nstates
    m = tprob["constraints"].ncontrols
    S = 5
    rng = np.random.default_rng(4)
    lo, hi = tprob["sample_space"][:, 0], tprob["sample_space"][:, 1]
    x0s = rng.uniform(lo, hi, (S, n)).astype(np.float32)
    goals = rng.uniform(lo, hi, (S, n)).astype(np.float32)
    goals[0] = x0s[0]                               # seeded in the goal box
    jf, pf = _fleets(jprob, tprob, S, batch_size=16, capacity=64, nn_block=32)
    jf._build(n, m)
    pf._build(n, m)
    assert pf.spec.slack == jf.spec.slack == 32
    want = _np(jf._vseed(jnp.asarray(x0s), jnp.asarray(goals)))
    got = _np(pf._seed(torch.from_numpy(x0s), torch.from_numpy(goals)))
    for f in JTree._fields:
        assert got[f].shape == want[f].shape, f
        if f in ("S", "K", "goal_cost"):
            np.testing.assert_allclose(got[f], want[f], rtol=2e-3,
                                       atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert got["in_goal"][0, 0] and got["goal_found"][0]


def test_fleet_sample_batch():
    """(S, B, n) in each scenario's space, each dim its scenario's goal
    with the dim's bias; one scenario draws what the one-tree sampler
    draws from the same generator state."""
    S, B, n = 3, 4096, 4
    ss = torch.tensor([[[0.0, 1.0]] * n, [[5.0, 6.0]] * n,
                       [[-2.0, -1.0]] * n])
    goals = torch.tensor([[9.0] * n, [8.0] * n, [7.0] * n])
    gb = torch.tensor([0.0, 0.3, 0.3, 1.0])
    x = sample_batch(torch.Generator().manual_seed(0), B, ss, gb, goals)
    assert x.shape == (S, B, n)
    for s in range(S):
        biased = x[s] == goals[s]
        free = x[s][~biased]
        assert ((free >= ss[s, 0, 0]) & (free <= ss[s, 0, 1])).all()
        assert not biased[:, 0].any() and biased[:, 3].all()
        assert abs(biased[:, 1].float().mean() - 0.3) < 0.03
    one = sample_batch(torch.Generator().manual_seed(0), B, ss[0], gb,
                       goals[0])
    got = sample_batch(torch.Generator().manual_seed(0), B, ss[:1], gb,
                       goals[:1])
    assert torch.equal(got[0], one)


def test_fleet_nearest_equals_one_tree_scan_and_jax():
    """Each scenario's pick from its own tree: the scan over a scenario
    axis equals the one-tree scan per scenario bit for bit, and JAX's
    vmapped scan by id; a NaN S row drops only itself."""
    rng = np.random.default_rng(5)
    S, N, B, n, blk = 4, 96, 24, 6, 32
    states = rng.uniform(-3, 3, (S, N, n)).astype(np.float32)
    A = rng.normal(size=(S, N, n, n)).astype(np.float32)
    Sm = (A @ A.transpose(0, 1, 3, 2) + np.eye(n, dtype=np.float32))
    xr = rng.uniform(-3, 3, (S, B, n)).astype(np.float32)
    size = np.array([1, 40, 64, 96], np.int32)
    erf = boat.erf
    ids, cost = make_nearest(erf, blk)(
        *(torch.from_numpy(a) for a in (states, Sm, size, xr)))
    one = make_nearest(erf, blk)
    for s in range(S):
        i1, c1 = one(*(torch.as_tensor(a[s]) for a in (states, Sm, size,
                                                         xr)))
        assert torch.equal(ids[s], i1) and torch.equal(cost[s], c1)
    jids, _ = jax.vmap(jmake_nearest(jboat.erf, blk))(
        *(jnp.asarray(a) for a in (states, Sm, size, xr)))
    assert np.mean(ids.numpy() == np.asarray(jids)) >= 0.99
    assert (ids[0] == 0).all()                  # size 1: the root only
    Sm[2, 5] = np.nan
    ids2, _ = make_nearest(erf, blk)(
        *(torch.from_numpy(a) for a in (states, Sm, size, xr)))
    keep = ids.numpy() != 5
    assert np.array_equal(ids2.numpy()[keep], ids.numpy()[keep])
    assert not (ids2[2] == 5).any()


# ---- the fleet round in lockstep with JAX's vmapped round ------------------

LS, LB, LCAP, LBLK, LH = 4, 32, 128, 64, 20


def _lockstep(model):
    """JAX's vmapped ``make_round`` (candidates fed through ``xrand_gen``)
    and the port's fleet round, three rounds from the same seeded fleet
    on the same (S, B, n) candidates; the trees after each round."""
    if model == "boat":
        jprob, tprob = jboat.default_problem(), boat.default_problem()
    else:
        jprob, tprob = jdi.default_problem(), di.default_problem()
    n = tprob["constraints"].nstates
    m = tprob["constraints"].ncontrols
    wrap = tprob["wrap_dims"]
    jf = JFleet(jprob["dynamics"], jprob["lqr"], jprob["erf"],
                jprob["constraints"].is_feasible,
                jprob["constraints"].goal_buffer, horizon=LH * DT, dt=DT,
                n_scenarios=LS, batch_size=LB, capacity=LCAP, nn_block=LBLK,
                saturate=jprob["saturate"], wrap_dims=wrap)
    jf._build(n, m)
    gb = jprob["constraints"].goal_buffer
    wrap_mask = np.zeros(n, bool)
    wrap_mask[list(wrap)] = True
    wrap_mask = wrap_mask if wrap else None
    jround = jrounds.make_round(
        jf.spec, jprob["dynamics"], jprob["lqr"], jprob["erf"],
        jprob["constraints"].is_feasible, 0.05, gb, wrap_mask=wrap_mask,
        xrand_gen=lambda k, b: k, saturate=jprob["saturate"])
    vround = jax.jit(jax.vmap(jround, in_axes=(0, 0, 0, None, None, None)))
    spec = rounds.RoundSpec(nstates=n, ncontrols=m, batch=LB,
                            horizon_steps=LH, capacity=LCAP, dt=DT,
                            nn_block=LBLK, slack=jf.spec.slack)
    jS, jK = (np.asarray(a) for a in jprob["lqr"](None, None))
    pround = rounds.make_fleet_round(
        spec, tprob["dynamics"], interop.lqr_from_numpy(jS, jK),
        tprob["erf"], tprob["constraints"].is_feasible, 0.05, gb,
        wrap_mask=wrap_mask, saturate=tprob["saturate"])

    rng = np.random.default_rng(7)
    x0s = np.tile(tprob["x0"], (LS, 1)).astype(np.float32)
    x0s[:, 1] = rng.uniform(-1, 1, LS)
    goals = np.tile(tprob["goal"], (LS, 1)).astype(np.float32)
    goals[:, 0] = 3.0                   # near enough to reach in 3 rounds
    goals[:, 1] += rng.uniform(-1, 1, LS)
    jtrees = jf._vseed(jnp.asarray(x0s), jnp.asarray(goals))
    ptrees = interop.tree_from_numpy(jax.device_get(jtrees), device="cpu")
    lo, hi = tprob["sample_space"][:, 0], tprob["sample_space"][:, 1]
    goal_rows = torch.from_numpy(np.repeat(goals, LB, 0))
    dummy = jnp.zeros(n, jnp.float32)
    steps = []
    for _ in range(3):
        xr = rng.uniform(lo, hi, (LS, LB, n)).astype(np.float32)
        xr[..., 0] *= 0.3               # keep candidates near the young tree
        take = rng.uniform(size=(LS, LB, n)) < 0.3
        xr = np.where(take, goals[:, None, :], xr).astype(np.float32)
        jtrees = vround(jtrees, jnp.asarray(xr), jnp.asarray(goals),
                        jnp.zeros((n, 2)), dummy, dummy)
        pround(ptrees, torch.from_numpy(xr), goal_rows)
        steps.append((_np(ptrees), _np(jax.device_get(jtrees))))
    return steps


@pytest.fixture(scope="module", params=["double_integrator", "boat"])
def lockstep(request):
    return request.param, _lockstep(request.param)


def test_fleet_round_lockstep(lockstep):
    model, steps = lockstep
    for got, want in steps:
        np.testing.assert_array_equal(got["size"], want["size"])
        np.testing.assert_array_equal(got["goal_found"], want["goal_found"])
        for f in ("parent", "edge_len", "in_goal", "n_children"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_allclose(got["node_time"], want["node_time"],
                                   rtol=2e-7, atol=0)
        for f in ("state", "edge_x"):
            np.testing.assert_allclose(got[f], want[f], atol=1e-3,
                                       err_msg=f)
        np.testing.assert_allclose(got["edge_u"], want["edge_u"], rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_allclose(got["goal_cost"], want["goal_cost"],
                                   rtol=1e-3, atol=1e-3)
    got, want = steps[-1]
    assert (got["size"] > 1 + 2 * LB // 2).all()    # the trees grew
    if model == "boat":
        assert got["in_goal"].any()                 # the goal stop ran


# ---- plans, worlds, extraction --------------------------------------------

PS = 8


@pytest.fixture(scope="module")
def di_fleets():
    """JAX's and the port's fleets on the double integrator, 12 rounds."""
    jprob, tprob = jdi.default_problem(), di.default_problem()
    kw = dict(horizon=1.0, dt=DT, n_scenarios=PS, batch_size=32,
              capacity=256, nn_block=128, seed=1)
    jf = JFleet(jprob["dynamics"], jprob["lqr"], jprob["erf"],
                jprob["constraints"].is_feasible,
                jprob["constraints"].goal_buffer,
                saturate=jprob["saturate"], mesh=None, **kw)
    pf = FleetPlanner(tprob["dynamics"], tprob["lqr"], tprob["erf"],
                      tprob["constraints"].is_feasible,
                      tprob["constraints"].goal_buffer,
                      saturate=tprob["saturate"], device="cpu", **kw)
    rng = np.random.default_rng(0)
    x0s = np.zeros((PS, 4), np.float32)
    x0s[:, 1] = rng.uniform(-1, 1, PS)
    goals = np.tile(np.asarray(tprob["goal"]), (PS, 1))
    args = (x0s, goals, tprob["sample_space"])
    jst = jf.plan(*args, goal_bias=0.2, rounds=12)
    pst = pf.plan(*args, goal_bias=0.2, rounds=12)
    return dict(jf=jf, pf=pf, jst=jst, pst=pst, x0s=x0s, goals=goals,
                tprob=tprob)


def test_fleet_plans_against_jax(di_fleets):
    d = di_fleets
    for st in (d["jst"], d["pst"]):
        assert st["sizes"].shape == (PS,) and np.all(st["sizes"] > 1)
        assert st["rounds"] == 12 and st["expansions"] == 12 * 32 * PS
    assert abs(d["jst"]["goal_found"].mean()
               - d["pst"]["goal_found"].mean()) <= 0.25
    plans = d["pf"].extract_plans()
    for s in range(PS):
        np.testing.assert_allclose(plans[s][0], d["x0s"][s], atol=1e-5)
    # the scenarios are different trees
    assert plans[0].shape != plans[1].shape or not np.allclose(plans[0],
                                                               plans[1])
    found = d["pst"]["goal_found"]
    np.testing.assert_array_equal(
        d["pst"]["goal_time_s"][found],
        np.float32(d["pst"]["elapsed_s"]))
    assert np.isnan(d["pst"]["goal_time_s"][~found]).all()
    np.testing.assert_array_equal(d["pf"].best_nodes(),
                                  best_node(d["pf"].trees).numpy())


def test_extract_plans_on_a_jax_fleet(di_fleets):
    """A fleet grown in JAX, carried into the port: the same plans, array
    for array, and the same transfer size."""
    d = di_fleets
    jtrees = jax.device_get(d["jf"].trees)
    pf = FleetPlanner(*([None] * 4), d["tprob"]["constraints"].goal_buffer,
                      horizon=1.0, n_scenarios=PS, device="cpu")
    pf.trees = interop.tree_from_numpy(jtrees, device="cpu")
    back = interop.tree_to_numpy(pf.trees)
    for f in JTree._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(jtrees,
                                                                  f)))
    for req in (None, [5, 0, 3]):
        want = d["jf"].extract_plans(req)
        got = pf.extract_plans(req)
        assert list(got) == list(want)
        for s in want:
            assert got[s].dtype == want[s].dtype
            np.testing.assert_array_equal(got[s], want[s])
        jt, pt = d["jf"].last_extract_timings, pf.last_extract_timings
        assert set(pt) == set(jt)
        assert pt["transfer_bytes"] == jt["transfer_bytes"]
    np.testing.assert_array_equal(pf.best_nodes(), d["jf"].best_nodes())
    np.testing.assert_array_equal(pf.extract_plan(2),
                                  d["jf"].extract_plan(2))


def test_fleet_per_scenario_worlds_and_batched_extraction():
    """Each scenario gets its OWN obstacle (per-scenario feasibility data)
    and the batched extractor returns what a host climb per scenario
    returns (tests/test_sharded.py's fleet test, on one device)."""
    prob = di.default_problem()
    S = 8
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        circles_free_data(margin=0.1), prob["constraints"].goal_buffer,
        horizon=1.0, dt=DT, n_scenarios=S, batch_size=32, capacity=256,
        nn_block=128, saturate=prob["saturate"], seed=3, ncontrols=2,
        per_scenario_data=True, device="cpu")
    x0s = np.zeros((S, 4), np.float32)
    goals = np.tile(np.asarray(prob["goal"]), (S, 1))
    centers = np.stack([[3.0 + 0.2 * s, 0.0 + 0.5 * s] for s in range(S)]
                       ).astype(np.float32)[:, None, :]
    radii = np.full((S, 1), 0.8, np.float32)
    data = {"centers": centers, "radii": radii}
    with pytest.raises(ValueError, match="feasibility_data"):
        fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.3, rounds=1)
    stats = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.3,
                       rounds=12, feasibility_data=data)
    assert np.all(stats["sizes"] > 1)
    sizes = stats["sizes"]
    st = fleet.trees.state.numpy()
    for s in range(S):
        d = np.linalg.norm(st[s, :sizes[s], :2] - centers[s, 0], axis=1)
        assert d.min() > 0.8, f"scenario {s} violated its own obstacle"
    # scenario 0's circle blocks the straight line; scenario 7's is far:
    # its own circle only, so nodes lie inside the others' circles
    d0 = np.linalg.norm(st[7, :sizes[7], :2] - centers[0, 0], axis=1)
    assert d0.min() < 0.8
    plans = fleet.extract_plans()
    assert set(plans) == set(range(S))
    for s in (0, 3, 7):
        np.testing.assert_allclose(plans[s][0], x0s[s], atol=1e-5)
        t = TreeArrays(*[getattr(fleet.trees, f)[s]
                         for f in TreeArrays._fields])
        chain, i = [], int(best_node(t))
        parent = t.parent.numpy()
        while i != -1:
            chain.append(i)
            i = int(parent[i])
        chain = chain[::-1]
        xs = [t.state[chain[0]].numpy()[None]]
        for k in range(1, len(chain)):
            ln = int(t.edge_len[chain[k]])
            xs.append(t.edge_x[:ln, :, chain[k]].numpy())
        np.testing.assert_allclose(plans[s], np.concatenate(xs, 0),
                                   atol=1e-6)
    with pytest.raises(ValueError, match="leading axis"):
        fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.3,
                   rounds=1, feasibility_data={"centers": centers[:3],
                                               "radii": radii[:3]})


def test_fleet_goals_are_per_scenario():
    """Each scenario plans toward its own goal: its in-goal nodes lie in
    its own goal box, and every node's cost-to-go is toward that goal."""
    prob = di.default_problem()
    S = 6
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=DT, n_scenarios=S, batch_size=32, capacity=256,
        nn_block=128, saturate=prob["saturate"], seed=2, device="cpu")
    x0s = np.zeros((S, 4), np.float32)
    goals = np.zeros((S, 4), np.float32)
    goals[:, 0] = np.linspace(2.0, 4.0, S)
    goals[:, 1] = np.linspace(-2.5, 2.5, S)
    st = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.3,
                    rounds=10)
    t = _np(fleet.trees)
    S_, _ = (np.asarray(a, np.float64) for a in prob["lqr"](
        torch.zeros(4), None))
    gbuf = prob["constraints"].goal_buffer
    for s in range(S):
        live = np.arange(st["sizes"][s])
        e = goals[s] - t["state"][s, live].astype(np.float64)
        np.testing.assert_allclose(
            t["goal_cost"][s, live], np.einsum("bi,ij,bj->b", e, S_, e),
            rtol=1e-4, atol=1e-4)
        inside = np.all(np.abs(e) <= gbuf + 1e-5, axis=1)
        assert inside[t["in_goal"][s, live]].all()
    assert st["goal_found"].sum() >= S // 2


def _chain_fleet(depth, cycle=False, orphan=False):
    """Two scenario trees: scenario 1 a chain 0 -> 1 -> ... -> depth - 1
    with its last row in the goal (deeper than the device walk when
    depth > 128); scenario 0 the root alone."""
    n, m, H, N = 2, 1, 3, depth + 8
    x0 = torch.zeros((2, n))
    tree = init_tree(N, H, n, m, x0, torch.eye(n).expand(2, n, n),
                     torch.zeros((2, m, n)), torch.ones(2),
                     torch.zeros(2, dtype=torch.bool))
    rows = torch.arange(1, depth)
    tree.parent[1, rows] = (rows - 1).int()
    tree.edge_len[1, rows] = 2
    tree.state[1, rows, 0] = rows.float()
    tree.edge_x[1, :, 0, rows] = rows.float() - 0.5
    tree.node_time[1, rows] = rows.float() * 2 * DT
    tree.in_goal[1, depth - 1] = True
    tree.goal_found[1] = True
    tree.size[1] = depth
    if cycle:
        tree.parent[1, 10] = 40             # 10 -> 40 -> ... -> 10
    if orphan:
        tree.parent[1, 10] = -1
    fleet = FleetPlanner(*([None] * 4), np.ones(n), horizon=1.0,
                         n_scenarios=2, device="cpu")
    fleet.trees = tree
    return fleet


def test_extract_plans_deeper_than_the_device_walk():
    depth = FleetPlanner._MAX_DEPTH + 72
    fleet = _chain_fleet(depth)
    plans = fleet.extract_plans()
    assert plans[0].shape == (1, 2)
    want = np.concatenate([[[0.0, 0.0]]] + [
        [[k - 0.5, 0.0]] * 2 for k in range(1, depth)]).astype(np.float32)
    np.testing.assert_array_equal(plans[1], want)
    tm = fleet.last_extract_timings
    assert tm["transfer_bytes"] == (depth + 1) * (2 + 3 * 2 + 1) * 4


@pytest.mark.parametrize("fault,match", [("cycle", "cycle"),
                                         ("orphan", "root")])
def test_extract_plans_raises_on_broken_chains(fault, match):
    fleet = _chain_fleet(160, **{fault: True})
    with pytest.raises(RuntimeError, match=match):
        fleet.extract_plans()
    assert set(fleet.extract_plans([0])) == {0}


def test_extract_plans_needs_trees():
    fleet = FleetPlanner(*([None] * 4), np.ones(2), horizon=1.0,
                         n_scenarios=2, device="cpu")
    with pytest.raises(RuntimeError, match="plan"):
        fleet.extract_plans()


# ---- the anytime budget on a fake clock -----------------------------------

def test_fleet_budget_on_a_fake_clock():
    """Each round costs 0.125 s of a fake clock: a 1-round probe, chunks
    clamped to what the budget affords, the per-round time kept across
    calls, goal times at chunk ends."""
    prob = di.default_problem()
    clock = [0.0]
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=DT, n_scenarios=4, batch_size=16, capacity=256,
        nn_block=128, saturate=prob["saturate"], ncontrols=2, seed=5,
        sys_time=lambda: clock[0], device="cpu")
    chunks, per_round = [], [0.125]
    run = fleet._run_rounds

    def timed_run(trees, nr, *a):
        run(trees, nr, *a)
        chunks.append(nr)
        clock[0] += per_round[0] * nr

    fleet._run_rounds = timed_run
    x0s = np.zeros((4, 4), np.float32)
    goals = np.tile(np.asarray(prob["goal"]), (4, 1))
    args = (x0s, goals, prob["sample_space"])
    st = fleet.plan(*args, goal_bias=0.3, rounds=64, max_time=1.0,
                    rounds_per_chunk=4)
    assert chunks == [1, 4, 3]        # probe, then clamped to 7 rounds left
    assert st["rounds"] == 8 and st["elapsed_s"] == 1.0
    assert st["expansions"] == 8 * 16 * 4
    assert fleet._per_round_s == 0.125
    found, gt = st["goal_found"], st["goal_time_s"]
    assert set(gt[found]) <= {0.125, 0.625, 1.0}
    assert np.isnan(gt[~found]).all()
    # the per-round time persists: no probe on the next call
    chunks.clear()
    st = fleet.plan(*args, goal_bias=0.3, rounds=6, max_time=1.0,
                    rounds_per_chunk=4)
    assert chunks == [4, 2] and st["rounds"] == 6
    # slower rounds move the average halfway
    chunks.clear()
    per_round[0] = 0.375
    st = fleet.plan(*args, goal_bias=0.3, rounds=64, max_time=1.0,
                    rounds_per_chunk=4)
    assert chunks == [4]              # 4 x 0.375 s spends the budget
    assert fleet._per_round_s == 0.25
    # max_time=None: exactly ``rounds`` rounds, one dispatch
    chunks.clear()
    st = fleet.plan(*args, goal_bias=0.3, rounds=5)
    assert chunks == [5] and st["rounds"] == 5
    np.testing.assert_array_equal(st["goal_time_s"][st["goal_found"]],
                                  np.float32(5 * 0.375))


def test_fleet_plan_tallies_the_steer_route():
    """``plan`` returns the steer's calls by route under ``"tallies"``, one
    a round and reset at each call: on CPU tensors every call takes the
    plain loop (``steer.scan``), whatever the budget; kernel D's route
    (``steer.kernel``) needs the card."""
    prob = di.default_problem()
    fleet = FleetPlanner(
        prob["dynamics"], prob["lqr"], prob["erf"],
        prob["constraints"].is_feasible, prob["constraints"].goal_buffer,
        horizon=1.0, dt=DT, n_scenarios=4, batch_size=16, capacity=256,
        nn_block=128, saturate=prob["saturate"], ncontrols=2, seed=5,
        device="cpu")
    x0s = np.zeros((4, 4), np.float32)
    goals = np.tile(np.asarray(prob["goal"]), (4, 1))
    for rounds, kw in ((3, {}), (5, dict(max_time=1e9, rounds_per_chunk=2))):
        st = fleet.plan(x0s, goals, prob["sample_space"], goal_bias=0.3,
                        rounds=rounds, **kw)
        assert st["rounds"] == rounds
        assert st["tallies"] == {"steer.scan": rounds}
        assert st["spans"]["round.steer"]["count"] == rounds


# ---- the constructor and its errors ---------------------------------------

def test_constructor_keywords_match_jax():
    js = inspect.signature(JFleet.__init__).parameters
    ps = inspect.signature(FleetPlanner.__init__).parameters
    assert list(ps) == list(js) + ["device"]
    for k, p in js.items():
        assert ps[k].kind == p.kind, k
        assert ps[k].default == p.default, k
    assert ps["device"].default == "cuda"


def test_constructor_errors(monkeypatch):
    """A one-rank mesh and per-scenario grids construct (both raised
    before they were ported); a mesh on another device type raises; and
    CUDA asked for without CUDA, and the wrong scenario count."""
    import tempfile

    import torch.distributed as dist
    from lqrrt_tpu_torch.parallel import mesh as meshlib

    prob = di.default_problem()
    args = (prob["dynamics"], prob["lqr"], prob["erf"],
            prob["constraints"].is_feasible, prob["constraints"].goal_buffer)
    dist.init_process_group("gloo", init_method=f"file://{tempfile.mktemp()}",
                            world_size=1, rank=0)
    try:
        mesh = meshlib.make_fleet_mesh(1, device_type="cpu")
        fleet = FleetPlanner(*args, horizon=1.0, n_scenarios=2, mesh=mesh,
                             device="cpu")
        assert (fleet._n_local, fleet._offset) == (2, 0)
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: True)
            with pytest.raises(ValueError, match="device is cuda"):
                FleetPlanner(*args, horizon=1.0, n_scenarios=2, mesh=mesh)
    finally:
        dist.destroy_process_group()
    grid = grid_free_data(origin=(0.0, 0.0), resolution=0.5)
    FleetPlanner(*args[:3], grid, args[4], horizon=1.0, n_scenarios=2,
                 per_scenario_data=True, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetPlanner(*args, horizon=1.0, n_scenarios=2)
    fleet = FleetPlanner(*args, horizon=1.0, n_scenarios=2, device="cpu")
    assert fleet.device.type == "cpu"
    x0s = np.zeros((3, 4), np.float32)
    with pytest.raises(ValueError, match="scenarios"):
        fleet.plan(x0s, x0s, prob["sample_space"], goal_bias=0.2, rounds=1)


def test_ncontrols_probe():
    """lqr(x0, None) gives m; an lqr that uses u cannot be probed: a clear
    ValueError, and ncontrols= skips the probe (JAX's test)."""
    prob = di.default_problem()
    lqr = prob["lqr"]

    def lqr_uses_u(x, u):
        return lqr(x, u + 0.0 * u)

    x0s = np.zeros((2, 4), np.float32)
    goals = np.tile(np.asarray(prob["goal"]), (2, 1))
    kw = dict(horizon=1.0, dt=DT, n_scenarios=2, batch_size=8, capacity=64,
              nn_block=64, device="cpu")
    args = (prob["dynamics"], lqr_uses_u, prob["erf"],
            prob["constraints"].is_feasible, prob["constraints"].goal_buffer)
    with pytest.raises(ValueError, match="ncontrols"):
        FleetPlanner(*args, **kw).plan(x0s, goals, prob["sample_space"],
                                       goal_bias=0.2, rounds=1)
    st = FleetPlanner(*args, ncontrols=2, **kw).plan(
        x0s, goals, prob["sample_space"], goal_bias=0.2, rounds=2)
    assert st["rounds"] == 2
    probed = FleetPlanner(prob["dynamics"], lqr, *args[2:], **kw)
    probed.plan(x0s, goals, prob["sample_space"], goal_bias=0.2, rounds=1)
    assert probed.spec.ncontrols == 2 and probed.nstates == 4


def test_fleet_demo_small(capsys):
    rc = fleet_demo.main(["--scenarios", "4", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu, scenarios: 4"
    assert out[1].startswith("fleet: 4 scenarios x 16 rounds in ")
    assert out[2].startswith("fleet: goal rate ")
    assert out[3].startswith("fleet: scenario 0 plan has ")
    rate = float(out[2].split()[3].rstrip(","))
    assert rc == (0 if rate > 0.5 else 1)


# ---- per-scenario occupancy grids ------------------------------------------

def _scenario_walls(S, Hg=32, Wg=64):
    """S grids over x in [-2, 14), y in [-4, 4) at 0.25 m: scenario s a
    wall at x in [1 + 0.5 s, 1.5 + 0.5 s), with a gap at y in [-0.5, 0.5)
    for even s."""
    occ = np.zeros((S, Hg, Wg), bool)
    for s in range(S):
        occ[s, :, 12 + 2 * s:14 + 2 * s] = True
        if s % 2 == 0:
            occ[s, 14:18, 12 + 2 * s:14 + 2 * s] = False
    return occ, (-2.0, -4.0), 0.25


def test_grid_predicate_with_leading_axes_reads_each_scenario_grid():
    """x (S, B, n) against (S, H, W) grids: each row is its own scenario's
    verdict, as the 2-D grid gives it; circles the same with (S, K, 2)."""
    occ, origin, res = _scenario_walls(5)
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.uniform(-3, 15, (5, 200, 4)).astype(np.float32))
    pred = grid_free_data(origin, res)
    got = pred(x, None, torch.from_numpy(occ))
    assert got.shape == (5, 200)
    for s in range(5):
        assert torch.equal(got[s], pred(x[s], None, torch.from_numpy(occ[s])))
    assert not got.all() and got.any()
    cpred = circles_free_data(margin=0.1)
    data = {"centers": torch.from_numpy(rng.uniform(0, 10, (5, 3, 2)).astype(
        np.float32)), "radii": torch.full((5, 3), 1.5)}
    got = cpred(x, None, data)
    for s in range(5):
        assert torch.equal(got[s], cpred(x[s], None, {
            k: v[s] for k, v in data.items()}))


def test_fleet_per_scenario_grid_round_equals_jax():
    """The fleet's round with a grid a scenario (``grid_free_data``,
    ``per_scenario_data=True``) against JAX's vmapped round with each
    scenario's grid, three rounds at S = 4 on the same candidates: the
    trees row for row (the round-lockstep tolerances above); no node in its
    own scenario's wall, some in another's; the (S, H, W) grids are the one
    copy the predicate reads."""
    from lqrrt_tpu.ops import collision as jcollision

    S, n, m = LS, 4, 2
    occ, origin, res = _scenario_walls(S)
    jprob, tprob = jdi.default_problem(), di.default_problem()
    jf = JFleet(jprob["dynamics"], jprob["lqr"], jprob["erf"],
                jcollision.grid_free_data(origin, res),
                jprob["constraints"].goal_buffer, horizon=LH * DT, dt=DT,
                n_scenarios=S, batch_size=LB, capacity=LCAP, nn_block=LBLK,
                saturate=jprob["saturate"], per_scenario_data=True)
    jf._build(n, m)
    gb = jprob["constraints"].goal_buffer
    jgrid = jcollision.grid_free_data(origin, res)

    def jround(t, xr, goal, data):
        return jrounds.make_round(
            jf.spec, jprob["dynamics"], jprob["lqr"], jprob["erf"],
            lambda x, u: jgrid(x, u, data), 0.05, gb,
            xrand_gen=lambda k, b: k, saturate=jprob["saturate"])(
                t, xr, goal, None, None, None)

    vround = jax.jit(jax.vmap(jround))
    jS, jK = (np.asarray(a) for a in jprob["lqr"](None, None))
    pf = FleetPlanner(tprob["dynamics"], interop.lqr_from_numpy(jS, jK),
                      tprob["erf"], grid_free_data(origin, res), gb,
                      horizon=LH * DT, dt=DT, n_scenarios=S, batch_size=LB,
                      capacity=LCAP, nn_block=LBLK,
                      saturate=tprob["saturate"], per_scenario_data=True,
                      device="cpu")
    pf._build(n, m)
    pf._data_box[0] = torch.from_numpy(occ)
    rng = np.random.default_rng(17)
    x0s = np.zeros((S, n), np.float32)
    x0s[:, 1] = rng.uniform(-1, 1, S)
    goals = np.tile(np.asarray(tprob["goal"]), (S, 1))
    goals[:, 0] = 4.0
    jtrees = jf._vseed(jnp.asarray(x0s), jnp.asarray(goals))
    ptrees = interop.tree_from_numpy(jax.device_get(jtrees), device="cpu")
    goal_rows = torch.from_numpy(np.repeat(goals, LB, 0))
    for _ in range(3):
        xr = rng.uniform([-1, -3, -2, -2], [6, 3, 2, 2],
                         (S, LB, n)).astype(np.float32)
        jtrees = vround(jtrees, jnp.asarray(xr), jnp.asarray(goals),
                        jnp.asarray(occ))
        pf._round(ptrees, torch.from_numpy(xr), goal_rows)
        got, want = _np(ptrees), _np(jax.device_get(jtrees))
        np.testing.assert_array_equal(got["size"], want["size"])
        for f in ("parent", "edge_len", "in_goal", "n_children"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        for f in ("state", "edge_x"):
            np.testing.assert_allclose(got[f], want[f], atol=1e-3,
                                       err_msg=f)
    inside = _in_walls(got, occ, origin, res)
    assert inside.trace() == 0 and inside.sum() > 0, inside
    pf.plan(x0s, goals, tprob["sample_space"], goal_bias=0.2, rounds=1,
            feasibility_data=occ)
    assert tuple(pf._data_box[0].shape) == occ.shape   # no copy a row


def _in_walls(t, occ, origin, res):
    """(S, S) counts: nodes of scenario i inside scenario j's wall."""
    S, Hg, Wg = occ.shape
    out = np.zeros((S, S), int)
    for i in range(S):
        p = t["state"][i, :t["size"][i], :2]
        c = np.floor((p - np.asarray(origin)) / res).astype(int)
        ok = (c[:, 0] >= 0) & (c[:, 0] < Wg) & (c[:, 1] >= 0) & (
            c[:, 1] < Hg)
        for j in range(S):
            out[i, j] = int(occ[j, c[ok, 1], c[ok, 0]].sum())
    return out


# ---- the fleet on a 2-rank mesh ---------------------------------------------

@pytest.fixture(scope="module")
def fleet_job():
    import tempfile

    import _torch_mesh_worker as W

    tmp = tempfile.mkdtemp(prefix="torch_fleet2_")
    prob = di.default_problem()
    S0, K0 = prob["lqr"](torch.zeros(4), torch.zeros(2))
    procs = W.spawn(2, dict(jS=S0.numpy(), jK=K0.numpy()), ["fleet"], tmp)
    return W.collect(procs, tmp, timeout=240)


def test_fleet_mesh_whole_fleet_stats_on_every_rank(fleet_job):
    """8 scenarios over 2 ranks, 4 each: ``plan`` gathers the whole fleet's
    sizes, goals and best nodes on both ranks, each rank's block is its
    own trees, the budget's chunks follow the first rank's clock on both
    (the other rank's alone would stop after one round), and an
    indivisible scenario count raises naming both numbers."""
    a, b = fleet_job
    for k in ("fixed/sizes", "fixed/goal_found", "fixed/best"):
        np.testing.assert_array_equal(a[f"fleet/{k}"], b[f"fleet/{k}"])
    sizes = a["fleet/fixed/sizes"]
    assert sizes.shape == (8,) and (sizes > 1).all()
    np.testing.assert_array_equal(a["fleet/fixed/local_sizes"], sizes[:4])
    np.testing.assert_array_equal(b["fleet/fixed/local_sizes"], sizes[4:])
    assert not np.array_equal(sizes[:4], sizes[4:])   # own generators
    assert int(a["fleet/budget/rounds"]) == int(b["fleet/budget/rounds"]) > 1
    for o in (a, b):
        assert str(o["fleet/indivisible"]) == (
            "n_scenarios=7 is not divisible by the mesh 'scenario' axis "
            "size 2")


def test_fleet_mesh_serves_the_owned_plans(fleet_job):
    a, b = fleet_job
    np.testing.assert_array_equal(a["fleet/owned"], [0, 1, 2, 3])
    np.testing.assert_array_equal(b["fleet/owned"], [4, 5, 6, 7])
    assert "lives on rank 1" in str(a["fleet/refused"])
    assert "lives on rank 0" in str(b["fleet/refused"])
    rng = np.random.default_rng(0)
    x0s = np.zeros((8, 4), np.float32)
    x0s[:, 1] = rng.uniform(-1, 1, 8)
    np.testing.assert_allclose(a["fleet/plan_starts"], x0s[:4], atol=1e-6)
    np.testing.assert_allclose(b["fleet/plan_starts"], x0s[4:], atol=1e-6)


def test_fleet_mesh_per_scenario_grids(fleet_job):
    """Per-scenario grids on the mesh: each rank reads its block of the
    (8, 32, 48) grids; no node in its own scenario's wall."""
    a, b = fleet_job
    S = 8
    occ = np.zeros((S, 32, 48), bool)
    for s in range(S):
        occ[s, :, 12 + s:14 + s] = True
    t = {"state": np.concatenate([a["fleet/grid/state"],
                                  b["fleet/grid/state"]]),
         "size": np.concatenate([a["fleet/grid/size"],
                                 b["fleet/grid/size"]])}
    inside = _in_walls(t, occ, (-2.0, -4.0), 0.25)
    assert inside.trace() == 0 and inside.sum() > 0
