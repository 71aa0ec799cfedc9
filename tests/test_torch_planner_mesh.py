"""``Planner(mesh=...)`` and ``Planner(feasibility_grid=...)`` on the CPU
(``lqrrt_tpu_torch/planner.py`` with ``parallel/``): a 2-rank and a 4-rank
gloo job, each spawned once for the module (``tests/_torch_mesh_worker.py``,
whose ranks join through ``parallel.mesh.init_distributed``, the
counterpart of tests/test_distributed.py).

End to end on the double integrator, every rank must reach the goal with
a feasible plan, and every rank's plan must be the same: the fused restart
path (gather), topk on the host loop, FPR with a kill on the last rank
only, circle data through a 3-arg predicate, the 2-D hosts x chips mesh,
and a dp x map mesh with a sharded grid (the host loop's restart stash
firing, its plan off the wall on the full grid).  Ranks whose clocks
disagree stop at the same round on both loops.  In one process on a
world-1 gloo group: the restart chunk always gathers, on both packages,
and the constructor's refusals.
"""
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

import _torch_mesh_worker as W
import lqrrt_tpu
from lqrrt_tpu.core import rounds as jrounds
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu.parallel import mesh as jmesh
import lqrrt_tpu_torch
from lqrrt_tpu_torch import planner as pplanner
from lqrrt_tpu_torch.models import double_integrator as di
from lqrrt_tpu_torch.parallel import mesh as meshlib
from lqrrt_tpu_torch.parallel.map_sharded import ShardedGrid

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jobs():
    jprob = jdi.default_problem()
    jS, jK = (np.asarray(a) for a in jprob["lqr"](None, None))
    inputs = dict(jS=jS, jK=jK)
    tmp2 = tempfile.mkdtemp(prefix="torch_pmesh2_")
    tmp4 = tempfile.mkdtemp(prefix="torch_pmesh4_")
    p2 = W.spawn(2, inputs, ["planners", "agree"], tmp2)
    p4 = W.spawn(4, inputs, ["mesh2d", "grid_planner"], tmp4)
    return (W.collect(p2, tmp2, timeout=300),
            W.collect(p4, tmp4, timeout=300))


def _check_plans(outs, prefix, x0, goal, gbuf):
    for o in outs:
        assert bool(o[f"{prefix}/reached"]), prefix
        assert bool(o[f"{prefix}/feasible"]), prefix
        xs = o[f"{prefix}/x_seq"]
        np.testing.assert_allclose(xs[0], x0, atol=1e-5)
        assert np.all(np.abs(goal - xs[-1]) <= gbuf + 1e-5), prefix
        np.testing.assert_array_equal(xs, outs[0][f"{prefix}/x_seq"])
        for k in ("rounds", "restarts", "nodes"):
            assert int(o[f"{prefix}/{k}"]) == int(outs[0][f"{prefix}/{k}"])


@pytest.mark.parametrize("case", ["gather", "topk", "fpr", "data"])
def test_mesh_replans_reach_the_goal(jobs, case):
    prob = di.default_problem()
    _check_plans(jobs[0], f"planners/{case}", prob["x0"], prob["goal"],
                 prob["constraints"].goal_buffer)
    rounds = int(jobs[0][0][f"planners/{case}/rounds"])
    if case == "topk":               # the host loop: no restart
        assert int(jobs[0][0]["planners/topk/restarts"]) == 0
        assert rounds % 4 == 0
    else:                            # the restart chunk: 8 rounds a chunk
        assert int(jobs[0][0][f"planners/{case}/restarts"]) >= 1


def test_mesh_replan_killed_on_one_rank_stops_every_rank(jobs):
    """The last rank's kill_update after its second clock read: both
    ranks stop after that one chunk, with a plan."""
    outs = jobs[0]
    for o in outs:
        assert int(o["planners/fpr_kill/rounds"]) == 8
        assert o["planners/fpr_kill/x_seq"].shape[0] > 1
    np.testing.assert_array_equal(outs[0]["planners/fpr_kill/x_seq"],
                                  outs[1]["planners/fpr_kill/x_seq"])


def test_ranks_with_disagreeing_clocks_stop_together(jobs):
    """Rank r's clock reads 0 for 3 + 4 r calls: alone the ranks would run
    different numbers of chunks (and their collectives would hang); they
    agree once a chunk and stop at the same round."""
    outs = jobs[0]
    for loop in ("restart", "host"):
        rounds = [int(o[f"agree/{loop}/rounds"]) for o in outs]
        assert rounds[0] == rounds[1] > 0, (loop, rounds)


def test_hosts_by_chips_mesh_replan(jobs):
    prob = di.default_problem()
    _check_plans(jobs[1], "mesh2d/mesh2d", prob["x0"], prob["goal"],
                 prob["constraints"].goal_buffer)


def test_grid_mesh_replan_with_the_restart_stash(jobs):
    """dp x map = 2 x 2 with the wall's grid in two slabs: the host loop
    restarts (capacity 256 fills every four rounds), the plan threads the
    gap, and no plan state lies in an occupied cell of the full grid."""
    prob = di.default_problem(obstacles=False)
    _check_plans(jobs[1], "grid_planner/grid", W.GRID_X0, W.GRID_GOAL,
                 prob["constraints"].goal_buffer)
    for o in jobs[1]:
        assert int(o["grid_planner/grid/restarts"]) >= 1
        assert not bool(o["grid_planner/grid/occupied"])
        xs = o["grid_planner/grid/x_seq"]
        assert xs[0][0] < 7.0 and xs[-1][0] > 13.0


# ---- one process, a world-1 gloo group -------------------------------------

@pytest.fixture(scope="module")
def world1():
    init = tempfile.mktemp(prefix="torch_pmesh_store_")
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            world_size=1, rank=0)
    yield meshlib
    dist.destroy_process_group()


def _port(mesh, **kw):
    prob = di.default_problem()
    args = dict(horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
                printing=False, batch_size=64, capacity=512, nn_block=128,
                saturate=prob["saturate"], mesh=mesh, device="cpu")
    args.update(kw)
    return lqrrt_tpu_torch.Planner(prob["dynamics"], prob["lqr"],
                                   prob["constraints"], **args), prob


def _two_reads():
    """A clock that reads 0 twice (t0 and the first budget check), then
    1e9: one chunk."""
    calls = [0]

    def clock():
        calls[0] += 1
        return 0.0 if calls[0] <= 2 else 1e9
    return clock


def test_restart_chunk_always_gathers_on_both(world1, monkeypatch):
    """A default-mode planner with ``collective="topk"``: the fused
    restart chunk commits the whole batch a round, in JAX (its ``grow``
    calls gather_candidates whatever the collective) and in the port."""
    mesh = world1.make_mesh(1, device_type="cpu")
    seen = []
    real = pplanner.commit_candidates
    monkeypatch.setattr(pplanner, "commit_candidates", lambda spec, t, c, **k: (
        seen.append(c.pids.shape[0]), real(spec, t, c, **k))[1])
    p, prob = _port(mesh, collective="topk", topk=16)
    p.sys_time = _two_reads()
    p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                  specific_time=1.0, pruning=False)
    assert p.stats["rounds"] == 8 and seen == [64] * 8
    # JAX, on 2 of the conftest's devices
    jseen = []
    jreal = jrounds.commit_candidates
    monkeypatch.setattr(jrounds, "commit_candidates", lambda spec, t, c, **k: (
        jseen.append(c.pids.shape[0]), jreal(spec, t, c, **k))[1])
    jprob = jdi.default_problem()
    jp = lqrrt_tpu.Planner(
        jprob["dynamics"], jprob["lqr"], jprob["constraints"],
        horizon=jprob["horizon"], dt=jprob["dt"], goal0=jprob["goal"],
        printing=False, batch_size=64, capacity=512, nn_block=128,
        saturate=jprob["saturate"], mesh=jmesh.make_mesh(2),
        collective="topk", topk=16)
    jp.sys_time = _two_reads()
    jp.update_plan(jprob["x0"], jprob["sample_space"], goal_bias=0.2,
                   specific_time=1.0, pruning=False)
    assert jp.stats["rounds"] == 8 and set(jseen) == {64}   # traced
    assert jax.device_count() == 8


def test_constructor_refusals(world1, monkeypatch):
    mesh = world1.make_mesh(1, device_type="cpu")
    occ, origin, res = W.grid_world()
    with pytest.raises(ValueError, match="requires mesh"):
        _port(None, feasibility_grid=ShardedGrid(occ, origin, res, 1))
    with pytest.raises(ValueError, match="no 'map' axis"):
        _port(mesh, feasibility_grid=ShardedGrid(occ, origin, res, 1))
    mmesh = world1.make_mesh_dp_map(1, 1, device_type="cpu")
    with pytest.raises(ValueError, match="2 shards"):
        _port(mmesh, feasibility_grid=ShardedGrid(occ, origin, res, 2))
    with pytest.raises(ValueError, match="leaf_rewire"):
        _port(mmesh, feasibility_grid=ShardedGrid(occ, origin, res, 1),
              refine_mode="leaf_rewire")
    with pytest.raises(ValueError, match="no 'nope' axis"):
        _port(mesh, mesh_axis="nope")
    # the mesh's device type must be the planner's
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="the planner's device is cuda"):
        _port(mesh, device="cuda")
    p, _ = _port(mesh)
    assert p.mesh is mesh and p._rank_gen is not p._gen
