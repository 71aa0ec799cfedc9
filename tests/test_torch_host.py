"""The port's host-side surface against the JAX package (CPU): the host
``Tree`` and ``Planner.get_tree``, checkpoints in both packages' npz layout,
the metrics sinks, the phase timer and trace, the replan watchdog, the
atomic plan swap, and the native trajectory server.

Tolerances: tree arrays, plans and ``get_state`` carried through a
checkpoint are equal (the same numbers written and read); the trajectory
server interpolates in fp32 with a float64 time, 1e-6 against numpy.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

import jax

import lqrrt_tpu
from lqrrt_tpu.core.tree import TreeArrays as JTree
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu.tree import Tree as JHostTree
from lqrrt_tpu.utils import checkpoint as jcheckpoint
from lqrrt_tpu_torch import Planner, Tree, interop
from lqrrt_tpu_torch.models import double_integrator as di
from lqrrt_tpu_torch.utils import (BufferSink, JsonlSink, PhaseTimer,
                                   ReplanWatchdog, attach, checkpoint,
                                   device_trace, timed_call)

torch.set_num_threads(2)


def _planner(**kw):
    prob = di.default_problem()
    args = dict(min_time=0.0, max_time=5.0, printing=False, batch_size=32,
                capacity=256, nn_block=128, seed=1, device="cpu")
    args.update(kw)
    return prob, Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                         horizon=prob["horizon"], dt=prob["dt"],
                         goal0=prob["goal"], **args)


def _plan(planner, prob, t=1.0, **kw):
    return planner.update_plan(prob["x0"], prob["sample_space"],
                               goal_bias=0.2, specific_time=t,
                               pruning=False, **kw)


# ------------------------------------------------------------ host Tree

def _mk_host_trees():
    """tests/test_tree.py's tree in both packages: chain 0 -> 1 -> 2 and
    branch 0 -> 3."""
    out = []
    for T in (Tree, JHostTree):
        t = T(np.zeros(2), (np.eye(2), np.ones((1, 2))))
        t.add_node(0, [1.0, 0.0], (np.eye(2), np.ones((1, 2))),
                   x_seq=[[0.5, 0.0], [1.0, 0.0]], u_seq=[[0.1], [0.1]])
        t.add_node(1, [2.0, 0.0], (np.eye(2), np.ones((1, 2))),
                   x_seq=[[1.5, 0.0], [2.0, 0.0]], u_seq=[[0.2], [0.2]])
        t.add_node(0, [0.0, 1.0], (np.eye(2), np.ones((1, 2))),
                   x_seq=[[0.0, 1.0]], u_seq=[[0.3]])
        out.append(t)
    return out


def test_host_tree_climb_trajectory_and_bad_parent():
    """tests/test_tree.py:22-43 on both packages' Tree, results equal."""
    t, jt = _mk_host_trees()
    assert t.climb(2) == jt.climb(2) == [0, 1, 2]
    assert t.climb(3) == [0, 3] and t.climb(0) == [0] and t.size == 4
    xs, us = t.trajectory(t.climb(2))
    np.testing.assert_allclose(xs, [[0.5, 0], [1, 0], [1.5, 0], [2, 0]])
    np.testing.assert_allclose(us, [[0.1], [0.1], [0.2], [0.2]])
    jxs, jus = jt.trajectory(jt.climb(2))
    np.testing.assert_array_equal(xs, jxs)
    np.testing.assert_array_equal(us, jus)
    xs0, us0 = t.trajectory([0])
    np.testing.assert_array_equal(xs0, jt.trajectory([0])[0])
    with pytest.raises(IndexError):
        t.add_node(99, [0, 0], None, [[0, 0]], [[0]])


def _snapshot_checks(planner, t, tol=1e-5):
    """Sizes agree, every kept node's incoming edge ends at its state
    (within ``tol`` in norm), and a climb from any node reaches the
    root."""
    assert t.size > 1
    assert len(t.pID) == t.size == len(t.x_seq) == len(t.lqr)
    for i in range(1, t.size):
        assert 0 <= t.pID[i] < t.size
        assert np.linalg.norm(t.x_seq[i][-1] - t.state[i]) <= tol
    chain = t.climb(t.size - 1)
    assert chain[0] == 0 and chain[-1] == t.size - 1


def test_get_tree_snapshot_consistent():
    """tests/test_tree.py:83: get_tree snapshots the device tree into the
    host Tree, lazily, once a replan; and equals the JAX package's
    snapshot of the same arrays (rows in commit order)."""
    prob, planner = _planner(seed=4, max_time=10.0)
    with pytest.raises(RuntimeError, match="update_plan"):
        planner.get_tree()
    _plan(planner, prob)
    t = planner.get_tree()
    assert planner.get_tree() is t
    np.testing.assert_allclose(t.state[0], prob["x0"], atol=1e-6)
    _snapshot_checks(planner, t)
    jt = JHostTree.from_device_arrays(
        JTree(**interop.tree_to_numpy(planner._device_tree)))
    assert t.pID == jt.pID and t.size == jt.size
    np.testing.assert_array_equal(t.state, jt.state)
    for a, b in zip(t.x_seq + t.u_seq, jt.x_seq + jt.u_seq):
        np.testing.assert_array_equal(a, b)
    _plan(planner, prob, t=0.2)
    assert planner.tree is None and planner.get_tree() is not t


def test_get_tree_of_a_refined_tree_out_of_row_order():
    """leaf_rewire leaves parents at higher rows than their children; the
    snapshot stays consistent, and the best node's climb and trajectory
    equal the plan before pruning."""
    prob = di.default_problem()
    calls = {"n": 0}

    def clock():
        calls["n"] += 1
        return 0.0 if calls["n"] <= 31 else 1e9

    planner = Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                      horizon=prob["horizon"], dt=prob["dt"],
                      goal0=prob["goal"], printing=False, batch_size=64,
                      capacity=256, nn_block=128, saturate=prob["saturate"],
                      seed=7, rounds_per_chunk=2, refine_mode="leaf_rewire",
                      device="cpu")
    planner.sys_time = clock
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        pruning=False, specific_time=1.0)
    d = interop.tree_to_numpy(planner._device_tree)
    size = int(d["size"])
    assert (d["parent"][:size] > np.arange(size)).sum() >= 10
    t = planner.get_tree()
    # a rewired edge ends within error_tol of its node's state
    _snapshot_checks(planner, t, tol=planner.error_tol + 1e-6)
    # the best node, renumbered as the snapshot keeps rows
    keep = d["edge_len"][:size] > 0
    keep[0] = True
    best = planner._last_chain[-1]
    while not keep[best]:             # a zero-length row: its parent's
        best = d["parent"][best]
    xs, us = t.trajectory(t.climb(int(np.cumsum(keep)[best] - 1)))
    np.testing.assert_array_equal(xs, planner.x_seq[1:])
    np.testing.assert_array_equal(us, planner.u_seq)


def test_snapshot_resolves_zero_length_rows_in_any_order():
    """Zero-length rows 3 and 5 (copies of row 2) with row 3's parent at
    the higher row 5, and a real row 4 below row 3: the port resolves row
    4's parent to row 2; the JAX snapshot's one forward pass, which
    assumes parents precede children, makes row 4 its own parent."""
    N, H, n, m = 8, 3, 2, 1
    d = dict(state=np.zeros((N, n), np.float32),
             S=np.tile(np.eye(n, dtype=np.float32), (N, 1, 1)),
             K=np.zeros((N, m, n), np.float32),
             parent=np.array([-1, 0, 0, 5, 3, 2, -1, -1], np.int32),
             edge_x=np.zeros((H, n, N), np.float32),
             edge_u=np.zeros((H, m, N), np.float32),
             edge_len=np.array([0, 2, 2, 0, 1, 0, 0, 0], np.int32),
             node_time=np.zeros(N, np.float32),
             in_goal=np.zeros(N, bool), goal_cost=np.ones(N, np.float32),
             n_children=np.array([2, 0, 0, 1, 0, 0, 0, 0], np.int32),
             size=np.int32(6), goal_found=np.bool_(False))
    rows = {1: [0.5, 0.0], 2: [1.0, 1.0], 3: [1.0, 1.0], 4: [2.0, 2.0],
            5: [1.0, 1.0]}
    for i, x in rows.items():
        d["state"][i] = x
        d["edge_x"][:, :, i] = x
    t = Tree.from_device_arrays(interop.tree_from_numpy(d, device="cpu"))
    assert t.size == 4 and t.pID == [-1, 0, 0, 2]
    np.testing.assert_array_equal(t.state, d["state"][[0, 1, 2, 4]])
    jt = JHostTree.from_device_arrays(JTree(**d))
    assert jt.pID[3] == 3


# --------------------------------------------------------- checkpoints

@pytest.fixture(scope="module")
def jax_planned():
    """A JAX planner after one replan (tests/test_utils.py:61's)."""
    prob = jdi.default_problem()
    p = lqrrt_tpu.Planner(prob["dynamics"], prob["lqr"],
                          prob["constraints"], horizon=prob["horizon"],
                          dt=prob["dt"], goal0=prob["goal"], min_time=0.0,
                          max_time=5.0, printing=False, batch_size=32,
                          capacity=256, nn_block=128, seed=1)
    p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                  specific_time=1.0, pruning=False)
    return p


def _older_format(path, fmt, out):
    """Rewrite a format-4 checkpoint as format 3 (edge arrays (N, H, .))
    or format 2 (also no tree_n_children)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    data["format"] = np.int64(fmt)
    for f in ("tree_edge_x", "tree_edge_u"):
        data[f] = np.transpose(data[f], (2, 0, 1))
    if fmt == 2:
        del data["tree_n_children"]
    np.savez_compressed(out, **data)
    return out


@pytest.mark.parametrize("fmt", [4, 3, 2])
def test_jax_checkpoint_loads_into_the_port(jax_planned, tmp_path, fmt):
    """A JAX checkpoint with its tree, in formats 4, 3 and 2: the goal,
    the plan, plan_reached_goal and get_state equal the JAX planner's, and
    the tree arrays equal its tree's (format 2's child counts rebuilt from
    the parents, real edges only)."""
    jp = jax_planned
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(jp, path, include_tree=True)
    if fmt != 4:
        path = _older_format(path, fmt, str(tmp_path / f"jax{fmt}.npz"))
    _, p = _planner(seed=99)
    gen_before = p._gen.get_state()
    checkpoint.load(p, path)
    assert torch.equal(p._gen.get_state(), gen_before)  # a JAX key: dropped
    np.testing.assert_array_equal(p.goal.numpy(), np.asarray(jp.goal))
    np.testing.assert_array_equal(p.x_seq, jp.x_seq)
    np.testing.assert_array_equal(p.u_seq, jp.u_seq)
    assert p.T == jp.T and p.plan_reached_goal == jp.plan_reached_goal
    for t in (0.0, 0.37, 1.0, 2.5, 99.0):
        np.testing.assert_array_equal(p.get_state(t), jp.get_state(t))
        np.testing.assert_array_equal(p.get_effort(t), jp.get_effort(t))
    want = jax.device_get(jp._device_tree)._asdict()
    for f, got in interop.tree_to_numpy(p._device_tree).items():
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    assert p._device_tree.state.device.type == "cpu"
    t = p.get_tree()
    assert t.pID == JHostTree.from_device_arrays(jp._device_tree).pID


def test_port_checkpoint_roundtrip(tmp_path):
    """tests/test_utils.py:61 on the port: plan, goal, tree and the
    generator's stream carry over; the JAX package reads the file too."""
    prob, planner = _planner()
    _plan(planner, prob)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(planner, path, include_tree=True)
    _, fresh = _planner(seed=99)
    checkpoint.load(fresh, path)
    np.testing.assert_array_equal(fresh.x_seq, planner.x_seq)
    np.testing.assert_array_equal(fresh.u_seq, planner.u_seq)
    assert fresh.T == planner.T
    assert fresh.plan_reached_goal == planner.plan_reached_goal
    np.testing.assert_array_equal(fresh.goal.numpy(), planner.goal.numpy())
    for f, a in interop.tree_to_numpy(planner._device_tree).items():
        np.testing.assert_array_equal(
            interop.tree_to_numpy(fresh._device_tree)[f], a, err_msg=f)
    np.testing.assert_array_equal(
        torch.rand(8, generator=fresh._gen).numpy(),
        torch.rand(8, generator=planner._gen).numpy())
    jprob = jdi.default_problem()
    jp = lqrrt_tpu.Planner(jprob["dynamics"], jprob["lqr"],
                           jprob["constraints"], horizon=2.0,
                           goal0=jprob["goal"], printing=False,
                           batch_size=32, capacity=256, nn_block=128)
    jcheckpoint.load(jp, path)
    np.testing.assert_array_equal(jp.x_seq, planner.x_seq)
    assert int(jp._device_tree.size) == int(planner._device_tree.size)


def test_checkpoint_dim_mismatch(tmp_path):
    """tests/test_utils.py:85: a checkpoint of another problem's size."""
    prob, planner = _planner()
    _plan(planner, prob, t=0.2)
    path = str(tmp_path / "ckpt.npz")
    checkpoint.save(planner, path)
    from lqrrt_tpu_torch.models import boat
    bprob = boat.default_problem()
    other = Planner(bprob["dynamics"], bprob["lqr"], bprob["constraints"],
                    horizon=1.0, dt=0.05, goal0=bprob["goal"],
                    printing=False, batch_size=16, capacity=128,
                    nn_block=128, device="cpu")
    with pytest.raises(ValueError, match="dims"):
        checkpoint.load(other, path)


# ----------------------------------------------- metrics, timer, trace

def test_metrics_sinks(tmp_path):
    """tests/test_utils.py:27 on the port."""
    prob, planner = _planner()
    buf = BufferSink()
    attach(planner, buf, JsonlSink(str(tmp_path / "replans.jsonl")))
    _plan(planner, prob, t=0.3)
    _plan(planner, prob, t=0.3)
    assert [r["replan_seq"] for r in buf.records] == [0, 1]
    for r in buf.records:
        assert {"nodes", "rounds", "expansions_per_s", "goal_found",
                "total_s", "ts"} <= set(r)
    s = buf.summary()
    assert s["replans"] == 2 and 0.0 <= s["goal_rate"] <= 1.0
    lines = (tmp_path / "replans.jsonl").read_text().strip().split("\n")
    assert len(lines) == 2 and json.loads(lines[0])["replan_seq"] == 0


def test_phase_timer_trace_and_timed_call(tmp_path):
    """tests/test_utils.py:50 on the port: fenced phases count and sum;
    the trace writes its file; timed_call returns the outputs."""
    t = PhaseTimer()
    x = torch.ones((256, 256))
    with t.phase("matmul", fence=x):
        y = x @ x
    with t.phase("matmul", fence={"y": [y]}):
        y = y @ y
    s = t.summary()
    assert s["matmul"]["count"] == 2 and s["matmul"]["total_s"] > 0
    with device_trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    out, dt = timed_call(torch.matmul, x, x)
    assert out.shape == (256, 256) and dt > 0


# ------------------------------------------------- watchdog, plan swap

def test_watchdog_fires_and_salvages():
    """tests/test_utils.py:99 on the port, with min_time at the budget too
    (on the CPU the port finds the goal well inside the armed second)."""
    prob, planner = _planner(min_time=60.0, max_time=60.0)
    wd = ReplanWatchdog(planner, grace=0.0)
    with wd.guard(budget_s=1.0):
        planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.1,
                            pruning=False)
    assert wd.fired and wd.fire_count == 1
    assert planner.x_seq is not None and planner.stats["elapsed_s"] < 30


def test_watchdog_disarms_cleanly():
    """tests/test_utils.py:110 on the port."""
    prob, planner = _planner()
    wd = ReplanWatchdog(planner, grace=10.0)
    with wd.guard(budget_s=10.0):
        _plan(planner, prob, t=0.3)
    time.sleep(0.05)
    assert not wd.fired


def test_atomic_plan_swap_under_concurrent_reads():
    """tests/test_utils.py:119 on the port: a controller thread never sees
    a torn plan while replans commit."""
    prob, planner = _planner()
    _plan(planner, prob, t=0.3)
    n, m = planner.nstates, planner.ncontrols
    errors = []
    stop = threading.Event()

    def controller():
        # a 1 kHz controller: a thread that never sleeps would hold the
        # GIL between each of the chunk's torch calls
        while not stop.wait(0.001):
            try:
                x = planner.get_state(1.0)
                u = planner.get_effort(1.0)
                if x.shape != (n,) or u.shape != (m,):
                    errors.append("shape")
                plan = planner._plan
                if abs(plan[2] - planner.dt * (len(plan[0]) - 1)) > 1e-6:
                    errors.append("torn")
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    th = threading.Thread(target=controller)
    th.start()
    try:
        for _ in range(3):
            _plan(planner, prob, t=0.3)
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive() and not errors, errors[:5]


# ------------------------------------------------- trajectory server

@pytest.fixture
def TrajectoryServer():
    """The server class, its library built from the port's C source; the
    test is skipped only where no C compiler exists."""
    from lqrrt_tpu_torch.runtime import NativeUnavailable, TrajectoryServer
    try:
        TrajectoryServer(2, 1, cap_steps=16)
    except NativeUnavailable as e:
        pytest.skip(f"no C compiler for the trajectory server: {e}")
    return TrajectoryServer


def test_server_query_parity(TrajectoryServer):
    """tests/test_runtime.py:23: linear interpolation of states and
    efforts with endpoint hold, against numpy."""
    n, m, dt = 3, 2, 0.05
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, n)).astype(np.float32)
    u = rng.normal(size=(39, m)).astype(np.float32)
    ts = TrajectoryServer(n, m, cap_steps=64)
    ts.publish(x, u, dt)
    assert abs(ts.T - dt * 39) < 1e-9
    for t in (-1.0, 0.0, 0.024, 0.31, 1.234, dt * 39, 99.0):
        for seq, got in ((x, ts.get_state(t)), (u, ts.get_effort(t))):
            tau = np.clip(t / dt, 0, len(seq) - 1)
            i = int(np.floor(tau))
            j = min(i + 1, len(seq) - 1)
            np.testing.assert_allclose(
                got, (1 - (tau - i)) * seq[i] + (tau - i) * seq[j],
                rtol=1e-6, atol=1e-6)


def test_server_capacity_and_unpublished_errors(TrajectoryServer):
    """tests/test_runtime.py:50, and a plan of the wrong width."""
    ts = TrajectoryServer(2, 1, cap_steps=8)
    with pytest.raises(RuntimeError, match="no plan"):
        ts.get_state(0.0)
    with pytest.raises(ValueError, match="exceeds capacity"):
        ts.publish(np.zeros((9, 2)), np.zeros((8, 1)), 0.1)
    with pytest.raises(ValueError, match="shapes"):
        ts.publish(np.zeros((4, 2)), np.zeros((3, 2)), 0.1)


def test_server_no_torn_reads_under_concurrent_publish(TrajectoryServer):
    """tests/test_runtime.py:59: each published plan is constant-valued,
    so a mixed row would expose a torn read."""
    n, m, P = 4, 2, 64
    ts = TrajectoryServer(n, m, cap_steps=P)
    ts.publish(np.zeros((P, n)), np.zeros((P - 1, m)), 0.05)
    stop = threading.Event()
    errors = []

    def reader():
        while not stop.is_set():
            s = ts.get_state(1.3)
            e = ts.get_effort(0.7)
            if not (np.all(s == s[0]) and np.all(e == e[0])):
                errors.append((s.copy(), e.copy()))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for th in threads:
        th.start()
    for k in range(1, 2000):
        ts.publish(np.full((P, n), float(k)), np.full((P - 1, m), float(k)),
                   0.05)
    stop.set()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads) and not errors


def test_server_attach_publishes_on_replan(TrajectoryServer):
    """tests/test_runtime.py:94: the server composes over a metrics hook
    and answers as the planner does."""
    prob, planner = _planner(seed=2)
    buf = BufferSink()
    attach(planner, buf)
    ts = TrajectoryServer(4, 2).attach(planner)
    _plan(planner, prob)
    for t in (0.0, 0.5, 1.7, 99.0):
        np.testing.assert_allclose(ts.get_state(t), planner.get_state(t),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ts.get_effort(t), planner.get_effort(t),
                                   rtol=1e-6, atol=1e-6)
    assert abs(ts.T - planner.T) < 1e-6 and len(buf.records) == 1
