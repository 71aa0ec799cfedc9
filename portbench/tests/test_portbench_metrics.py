"""Each metric reader's arithmetic on a synthetic run and trace."""
import numpy as np
import pytest

from portbench import cells, devtrace, peaks
from portbench.loops import RunData


def _planner_run():
    cfg, mix = cells.config("boat_wamv"), cells.traffic("replan_1s")
    stats = [dict(expansions=65536, rounds=8, overhead_total_s=0.2),
             dict(expansions=131072, rounds=16, overhead_total_s=0.4)]
    plans = [[dict(x=np.zeros((341, 6), np.float32))],
             [dict(x=np.zeros((401, 6), np.float32))]]
    run = RunData(cfg, mix, "planner", setup_s=12.5, window_s=4.0,
                  replans=[dict(wall_s=2.0, ok=True, stats=s, plans=p)
                           for s, p in zip(stats, plans)])
    tr = devtrace.Trace(window_s=2.0, busy_s=0.2, rounds=8, n_kernels=800,
                        kernels={"void nn_const_kernel<6, true>(...)":
                                 [8, 0.0024],
                                 "block_write_kernel(...)": [16, 0.0004],
                                 "elementwise": [776, 0.1]})
    run.trace = tr
    return run


def _read(name, run):
    return cells.reader(name)(run)


def test_end_to_end_planner():
    run = _planner_run()
    assert _read("setup_s", run) == 12.5
    assert _read("expansions_per_s", run) == pytest.approx(196608 / 4.0)
    assert _read("replan_s", run) == pytest.approx(2.0)
    assert _read("plan_duration_s", run) == pytest.approx((17.0 + 20.0) / 2)
    assert _read("goal_rate", run) is None


def test_per_layer_planner():
    run = _planner_run()
    assert _read("planner.post_s", run) == pytest.approx(0.3)
    assert _read("device.idle_share", run) == pytest.approx(0.9)
    assert _read("device.kernels_per_round", run) == pytest.approx(100.0)
    assert _read("kernel.nn_const_ms_per_round", run) == pytest.approx(0.3)
    # 16 launches, 8 pairs of 2 H (n + m) B 4 bytes, over 0.4 ms
    pair = 2 * 100 * 9 * 8192 * 4
    assert _read("kernel.block_write_roofline", run) == pytest.approx(
        100 * 8 * pair / (3.35e12 * 0.0004))
    # each of the 8 traced rounds: 8192 rows steered through H = 100
    # steps of 295 flops, and matched with every row of the tree
    sizes = [512, 8704, 16896, 25088]
    per_round = 8192 * 100 * 295 + 8192 * 21 * sum(sizes) / 4
    assert _read("step_mfu", run) == pytest.approx(
        100 * per_round * 8 / 2.0 / 67e12)
    assert _read("fleet.extract_s", run) is None
    for name in ("fleet.expansions_per_s", "device.idle_share.fleet",
                 "device.kernels_per_round.fleet"):
        assert _read(name, run) is None


def test_readers_without_a_trace_or_kernel():
    run = _planner_run()
    run.trace.kernels = {"elementwise": [776, 0.1]}
    assert _read("kernel.nn_const_ms_per_round", run) is None
    assert _read("kernel.block_write_roofline", run) is None
    run.trace = None
    for name in ("device.idle_share", "device.kernels_per_round",
                 "step_mfu"):
        assert _read(name, run) is None


def test_fleet_readers():
    cfg, mix = cells.config("boat_fleet"), cells.traffic("fleet_2s")
    goal = np.asarray(cfg["goal"], np.float32)
    inside = np.tile(goal, (3, 1))
    inside[-1, 2] = np.float32(np.pi)            # psi wraps: still far
    out = np.tile(goal, (3, 1))
    out[-1, 0] += 2.0
    plans = [dict(x=inside, goal=goal), dict(x=out, goal=goal),
             dict(x=None, goal=goal), dict(x=inside[:2], goal=goal)]
    rec = dict(wall_s=2.5, extract_s=0.25, plans=plans,
               stats=dict(expansions=1024 * 64 * 12, rounds=12))
    run = RunData(cfg, mix, "fleet", window_s=5.0, replans=[rec, rec])
    assert _read("goal_rate", run) == pytest.approx(0.25)
    assert _read("fleet.extract_s", run) == pytest.approx(0.25)
    assert _read("replan_s", run) == pytest.approx(2.5)
    assert _read("expansions_per_s", run) == pytest.approx(
        2 * 1024 * 64 * 12 / 5.0)
    assert _read("fleet.expansions_per_s", run) == pytest.approx(
        2 * 1024 * 64 * 12 / 5.0)
    assert _read("device.idle_share.fleet", run) is None
    run.trace = devtrace.Trace(window_s=2.0, busy_s=0.2, rounds=8,
                               n_kernels=800)
    assert _read("device.idle_share.fleet", run) == pytest.approx(0.9)
    assert _read("device.kernels_per_round.fleet", run) == pytest.approx(
        100.0)
    assert _read("step_mfu", run) is None
    assert _read("plan_duration_s", run) is None


def test_trace_reduction():
    host = [("aten::add", False, 0.0, 100.0), ("cudaLaunchKernel", False,
                                                 40.0, 5.0)]
    dev = [("k1", True, 10.0, 20.0), ("k2", True, 20.0, 20.0),
           ("Memcpy HtoD", True, 60.0, 10.0), ("k1", True, 90.0, 5.0)]
    tr = devtrace.reduce(host + dev, 1e-4)
    assert tr.busy_s == pytest.approx(45e-6)
    assert tr.n_kernels == 3
    assert tr.kernels["k1"] == [2, pytest.approx(25e-6)]
    assert tr.device_ops[0][0] == "k1"
    gaps = dict((round(s * 1e6), n) for n, s in tr.idle_gaps)
    assert set(gaps) == {10, 20, 5}
    assert gaps[20] == "aten::add" and gaps[10] == "aten::add"


def test_restart_tree_sizes():
    assert peaks.restart_tree_sizes(8192, 32768) == [512, 8704, 16896,
                                                     25088]
    assert peaks.restart_tree_sizes(128, 1024) == [1 + 128 * r
                                                   for r in range(8)]
