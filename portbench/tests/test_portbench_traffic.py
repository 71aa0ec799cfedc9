"""The traffic generator: a seed repeats its stream, every seed gets the
same set in another order, and seeds past 32 bits work."""
import numpy as np
import pytest

from portbench import cells, traffic

BIG = 2 ** 31 + 12345


@pytest.fixture(scope="module")
def boat():
    return cells.config("boat_wamv"), cells.traffic("replan_1s")


def _stream(cfg, mix, seed, k):
    g = traffic.GoalStream(cfg, mix, seed)
    return np.array([g.next_goal() for _ in range(k)])


@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_goal_stream_repeats(boat, seed):
    cfg, mix = boat
    a, b = _stream(cfg, mix, seed, 40), _stream(cfg, mix, seed, 40)
    assert np.array_equal(a, b)


def test_every_seed_the_same_goals(boat):
    cfg, mix = boat
    n = len(traffic.GoalStream(cfg, mix, 0).offsets)
    assert n == 16
    sets = [np.sort(_stream(cfg, mix, s, n), axis=0) for s in (1, 2, BIG)]
    assert all(np.array_equal(sets[0], s) for s in sets[1:])
    assert not np.array_equal(_stream(cfg, mix, 1, n), _stream(cfg, mix, 2, n))
    goals = _stream(cfg, mix, 3, n)
    off = goals[:, :2] - np.asarray(cfg["goal"][:2], np.float32)
    assert (np.abs(off[:, 0]) <= 4).all() and (np.abs(off[:, 1]) <= 6).all()
    assert (goals[:, 2:] == 0).all()


def test_fleet_cycle_is_the_whole_set():
    cfg, mix = cells.config("boat_fleet"), cells.traffic("fleet_2s")
    g = traffic.GoalStream(cfg, mix, BIG)
    a, b = g.cycle_goals(1024), g.cycle_goals(1024)
    assert a.shape == (1024, 6)
    assert np.array_equal(np.sort(a, 0), np.sort(b, 0))
    assert not np.array_equal(a, b)
    c = traffic.GoalStream(cfg, mix, BIG).cycle_goals(1024)
    assert np.array_equal(a, c)


def test_scenario_shifts():
    mix = cells.traffic("fleet_grid_2s")
    a = traffic.scenario_shifts(mix, BIG, 1024)
    assert a.shape == (1024, 2) and (np.abs(a) <= 3).all()
    assert np.array_equal(a, traffic.scenario_shifts(mix, BIG, 1024))
    assert len(np.unique(a, axis=0)) == 1024


def test_sample_indices():
    idx = traffic.sample_indices(5, 100, 10, must=[99])
    assert len(idx) == 10 and 99 in idx
    assert idx == traffic.sample_indices(5, 100, 10, must=[99])
    assert traffic.sample_indices(5, 4, 10) == [0, 1, 2, 3]
