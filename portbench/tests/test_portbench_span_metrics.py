"""The readers of the program's spans (``stats["spans"]`` of each replan
or fleet cycle) on synthetic runs, and their silence on runs of a program
that keeps no spans."""
import numpy as np
import pytest

from portbench import cells
from portbench.loops import RunData

PLANNER = ("planner.dispatch_s", "planner.stats_wait_s",
           "host.steer_ms_per_round")
FLEET = ("host.steer_ms_per_round.fleet", "fleet.sync_wait_s")


def _span(total):
    return dict(count=1, total_s=total, self_s=total, parent=None)


def _planner_run(with_spans=True):
    cfg, mix = cells.config("boat_wamv"), cells.traffic("replan_1s")
    stats = [dict(expansions=65536, rounds=8, overhead_total_s=0.2),
             dict(expansions=131072, rounds=16, overhead_total_s=0.4)]
    if with_spans:
        for st, (chunk, wait, steer) in zip(stats, [(1.8, 0.01, 2.0),
                                                    (2.2, 0.03, 4.4)]):
            st["spans"] = {"planner.chunk": _span(chunk),
                           "planner.stats_wait": _span(wait),
                           "round.steer": _span(steer)}
    plans = [dict(x=np.zeros((341, 6), np.float32))]
    return RunData(cfg, mix, "planner", setup_s=12.5, window_s=4.0,
                   replans=[dict(wall_s=2.0, ok=True, stats=s, plans=plans)
                            for s in stats])


def _fleet_run(with_spans=True):
    cfg, mix = cells.config("boat_fleet"), cells.traffic("fleet_2s")
    recs = []
    for rounds, sync, steer in ((10, 0.05, 1.5), (12, 0.07, 1.8)):
        st = dict(expansions=1024 * 64 * rounds, rounds=rounds)
        if with_spans:
            st["spans"] = {"fleet.chunk_sync": _span(sync),
                           "round.steer": _span(steer)}
        recs.append(dict(wall_s=2.1, extract_s=0.05, plans=[], stats=st))
    return RunData(cfg, mix, "fleet", window_s=4.2, replans=recs)


def _read(name, run):
    return cells.reader(name)(run)


def test_planner_span_readers():
    run = _planner_run()
    assert _read("planner.dispatch_s", run) == pytest.approx(2.0)
    assert _read("planner.stats_wait_s", run) == pytest.approx(0.02)
    assert _read("host.steer_ms_per_round", run) == pytest.approx(
        1e3 * 6.4 / 24)
    for name in FLEET:
        assert _read(name, run) is None


def test_fleet_span_readers():
    run = _fleet_run()
    assert _read("host.steer_ms_per_round.fleet", run) == pytest.approx(
        1e3 * 3.3 / 22)
    assert _read("fleet.sync_wait_s", run) == pytest.approx(0.06)
    for name in PLANNER:
        assert _read(name, run) is None


@pytest.mark.parametrize("name", PLANNER + FLEET)
def test_span_readers_are_silent_without_spans(name):
    """A program without spans (the parent commit's) reads as absent, not
    as zero; so does a window with one replan lacking them."""
    for run in (_planner_run(False), _fleet_run(False)):
        assert _read(name, run) is None
    run = _planner_run() if name in PLANNER else _fleet_run()
    del run.replans[0]["stats"]["spans"]
    assert _read(name, run) is None
    run.replans = []
    assert _read(name, run) is None


def test_span_metrics_in_the_manifest():
    man = cells.load_manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in PLANNER + FLEET:
        m = entries[name]
        assert m["source"] == "program_span" and m["better"] == "lower"
        assert m["workloads"] == (["boat.replan", "boat.grid"]
                                  if name in PLANNER else ["fleet.plan"])
