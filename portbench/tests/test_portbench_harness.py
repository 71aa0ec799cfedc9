"""The harness end to end on the CPU at tiny sizes: a new cell made of new
files only; the run's result line; the faults a run can have, planted in
the program underneath, turning ``correct`` false; no JAX loaded."""
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import REPO, make_tiny
from portbench import run as harness


def _run(capsys, manifest, root, workload, seed=11, seconds=2.0, trace=0):
    rc = harness.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", manifest_path=manifest, root=root)
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def test_result_line(capsys, tiny):
    root, manifest = tiny
    res = _run(capsys, manifest, root, "boat.replan")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s", "expansions_per_s",
                                   "replan_s", "plan_duration_s"}
    for v in res["metrics"].values():
        assert v["value"] > 0
    assert set(res["checks"]) == {"bad_plans", "goal_excess", "gap_max",
                                  "gap_med", "gain_med"}


def test_a_new_cell_is_new_files(capsys, tmp_path):
    """A configuration, a mix and a metric added as files, and a cell in
    the manifest: the harness runs it with no other edit."""
    manifest = make_tiny(tmp_path)
    cfg = json.loads((tmp_path / "configs/boat_wamv.json").read_text())
    cfg["name"] = "boat_probe"
    (tmp_path / "configs/boat_probe.json").write_text(json.dumps(cfg))
    mix = json.loads((tmp_path / "traffic/replan_1s.json").read_text())
    mix.update(name="replan_probe", min_time=0.2, max_time=0.4)
    (tmp_path / "traffic/replan_probe.json").write_text(json.dumps(mix))
    (tmp_path / "metrics/probe.replans.py").write_text(
        "def read(run):\n    return len(run.replans)\n")
    man = json.loads(manifest.read_text())
    man["configs"].append(dict(man["configs"][0], name="boat_probe",
                               file="portbench/configs/boat_probe.json"))
    man["workloads"].append(dict(name="boat.probe", config="boat_probe",
                                 traffic="replan_probe", chips=1,
                                 why="a throwaway cell"))
    man["end_to_end"].append(dict(name="probe.replans", unit="replans",
                                  better="higher", bound=0.1,
                                  source="host_clock",
                                  workloads=["boat.probe"]))
    manifest.write_text(json.dumps(man))
    res = _run(capsys, manifest, tmp_path, "boat.probe")
    assert res["metrics"]["probe.replans"]["value"] >= 1
    assert res["correct"] is True


def _near(root):
    """The fleet's goals 10 m out, so the tiny CPU fleet reaches them."""
    for name in ("boat_fleet",):
        p = root / f"configs/{name}.json"
        cfg = json.loads(p.read_text())
        cfg["goal"] = [10.0, 0.0, 0.0, 0.0, 0.0, 0.0]
        p.write_text(json.dumps(cfg))
    p = root / "traffic/fleet_2s.json"
    mix = json.loads(p.read_text())
    mix["goals"].update(lo=[-1.0, -1.0], hi=[1.0, 1.0])
    p.write_text(json.dumps(mix))


@pytest.fixture(scope="module")
def near(tmp_path_factory):
    root = tmp_path_factory.mktemp("near")
    manifest = make_tiny(root)
    _near(root)
    return root, manifest


def _program_problem_check(monkeypatch):
    """The near fleet's goal is not the program's: skip that check."""
    from portbench import loops
    real = loops._problem

    def loose(cfg, mix):
        cfg = dict(cfg, goal=[40.0, 0.0, 0.0, 0.0, 0.0, 0.0])
        return real(cfg, mix)
    monkeypatch.setattr(loops, "_problem", loose)


def _altered_planner(monkeypatch):
    from lqrrt_tpu_torch.planner import Planner
    real = Planner._extract

    def extract(self, tree, best):
        x, u = real(self, tree, best)
        x = x.copy()
        x[len(x) // 2, 1] += 0.5
        return x, u
    monkeypatch.setattr(Planner, "_extract", extract)


def _unchanged_planner(monkeypatch):
    """Every replan after the warm-up returns the warm-up's plan, claiming
    the goal, in about the time a tiny replan takes."""
    import time

    from lqrrt_tpu_torch.planner import Planner
    real = Planner.update_plan

    def update_plan(self, *a, **kw):
        if getattr(self, "_frozen", False):
            time.sleep(0.2)
            return True
        self._frozen = True
        return real(self, *a, **kw)
    monkeypatch.setattr(Planner, "update_plan", update_plan)


def _altered_fleet(monkeypatch):
    from lqrrt_tpu_torch.parallel.fleet import FleetPlanner
    real = FleetPlanner.extract_plans

    def extract_plans(self, scenarios=None):
        out = real(self, scenarios)
        for s, x in out.items():
            if len(x) > 2:
                out[s] = x.copy()
                out[s][len(x) // 2, 0] += 0.5
        return out
    monkeypatch.setattr(FleetPlanner, "extract_plans", extract_plans)


def _half_fleet(monkeypatch):
    from lqrrt_tpu_torch.parallel.fleet import FleetPlanner
    real = FleetPlanner.extract_plans

    def extract_plans(self, scenarios=None):
        out = real(self, scenarios)
        return {s: x for s, x in out.items() if s % 2 == 0}
    monkeypatch.setattr(FleetPlanner, "extract_plans", extract_plans)


def _unchanged_fleet(monkeypatch):
    from lqrrt_tpu_torch.parallel.fleet import FleetPlanner
    real = FleetPlanner.plan

    def plan(self, *a, **kw):
        if getattr(self, "_frozen", None) is not None:
            return self._frozen
        st = real(self, *a, **kw)
        if kw.get("rounds", 0) > 1:          # past the warm-up
            self._frozen = st
        return st
    monkeypatch.setattr(FleetPlanner, "plan", plan)


def test_fleet_result_line(capsys, monkeypatch, near):
    """The fleet's end-to-end line leaves out ``expansions_per_s``, which
    it reports per layer as ``fleet.expansions_per_s``."""
    root, manifest = near
    _program_problem_check(monkeypatch)
    res = _run(capsys, manifest, root, "fleet.plan", seconds=3.0)
    assert res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "replan_s", "goal_rate"}
    for v in res["metrics"].values():
        assert v["value"] > 0
    from portbench import cells
    man = cells.load_manifest(manifest)
    layer = {m["name"] for m in cells.metrics_for(man, "fleet.plan",
                                                  "per_layer")}
    assert layer == {"fleet.extract_s", "fleet.expansions_per_s",
                     "device.idle_share.fleet",
                     "device.kernels_per_round.fleet"}


@pytest.mark.parametrize("cell,fault", [
    ("boat.replan", _altered_planner),
    ("boat.replan", _unchanged_planner),
    ("fleet.plan", _altered_fleet),
    ("fleet.plan", _half_fleet),
    ("fleet.plan", _unchanged_fleet),
    ("fleet.plan", None),
])
def test_faults_turn_correct_false(capsys, monkeypatch, near, cell, fault):
    root, manifest = near
    _program_problem_check(monkeypatch)
    if fault is not None:
        fault(monkeypatch)
    res = _run(capsys, manifest, root, cell, seconds=5.0)
    assert res["correct"] is (fault is None), res["checks"]


def test_control_fails_at_the_cells_size(tiny):
    """The control (the plans as bfloat16 would give them) fails a limit
    that the program's own plans keep, on the same run."""
    from portbench import cells, control
    root, manifest = tiny
    for cell in ("boat.replan", "fleet.plan"):
        out = control.readings(cell, [3], 2.0, device="cpu",
                               manifest_path=manifest, root=root)[0]
        w = cells.workload(cells.load_manifest(manifest), cell)
        limits = cells.config(w["config"], root)["limits"]
        ok, _ = harness._compare(out["program"], limits)
        bad, _ = harness._compare(out["control"], limits)
        assert ok and not bad, out


def test_no_jax_in_the_harness():
    code = ("import sys; import portbench.run, portbench.loops, "
            "portbench.control, portbench.devtrace; "
            "from lqrrt_tpu_torch import Planner; "
            "from lqrrt_tpu_torch.parallel import FleetPlanner; "
            "import lqrrt_tpu_torch.ops.kernels.nn_kernel, "
            "lqrrt_tpu_torch.ops.kernels.write_kernel; "
            "print(portbench.run._loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_result_without_the_card_or_the_program(tmp_path):
    """Without CUDA the command exits 3 and prints nothing; in a folder
    holding only the benchmark it fails before any result."""
    env = {"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
           "HOME": str(tmp_path)}
    args = [sys.executable, "-m", "portbench.run", "--workload",
            "boat.replan", "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(args, cwd=REPO, capture_output=True, text=True,
                         env=env)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run(args, cwd=tmp_path, capture_output=True, text=True,
                         env=env)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_on_the_card():
    """One short run of each cell on the card, correct (run by hand on a
    machine with a GPU: python -m pytest portbench/tests -m card)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in man["workloads"]:
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", w["name"],
             "--seed", "2147483649", "--seconds", "5", "--trace", "0"],
            cwd=REPO, capture_output=True, text=True, timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
