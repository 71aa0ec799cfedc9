"""Fixtures of the benchmark's CPU tests: a tiny copy of the cells (small
batches and fleets, the same files otherwise) that the harness runs on the
CPU in seconds.  Tests that need the card carry the ``card`` marker and
skip, inside the test, where CUDA is absent."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "portbench"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA GPU; skips where CUDA is absent")


def _edit(path: Path, fn) -> None:
    data = json.loads(path.read_text())
    fn(data)
    path.write_text(json.dumps(data))


def make_tiny(root: Path) -> Path:
    """A copy of the benchmark's data folders at CPU sizes, and of the
    manifest; returns the manifest's path."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, root / sub)
    _edit(root / "configs/boat_wamv.json",
          lambda c: c["planner"].update(batch_size=128, capacity=1024))
    _edit(root / "configs/boat_fleet.json",
          lambda c: c["fleet"].update(n_scenarios=16, batch_size=32,
                                      capacity=256, nn_block=64,
                                      max_rounds=8))
    for mix in ("fleet_2s", "fleet_grid_2s"):
        def small(t):
            t["goals"]["levels"] = [4, 4]
            if "per_scenario_grids" in t:
                t["per_scenario_grids"]["levels"] = [4, 4]
        _edit(root / f"traffic/{mix}.json", small)
    manifest = root / "BENCHMARK.json"
    shutil.copy(REPO / "BENCHMARK.json", manifest)
    return manifest


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiny")
    return root, make_tiny(root)
