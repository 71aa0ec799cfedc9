"""The manifest (``BENCHMARK.json``) and the files it names: a cell's
configuration, its traffic mix and the reader of each metric it reports,
each found by its name under the benchmark's folder."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_manifest(path: Path | None = None) -> dict:
    with open(path or HERE.parent / "BENCHMARK.json") as fh:
        return json.load(fh)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, root: Path) -> dict:
    path = root / kind / f"{name}.json"
    with open(path) as fh:
        data = json.load(fh)
    if data.get("name") != name:
        raise ValueError(f"{path} names itself {data.get('name')!r}")
    return data


def config(name: str, root: Path = HERE) -> dict:
    return _json("configs", name, root)


def traffic(name: str, root: Path = HERE) -> dict:
    return _json("traffic", name, root)


def metrics_for(manifest: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those whose ``workloads`` list it, and those without the key."""
    return [m for m in manifest[kind]
            if cell in m.get("workloads", [cell])]


def reader(metric: str, root: Path = HERE):
    """``read(run) -> float | None`` of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
