"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its file under portbench/."""
import json
import re

import pytest

from conftest import BENCH, REPO
from portbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def manifest():
    return cells.load_manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    rs = manifest["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(manifest, kind):
    names = [e["name"] for e in manifest[kind]]
    assert len(names) == len(set(names))
    for e in manifest[kind]:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if kind in ("end_to_end", "per_layer"):
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        if kind == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if kind == "per_layer":
            assert _line(e["layer"])
        if "why" in e:
            assert _line(e["why"])


def test_cells_resolve(manifest):
    used = set()
    pairs = set()
    for w in manifest["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cfg = cells.config(w["config"])
        mix = cells.traffic(w["traffic"])
        assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
        assert (BENCH / "reference" / f"{cfg['model']}.py").exists()
        used.add(w["config"])
    assert {c["name"] for c in manifest["configs"]} == used
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(
        1, len(manifest["workloads"]) // 4)


def test_configs(manifest):
    for c in manifest["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        data = json.loads((REPO / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in data for k in c["reduced"])
        assert c["source"].startswith("https://") and _line(c["source"])
        assert data["source"] == c["source"]
        for name, spec in data["limits"].items():
            assert spec["op"] == "<=" and spec["limit"] is not None, name


def test_every_metric_has_a_reader(manifest):
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            assert callable(cells.reader(m["name"]))


def test_what_each_cell_reports(manifest):
    e2e = {m["name"] for m in manifest["end_to_end"]}
    assert "setup_s" in e2e
    for w in manifest["workloads"]:
        mine = {m["name"] for m in cells.metrics_for(
            manifest, w["name"], "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layer = cells.metrics_for(manifest, w["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in mine, (w["name"], m["name"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
