"""The port's measurement tools at a tiny width on the CPU: each entry point
(``python -m lqrrt_tpu_torch.tools.<tool>``) exits 0, prints its JSON
record last with the keys it promises, names the CPU as its device with no
device figure, and writes nothing but the ``--out`` file it was given (its
working directory stays empty, no JSON record at the repository's root is
written)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

TOOLS = {
    "profile_round": ["--batch", "64", "--capacity", "512", "--rounds", "2",
                      "--chunks", "1", "--rounds-per-chunk", "2"],
    "profile_chunk": ["--batch", "64", "--capacity", "512"],
    "exp_quality": ["--batch", "64", "--capacity", "1024", "--budgets",
                    "0.2,1.0", "--seeds", "1,2"],
}


def check_profile_round(rec):
    from lqrrt_tpu_torch.tools.profile_round import KNOCKOUTS, MODELS, PHASES

    assert rec["clock"] == "host"
    assert set(rec["models"]) == set(MODELS)
    for name, r in rec["models"].items():
        assert set(r["phases_ms"]) == set(PHASES)
        assert all(v > 0 for v in r["phases_ms"].values())
        assert r["round_ms"] > 0 and r["round_expansions_per_s"] > 0
        assert set(r["knockout_ms"]) == {"round_ms"} | {
            f"{k}_ms" for k in KNOCKOUTS}
        assert all(v >= 0 for v in r["knockout_ms"].values())
        assert r["busy"] == dict(device_ms=None, kernels=None,
                                 busy_share=None)
        assert set(r["nn_composed_ms"]) == {"256", "512"}
        assert r["nn"] == "scan"           # "auto" on the CPU
        assert r["batch"] == 64 and r["capacity"] == 512


def check_profile_chunk(rec):
    assert rec["clock"] == "host"
    assert set(rec["impls"]) == {"nn_const", "nn_general", "scan"}
    for impl, r in rec["impls"].items():
        assert r["nn_selected"] == impl
        assert r["size_after_chunk0"] == 512    # 8 rounds of 64 fill it
        for c in (1, 2):
            assert r[f"chunk{c}_ms"] > 0 and r[f"size_after_chunk{c}"] == 512


def check_exp_quality(rec):
    assert rec["seeds"] == [1, 2] and rec["budgets"] == [0.2, 1.0]
    assert set(rec["instances"]) == {"default", "hard"}
    for r in rec["instances"].values():
        assert r["batch"] == 64
        assert set(r["curve"]) == {"0.2", "1.0"}
        for v in r["curve"].values():
            assert len(v["seeds"]) == 2
            assert all(d is None or d > 0 for d in v["seeds"])
        assert "gain_0p2_to_1p0_pct" in r and r["gain_1p0_to_4p0_pct"] is None


def root_records():
    """The JSON records at the repository's root (the reference's tools
    write PROFILE_r05.json and QUALITY_r05.json there), with their
    modification times."""
    return {p.name: p.stat().st_mtime_ns for p in REPO.glob("*.json")}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_main_on_the_cpu(tool, tmp_path):
    run = tmp_path / "cwd"
    run.mkdir()
    out = tmp_path / "out.json"
    root_before = root_records()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", f"lqrrt_tpu_torch.tools.{tool}",
         "--device", "cpu", "--out", str(out), *TOOLS[tool]],
        cwd=run, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rec["tool"] == tool and rec["device"] == "cpu"
    assert json.loads(out.read_text()) == rec
    assert os.listdir(run) == []
    assert root_records() == root_before
    {"profile_round": check_profile_round,
     "profile_chunk": check_profile_chunk,
     "exp_quality": check_exp_quality}[tool](rec)


@pytest.mark.parametrize("name", ["boat", "car", "quadrotor", "grid_boat"])
def test_profiled_round_is_the_planners_round(name):
    """``profile_round``'s round, built from its stages, is the planner's
    grow round: on the same draw of the planner's sampler (the generator
    reset between the two), ``Planner._expand`` and ``commit_candidates``
    leave the same tree, bit for bit, after two rounds grew it."""
    import torch

    from lqrrt_tpu_torch.core.rounds import commit_candidates
    from lqrrt_tpu_torch.tools.profile_round import build

    torch.set_num_threads(2)
    round_fn, tree, parts = build(name, 64, 512, "cpu")
    p, spec = parts["planner"], parts["spec"]
    for _ in range(2):
        round_fn(tree)
    ref = type(tree)(*[t.clone() for t in tree])
    state = p._rank_gen.get_state()
    round_fn(tree)
    p._rank_gen.set_state(state)
    xrand = parts["sample"]()
    commit_candidates(spec, ref, p._expand(spec)(ref, xrand, p.goal))
    assert int(tree.size) == int(ref.size) == 3 * 64 + p.root_pad
    for field, a, b in zip(tree._fields, tree, ref):
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            torch.nan_to_num(a, 1.0, 2.0, 3.0),
            torch.nan_to_num(b, 1.0, 2.0, 3.0))), field
