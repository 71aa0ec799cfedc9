"""The port's measurement tools at a tiny width on the CPU: each entry point
(``python -m lqrrt_tpu_torch.tools.<tool>``) exits 0, prints its JSON
record last with the keys it promises, names the CPU as its device with no
device figure, and writes nothing but the ``--out`` file it was given (its
working directory stays empty, no JSON record at the repository's root is
written).  Then the device name the records carry (``utils/device.py``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

TOOLS = {
    "exp_quality": ["--batch", "64", "--capacity", "1024", "--budgets",
                    "0.2,1.0", "--seeds", "1,2"],
}


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
    check_exp_quality(rec)


def test_device_name_of_the_cpu_runs_no_smi(monkeypatch):
    """The CPU is named "cpu" without a call to ``nvidia-smi``."""
    import torch

    from lqrrt_tpu_torch.utils import device

    def boom(*a, **k):
        raise AssertionError(f"subprocess.run{a}")
    monkeypatch.setattr(subprocess, "run", boom)
    cpu = torch.device("cpu")
    assert device.device_name(cpu) == device.card_name(cpu) == "cpu"
