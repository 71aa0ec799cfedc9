"""The car's benchmark configuration (``portbench/configs/car_bicycle.json``)
against the port, on the CPU: the program's RK4 step against the plain
reference's (``portbench/reference/car.py``), the per-node LQR against the
reference's float64 solve (and the bfloat16 control failing the limit),
the harness's run of a small car cell ending ``correct``, and the car's
problem under the boat's ``obstacle_model`` keyword, equal to the JAX
package's."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg
import torch

import jax  # noqa: F401  (the JAX package's model, on the CPU)

from lqrrt_tpu.models import car as jcar
from lqrrt_tpu_torch.models import car
from portbench import cells, lqr_check
from portbench.reference.plans import load_model

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64


@pytest.fixture(scope="module")
def cfg():
    return cells.config("car_bicycle")


@pytest.fixture(scope="module")
def ref(cfg):
    return load_model(cfg)


def _states(seed, count):
    """Seeded states over the sample space, v also below the LQR's floor
    and negative."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-2.0, 30.0, count),
                     rng.uniform(-6.0, 6.0, count),
                     rng.uniform(-np.pi, np.pi, count),
                     rng.uniform(-1.5, 6.0, count)], -1)


def test_rk4_step_matches_the_reference(cfg, ref):
    """The program's step (``models/car.py`` ``dynamics``) in float64, with
    controls inside and past the limits, against ``Car.step``."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(_states(3, 256))
    u = torch.as_tensor(np.stack([rng.uniform(-5.0, 5.0, 256),
                                  rng.uniform(-1.0, 1.0, 256)], -1))
    got = car.dynamics(x, car.saturate(u), cfg["dt"])
    np.testing.assert_allclose(got.numpy(), ref.step(x, u).numpy(),
                               rtol=1e-13, atol=1e-13)
    # the clamps inside f: the unsaturated step is the same
    np.testing.assert_allclose(ref.step(x, u, saturate=False).numpy(),
                               got.numpy(), rtol=1e-13, atol=1e-13)


def test_reference_lqr_matches_scipy(cfg, ref):
    x = torch.as_tensor(_states(5, 16))
    S, K = ref.lqr(x)
    A, B = ref.jacobians(ref.x_map(x))
    Q, R = np.diag(cfg["lqr"]["q"]), np.diag(cfg["lqr"]["r"])
    for i in range(len(x)):
        P = scipy.linalg.solve_continuous_are(A[i].numpy(), B[i].numpy(),
                                              Q, R)
        np.testing.assert_allclose(S[i].numpy(), P, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(K[i].numpy(),
                                   np.linalg.solve(R, B[i].numpy().T @ P),
                                   rtol=1e-10, atol=1e-10)


def test_reference_jacobians_match_the_programs(ref):
    """The reference's closed-form Jacobians against the program's
    ``linearize`` (``torch.func.jacfwd``) at the same points."""
    from lqrrt_tpu_torch.ops.riccati import linearize

    x = ref.x_map(torch.as_tensor(_states(9, 32)))
    A, B = ref.jacobians(x)
    Ap, Bp = linearize(car.f, x, torch.zeros(32, 2, dtype=F64))
    np.testing.assert_allclose(A.numpy(), Ap.numpy(), atol=1e-14)
    np.testing.assert_allclose(B.numpy(), Bp.numpy(), atol=1e-14)


def test_per_node_lqr_within_the_limit_and_bfloat16_fails(cfg, ref):
    """The program's ``make_relinearized_lqr`` (float32) at 64 seeded
    states against ``Car.lqr`` in float64: each row's relative error of S
    and of K within the configuration's ``lqr_check`` limit (1e-4: float32
    reads ~1e-6 here); the reference computed in bfloat16 fails it."""
    limit = cfg["lqr_check"]["rel_max"]
    x = torch.as_tensor(_states(11, 64), dtype=torch.float32)
    S, K = car.make_lqr()(x, torch.zeros(64, 2))
    prog = lqr_check.compare(ref, x, S, K)
    assert prog["S_max"] <= limit and prog["K_max"] <= limit, prog
    assert prog["S_max"] < limit / 10, prog      # room below the limit
    ctrl = lqr_check.compare(ref, x, dtype=torch.bfloat16)
    assert ctrl["S_max"] > limit and ctrl["K_max"] > limit, ctrl
    assert ctrl["S_med"] > limit and ctrl["K_med"] > limit, ctrl


def test_obstacle_model_keyword():
    with pytest.raises(ValueError, match="no raster"):
        car.default_problem(obstacle_model="grid")
    a = car.default_problem()
    b = car.default_problem(obstacle_model="circles")
    j = jcar.default_problem()
    for key in ("x0", "goal", "sample_space"):
        np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a[key], np.asarray(j[key]))
    for p in (b, j):
        for got, want in zip(p["obstacles"], a["obstacles"]):
            np.testing.assert_array_equal(np.asarray(got), want)
        assert (p["horizon"], p["dt"], tuple(p["wrap_dims"])) == (
            a["horizon"], a["dt"], tuple(a["wrap_dims"]))
    np.testing.assert_array_equal(b["constraints"].goal_buffer,
                                  a["constraints"].goal_buffer)
    np.testing.assert_array_equal(
        np.asarray(j["constraints"].goal_buffer),
        a["constraints"].goal_buffer)
    # no obstacles: a state inside the first circle is feasible
    free = car.default_problem(obstacles=False)["constraints"].is_feasible
    inside = torch.tensor([[8.0, 1.5, 0.0, 1.0]])
    assert bool(free(inside, torch.zeros(1, 2)).all())
    assert not bool(a["constraints"].is_feasible(inside,
                                                 torch.zeros(1, 2)).any())


def test_configuration_is_the_programs_problem(cfg):
    """The harness's check of the configuration against the program's
    problem (``portbench/loops.py`` ``_problem``) passes for the car."""
    from portbench.loops import _problem

    prob = _problem(cfg, cells.traffic("replan_1s"))
    assert prob["lqr"] is not None and cfg["model"] == "car"


_RUN = """
import sys
from portbench import run
sys.exit(run.main(["--workload", "car.replan", "--seed", "2147483999",
                   "--seconds", "2", "--trace", "0"], device="cpu",
                  manifest_path=sys.argv[1], root=sys.argv[2]))
"""


def test_harness_runs_a_small_car_cell_correct(tmp_path):
    """``portbench.run.main(device="cpu")`` on the car cell at batch 64,
    capacity 1024, a 2 s window: the result line is ``correct``, with the
    car's end-to-end metrics and checks (no ``gain_med``).  It runs in a
    fresh interpreter, since the harness refuses a process with JAX
    loaded."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "portbench" / sub, tmp_path / sub)
    p = tmp_path / "configs/car_bicycle.json"
    c = json.loads(p.read_text())
    c["planner"].update(batch_size=64, capacity=1024)
    p.write_text(json.dumps(c))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _RUN, str(tmp_path / "BENCHMARK.json"),
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "expansions_per_s",
                                   "replan_s", "plan_duration_s"}
    assert set(res["checks"]) == {"bad_plans", "goal_excess", "gap_max",
                                  "gap_med"}
