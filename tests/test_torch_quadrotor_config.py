"""The quadrotor's benchmark configuration
(``portbench/configs/quadrotor_12.json``) against the port, on the CPU:
the program's RK4 step and Jacobians against the plain reference's
(``portbench/reference/quadrotor.py``), the reference's LQR against
scipy, the program's per-node LQR against the reference's float64 solve
(and the bfloat16 control failing the limit), the quadrotor's problem
under the boat's ``obstacle_model`` keyword, equal to the configuration
and to the JAX package's, the harness's run of a small quadrotor cell
ending ``correct`` with every control in the two-sided box, and that box
check catching a planted thrust below its lower face."""
import copy
import inspect
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

from lqrrt_tpu.models import quadrotor as jquad
from lqrrt_tpu_torch.models import quadrotor
from lqrrt_tpu_torch.ops.riccati import linearize
from portbench import cells, lqr_check
from portbench.reference.plans import load_model, plan_faults

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
F64 = torch.float64


@pytest.fixture(scope="module")
def cfg():
    return cells.config("quadrotor_12")


@pytest.fixture(scope="module")
def ref(cfg):
    return load_model(cfg)


@pytest.fixture(scope="module")
def ref32(cfg):
    """The reference on the program's own constants: the inertia rounded
    to float32, as ``models/quadrotor.py`` holds it (``INERTIA``)."""
    c = copy.deepcopy(cfg)
    c["dynamics"]["inertia"] = [float(v) for v in quadrotor.INERTIA]
    return load_model(c)


def _states(seed, count, wide=1.0):
    """Seeded states over the sample space widened about its centre by
    ``wide`` (the pitch past the 0.2 floor of its cosine at 1.5x and
    over)."""
    ss = np.asarray(quadrotor.default_problem()["sample_space"], np.float64)
    mid, half = ss.mean(1), (ss[:, 1] - ss[:, 0]) / 2 * wide
    return np.random.default_rng(seed).uniform(mid - half, mid + half,
                                               (count, len(ss)))


def _controls(seed, count):
    """Controls inside and past both faces of the box."""
    return np.random.default_rng(seed).uniform(
        [-14.0, -1.0, -1.0, -1.0], [20.0, 1.0, 1.0, 1.0], (count, 4))


def test_rk4_step_matches_the_reference(cfg, ref, ref32):
    """The program's step (``models/quadrotor.py`` ``dynamics``) in
    float64 against ``Quadrotor.step``.  On the program's float32 inertia
    the two agree to 1e-12 with controls inside the box, and, the clamps
    being inside f, unsaturated past it.  Saturated, the program's box
    faces are float32 (-9.8100004, 15.1899996) and the configuration's the
    decimals: 4.2e-7 on the thrust, ~2e-8 on a state after one step.  On
    the configuration's decimal inertia the step moves by its float32
    rounding (2.2e-8 relative in 1 / I): 6e-8 here."""
    x = torch.as_tensor(_states(3, 256, wide=1.5))
    u = torch.as_tensor(_controls(4, 256))
    inside = ref32.saturate(u)
    np.testing.assert_allclose(
        quadrotor.dynamics(x, inside, cfg["dt"]).numpy(),
        ref32.step(x, inside).numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        quadrotor.dynamics(x, u, cfg["dt"]).numpy(),
        ref32.step(x, u, saturate=False).numpy(), rtol=1e-12, atol=1e-12)
    got = quadrotor.dynamics(x, quadrotor.saturate(u), cfg["dt"]).numpy()
    np.testing.assert_allclose(got, ref32.step(x, u).numpy(), rtol=0,
                               atol=1e-7)
    np.testing.assert_allclose(got, ref.step(x, u).numpy(), rtol=0,
                               atol=5e-7)
    np.testing.assert_allclose(quadrotor.saturate(u).numpy(),
                               ref.saturate(u).numpy(), rtol=0, atol=5e-7)


def test_reference_lqr_matches_scipy(cfg, ref):
    x = torch.as_tensor(_states(5, 16))
    S, K = ref.lqr(x)
    A, B = ref.jacobians(x)
    Q, R = np.diag(cfg["lqr"]["q"]), np.diag(cfg["lqr"]["r"])
    for i in range(len(x)):
        P = scipy.linalg.solve_continuous_are(A[i].numpy(), B[i].numpy(),
                                              Q, R)
        tol = 1e-10 * np.abs(P).max()
        np.testing.assert_allclose(S[i].numpy(), P, rtol=1e-9, atol=tol)
        np.testing.assert_allclose(K[i].numpy(),
                                   np.linalg.solve(R, B[i].numpy().T @ P),
                                   rtol=1e-9, atol=1e-9)


def test_reference_jacobians_match_the_programs(ref, ref32):
    """The reference's forward-mode Jacobians of its own f against the
    program's ``linearize`` at the same points, hover thrust, in float64:
    equal on the program's float32 inertia, and within that rounding
    (2.2e-8 relative in 1 / I, 100 to 50) on the configuration's."""
    x = torch.as_tensor(_states(9, 32, wide=1.5))
    Ap, Bp = linearize(quadrotor.f, x, torch.zeros(32, 4, dtype=F64))
    A, B = ref32.jacobians(x)
    np.testing.assert_allclose(A.numpy(), Ap.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(B.numpy(), Bp.numpy(), rtol=1e-12,
                               atol=1e-12)
    A, B = ref.jacobians(x)
    np.testing.assert_allclose(A.numpy(), Ap.numpy(), rtol=1e-7, atol=1e-7)
    np.testing.assert_allclose(B.numpy(), Bp.numpy(), rtol=1e-7, atol=1e-7)


@pytest.mark.parametrize("wide", [1.0, 1.5])
def test_per_node_lqr_within_the_limit_and_bfloat16_fails(cfg, ref, wide):
    """The program's ``make_relinearized_lqr`` (float32) at 64 seeded
    states against ``Quadrotor.lqr`` in float64: each row's relative error
    of S and of K within the configuration's ``lqr_check`` limit, with a
    tenth of it to spare (the program reads ~1e-6 here); the reference
    computed in bfloat16 fails it, at its largest and at its median."""
    limit = cfg["lqr_check"]["rel_max"]
    x = torch.as_tensor(_states(11, 64, wide), dtype=torch.float32)
    S, K = quadrotor.make_lqr()(x, torch.zeros(64, 4))
    prog = lqr_check.compare(ref, x, S, K)
    assert prog["S_max"] <= limit / 10 and prog["K_max"] <= limit / 10, prog
    ctrl = lqr_check.compare(ref, x, dtype=torch.bfloat16)
    assert ctrl["S_max"] > limit and ctrl["K_max"] > limit, ctrl
    assert ctrl["S_med"] > limit and ctrl["K_med"] > limit, ctrl


def test_obstacle_model_keyword():
    with pytest.raises(ValueError, match="no raster"):
        quadrotor.default_problem(obstacle_model="grid")
    a = quadrotor.default_problem()
    b = quadrotor.default_problem(obstacle_model="circles")
    j = jquad.default_problem()
    for key in ("x0", "goal", "sample_space"):
        np.testing.assert_array_equal(a[key], b[key])
        np.testing.assert_array_equal(a[key], np.asarray(j[key]))
    for p in (b, j):
        for got, want in zip(p["obstacles"], a["obstacles"]):
            np.testing.assert_array_equal(np.asarray(got), want)
        assert (p["horizon"], p["dt"], tuple(p["wrap_dims"])) == (
            a["horizon"], a["dt"], tuple(a["wrap_dims"]))
        np.testing.assert_array_equal(
            np.asarray(p["constraints"].goal_buffer),
            a["constraints"].goal_buffer)
    # "circles" plans the columns: a hovering state inside the first
    # column is infeasible, and feasible without obstacles
    inside = torch.tensor([[3.0, 1.0, 2.0] + [0.0] * 9])
    hover = torch.zeros(1, 4)
    assert not bool(b["constraints"].is_feasible(inside, hover).any())
    free = quadrotor.default_problem(obstacles=False)["constraints"]
    assert bool(free.is_feasible(inside, hover).all())


def test_configuration_is_the_programs_problem(cfg, ref):
    """The harness's check of the configuration against the program's
    problem (``portbench/loops.py`` ``_problem``: x0, goal, sample space,
    goal buffer, columns, horizon, dt, wrap dims) passes, and the
    configuration's Q, R, constants and box are the program's and the JAX
    package's."""
    from portbench.loops import _problem

    prob = _problem(cfg, cells.traffic("air_replan_1s"))
    assert prob["lqr"] is not None and cfg["model"] == "quadrotor"
    assert cfg["buoys"]["margin"] == 0.3
    assert (cfg["nstates"], cfg["ncontrols"]) == (quadrotor.NSTATES,
                                                  quadrotor.NCONTROLS)
    sig = inspect.signature(quadrotor.make_lqr).parameters
    assert tuple(cfg["lqr"]["q"]) == sig["q"].default
    assert tuple(cfg["lqr"]["r"]) == sig["r"].default
    assert not any(cfg["lqr"]["u_eq"])
    d = cfg["dynamics"]
    for mod in (quadrotor, jquad):
        assert (d["mass"], d["gravity"], d["thrust_max"], d["torque_max"]) \
            == (mod.MASS, mod.G, mod.T_MAX, mod.TAU_MAX)
        np.testing.assert_array_equal(np.float32(d["inertia"]),
                                      np.asarray(mod.INERTIA))
        np.testing.assert_array_equal(np.float32(ref.u_min),
                                      np.asarray(mod.U_MIN))
        np.testing.assert_array_equal(np.float32(ref.u_max),
                                      np.asarray(mod.U_MAX_VEC))
    # the floor of cos(pitch): past it the roll rate's factor tan(p) on
    # the yaw rate is sin(p) / 0.2 in the program and in the reference
    x = torch.zeros(1, 12, dtype=F64)
    x[0, 4], x[0, 11] = 1.5, 1.0                 # cos(1.5) = 0.0707 < 0.2
    rate = quadrotor.f(x, torch.zeros(1, 4, dtype=F64))[0, 3]
    assert float(rate) == pytest.approx(np.sin(1.5) / d["pitch_cos_floor"])
    assert float(ref.f(x, torch.zeros(1, 4, dtype=F64))[0, 3]) == \
        pytest.approx(float(rate))


_RUN = """
import json, sys
import numpy as np
from portbench import run

judge = run.judge


def boxed(r, seed, model=None):
    from portbench.reference.plans import load_model
    m = load_model(r.cfg)
    us = [np.asarray(p["u"], np.float32) for rec in r.replans + r.traced
          for p in rec["plans"]]
    with open(sys.argv[3], "w") as fh:
        json.dump({"plans": len(us), "controls": sum(len(u) for u in us),
                   "outside": sum(int((~m.in_box(u)).sum()) for u in us)},
                  fh)
    return judge(r, seed, model)


run.judge = boxed
sys.exit(run.main(["--workload", "quadrotor.replan", "--seed",
                   "2147483999", "--seconds", "2", "--trace", "0"],
                  device="cpu", manifest_path=sys.argv[1], root=sys.argv[2]))
"""


def test_harness_runs_a_small_quadrotor_cell_correct(tmp_path):
    """``portbench.run.main(device="cpu")`` on the quadrotor cell at batch
    64, capacity 1024, a 2 s window: the result line is ``correct``, with
    the quadrotor's end-to-end metrics and checks (no ``gain_med``), and
    every control of every judged plan lies in the two-sided box.  It runs
    in a fresh interpreter, since the harness refuses a process with JAX
    loaded."""
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(REPO / "portbench" / sub, tmp_path / sub)
    p = tmp_path / "configs/quadrotor_12.json"
    c = json.loads(p.read_text())
    c["planner"].update(batch_size=64, capacity=1024)
    p.write_text(json.dumps(c))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-c", _RUN, str(tmp_path / "BENCHMARK.json"),
         str(tmp_path), str(tmp_path / "box.json")], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "expansions_per_s",
                                   "replan_s", "plan_duration_s"}
    assert set(res["checks"]) == {"bad_plans", "goal_excess", "gap_max",
                                  "gap_med"}
    box = json.loads((tmp_path / "box.json").read_text())
    assert box["plans"] >= 1 and box["controls"] >= 1, box
    assert box["outside"] == 0, box


def test_box_check_catches_thrust_below_its_lower_face(cfg, ref):
    """A plan whose thrust deviation is planted at -12 (under the lower
    face -9.81, inside the judge's one-sided |u| <= 15.19) fails the
    two-sided check at that control alone; the judge's exact checks pass
    it, which is why the box is also checked apart."""
    x0 = np.asarray(cfg["x0"], np.float32)
    u = np.zeros((6, 4), np.float32)
    u[:, 0] = [-9.81, -2.0, 0.0, 3.0, 15.19, 0.5]
    u[:, 1:] = [-0.5, 0.0, 0.5]
    x = [x0]
    for k in range(len(u)):
        x.append(ref.step(torch.as_tensor(x[-1], dtype=F64)[None],
                          torch.as_tensor(u[k], dtype=F64)[None])[0]
                 .numpy().astype(np.float32))
    plan = dict(x=np.stack(x), u=u, x0=x0, goal=np.asarray(cfg["goal"]),
                claims_goal=False, scenario=None)
    assert ref.in_box(u).all() and plan_faults(ref, plan) == []
    bad = dict(plan, u=u.copy())
    bad["u"][2, 0] = -12.0
    assert ref.in_box(bad["u"]).tolist() == [True, True, False, True, True,
                                             True]
    assert plan_faults(ref, bad) == []
