"""The plain reference: its gain, its raster, and the numbers it judges a
plan by, which flag a perturbed plan."""
import ast
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, REPO
from portbench import cells
from portbench.reference import plans as P


@pytest.fixture(scope="module")
def boat():
    cfg = cells.config("boat_wamv")
    model = P.load_model(cfg)
    return cfg, model, model.gain()


def _rollout(model, K, x0, target, steps):
    """A plan as the program's steer makes it, in float32: u = sat(K e)
    and one RK4 step, both rounded to float32 each step."""
    xs = [np.asarray(x0, np.float32)]
    us = []
    Kt = torch.as_tensor(K, dtype=torch.float32)
    for _ in range(steps):
        x = torch.as_tensor(xs[-1])
        e = model.error(torch.as_tensor(np.asarray(target, np.float32)), x)
        u = model.saturate(Kt @ e)
        us.append(u.numpy())
        xs.append(model.step(x, u).numpy())
    return dict(x=np.array(xs), u=np.array(us), x0=xs[0],
                goal=np.asarray(target, np.float32), claims_goal=False,
                scenario=None)


@pytest.fixture(scope="module")
def plan(boat):
    cfg, model, K = boat
    return _rollout(model, K, cfg["x0"], [6.0, 1.0, 0.3, 0, 0, 0], 120)


def test_gain_matches_scipy(boat):
    from scipy.linalg import solve_continuous_are
    cfg, model, K = boat
    A = np.array([[0, 0, 0, 1, 0, 0], [0, 0, 0.1, 0, 1, 0],
                  [0, 0, 0, 0, 0, 1], [0, 0, 0, -42 / 350, 0, 0],
                  [0, 0, 0, 0, -60 / 400, -35 / 400],
                  [0, 0, 0, 0, -5 / 400, -60 / 400]], np.float64)
    B = np.zeros((6, 3))
    B[3:, :] = np.diag([1 / 350, 1 / 400, 1 / 400])
    Q, R = np.diag(cfg["lqr"]["q"]), np.diag(cfg["lqr"]["r"])
    S = solve_continuous_are(A, B, Q, R)
    np.testing.assert_allclose(K, np.linalg.solve(R, B.T @ S), rtol=1e-6,
                               atol=1e-6)


def test_raster_is_the_programs(boat):
    from lqrrt_tpu_torch.models import boat as prog
    cfg, model, _ = boat
    centers, radii = prog.default_problem()["obstacles"]
    assert np.array_equal(model.raster(), prog.buoy_grid(centers,
                                                         radii).occ)


def test_a_sound_plan_passes(boat, plan):
    cfg, model, K = boat
    nums, faults = P.judge(model, [plan], K=K)
    assert faults == [] and nums["bad_plans"] == 0
    assert nums["gap_max"] < 1e-4 and nums["gain_med"] < 1e-5
    for name, spec in cfg["limits"].items():
        assert nums[name] <= spec["limit"], name


@pytest.mark.parametrize("fault", ["moved", "start", "wrench", "buoy",
                                   "goal", "missing"])
def test_a_perturbed_plan_fails(boat, plan, fault):
    cfg, model, K = boat
    p = {k: (v.copy() if isinstance(v, np.ndarray) else v)
         for k, v in plan.items()}
    if fault == "moved":
        p["x"][60, 1] += 0.5
    elif fault == "start":
        p["x"][0, 0] = 1e-3
    elif fault == "wrench":
        p["u"][10, 0] = 601.0
    elif fault == "buoy":
        p["x"][-1, :2] = cfg["buoys"]["centers"][0]
    elif fault == "goal":
        p["claims_goal"] = True
        p["goal"] = p["x"][-1] + np.float32(2.0)
    else:
        p["x"] = None
    nums, _ = P.judge(model, [p], K=K)
    over = [n for n, s in cfg["limits"].items()
            if n in nums and nums[n] > s["limit"]]
    assert over, nums


def test_the_control_fails(boat, plan):
    cfg, model, K = boat
    nums, _ = P.judge(model, P.control_plans(model, [plan]), K=K)
    assert nums["gap_med"] > cfg["limits"]["gap_med"]["limit"]
    assert nums["gain_med"] > cfg["limits"]["gain_med"]["limit"]


def test_fitted_controls(boat, plan):
    cfg, model, _ = boat
    p = dict(plan, u=None)
    nums, _ = P.judge(model, [p])
    assert nums["gap_max"] < 1e-4 and "gain_med" not in nums
    c, _ = P.judge(model, P.control_plans(model, [p]))
    assert c["gap_med"] > cfg["limits"]["gap_med"]["limit"]


def test_grid_and_circles(boat):
    cfg, model, _ = boat
    occ = model.raster()
    c = np.asarray(cfg["buoys"]["centers"], np.float32)
    assert not model.circles_free(c).any()
    assert not model.grid_free(c, occ).any()
    far = np.array([[0.0, 0.0], [40.0, 0.0]], np.float32)
    assert model.circles_free(far).all() and model.grid_free(far, occ).all()
    assert not model.grid_free(np.array([[100.0, 0.0]], np.float32),
                               occ).any()
    shifted = model.raster(np.array([[0.0, 0.0], [3.0, 0.0]]))
    assert np.array_equal(shifted[0], occ)
    assert not np.array_equal(shifted[1], occ)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "lqrrt_tpu",
                                               "lqrrt_tpu_torch"), path
    code = ("import sys; from portbench.reference import plans; "
            "plans.load_model(__import__('json').load(open("
            "'portbench/configs/boat_wamv.json'))); "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'lqrrt_tpu', 'lqrrt_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
