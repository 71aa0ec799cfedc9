"""The port's demos (``lqrrt_tpu_torch/demos/``) on the CPU.

- The tracker: ``demos.common.make_tracker`` (a PyTorch loop, one batched
  lqr call) against the JAX demos' ``make_tracker`` (``demos/common.py``, a
  jitted ``lax.scan``; its function is loaded from the file's source, since
  importing the module enables a persistent JAX cache in the repo) on the
  same xref/uff for the four models: a reference rolled out from x0 under
  smooth efforts (a quarter of each model's limits; the quadrotor's near
  hover, where larger torques tumble the open-loop reference), tracked
  from x0 moved by 0.1 in position.  Executed states within 1e-3 + 1e-4 |x| of JAX's
  (fp32 over 60 steps; the car's and the quadrotor's gains are
  re-linearized CAREs, Gauss-Jordan in JAX and LU here).
- Each demo's ``run_single`` at batch 64 and capacity 2048 with a 20 s
  ceiling (the planner stops once its tree is full): exit 0 (goal reached,
  clearance > 0, tracked position within the demo's tolerance) and a
  figure of over 1000 bytes; the double integrator's replan loop, exit 0
  with no figure.
- A figure's path without matplotlib raises ImportError; ``--device cuda``
  without CUDA raises; the flags parse as the JAX demos'."""
import ast
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lqrrt_tpu.models import boat as jboat
from lqrrt_tpu.models import car as jcar
from lqrrt_tpu.models import double_integrator as jdi
from lqrrt_tpu.models import quadrotor as jquad
from lqrrt_tpu_torch.demos import (boat_demo, car_demo, common,
                                   double_integrator_demo, quadrotor_demo)
from lqrrt_tpu_torch.models import boat, car, double_integrator, quadrotor

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
T = 60


def _jax_make_tracker():
    """``make_tracker`` of demos/common.py, compiled alone from the file's
    source with the names it reads (jax, jnp)."""
    tree = ast.parse((REPO / "demos" / "common.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "make_tracker")
    ns = {"jax": jax, "jnp": jnp}
    exec(compile(ast.Module([fn], []), "demos/common.py", "exec"), ns)
    return ns["make_tracker"]


# name: (port model, JAX model, the efforts' amplitude over 0.25)
MODELS = {"boat": (boat, jboat, boat.WRENCH_MAX),
          "car": (car, jcar, car.U_MAX_VEC),
          "quadrotor": (quadrotor, jquad, np.float32([0.4, 0.002, 0.002, 0.002])),
          "double_integrator": (double_integrator, jdi,
                                np.full(2, double_integrator.U_MAX,
                                        np.float32))}


def _reference(name):
    """(x0 moved by 0.1 in position, xref (T, n), uff (T, m)) float32: the
    port's dynamics rolled out from the problem's x0 under smooth efforts."""
    model, _, scale = MODELS[name]
    prob = model.default_problem()
    m = prob["constraints"].ncontrols
    k = np.arange(T)[:, None]
    uff = (0.25 * scale * np.sin(0.1 * k + np.arange(m))).astype(np.float32)
    x = torch.from_numpy(np.asarray(prob["x0"], np.float32))
    xref = []
    for u in torch.from_numpy(uff):
        xref.append(x.numpy().copy())
        x = prob["dynamics"](x, u, prob["dt"])
    x0 = np.asarray(prob["x0"], np.float32).copy()
    x0[:2] += 0.1
    return prob, x0, np.stack(xref), uff


@pytest.mark.parametrize("name", list(MODELS))
def test_tracker_matches_jax(name):
    prob, x0, xref, uff = _reference(name)
    port = common.make_tracker(prob, "cpu")(x0, xref, uff)
    assert port.shape == (T, len(x0)) and port.device.type == "cpu"
    jtrack = _jax_make_tracker()(MODELS[name][1].default_problem())
    ref = np.asarray(jtrack(jnp.asarray(x0), jnp.asarray(xref),
                            jnp.asarray(uff)))
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-4, atol=1e-3)
    # it tracks: the 0.1 m offset shrinks
    err = np.abs(port.numpy()[-1, :2] - xref[-1, :2]).max()
    assert err < 0.1


# name: (model, goal bias, pos_tol) as the JAX demos pass them
DEMOS = {"boat": (boat, np.float32([0.3, 0.3, 0, 0, 0, 0]), 0.5),
         "car": (car, np.float32([0.25, 0.25, 0, 0]), 1.5),
         "quadrotor": (quadrotor, np.r_[[0.25] * 3, [0.0] * 9].astype(
             np.float32), 1.0),
         "double_integrator": (double_integrator, 0.2, 0.5)}


@pytest.mark.parametrize("name", list(DEMOS))
def test_run_single_small(name, tmp_path, capsys):
    model, gb, tol = DEMOS[name]
    out = tmp_path / f"{name}.png"
    rc = common.run_single(name, model.default_problem(), gb, str(out),
                           pos_tol=tol, device="cpu", batch_size=64,
                           capacity=2048, max_time=20.0, printing=False)
    printed = capsys.readouterr().out
    assert rc == 0, printed
    assert f"[{name}] plan: reached_goal=True" in printed
    assert out.stat().st_size > 1000
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_replan_loop_small(capsys):
    rc = common.run_replan_loop("di", double_integrator.default_problem(),
                                0.2, None, device="cpu", batch_size=64,
                                capacity=2048, printing=False)
    printed = capsys.readouterr().out
    assert rc == 0, printed
    assert "replanning run" in printed and "figure" not in printed


def test_figure_without_matplotlib_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        common.save_figure(None, None, None, "x.png")


@pytest.mark.parametrize("demo", [boat_demo, car_demo, quadrotor_demo,
                                  double_integrator_demo])
def test_demo_defaults_to_the_card(demo, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main([])
    args = common.parser(demo.__doc__, "x").parse_args(
        ["--replan", "--seed", "3", "--out", "f.png"])
    assert (args.replan, args.seed, args.out, args.device) == (
        True, 3, "f.png", "cuda")
    assert common.parser(demo.__doc__, "x").parse_args([]).out is None
