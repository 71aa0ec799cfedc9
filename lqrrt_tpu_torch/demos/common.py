"""What the demos share: plan -> track -> check -> figure (port of
demos/common.py).

Each model module exports a ``default_problem()`` dict, so the demos share
this module.  The planner runs on ``device`` ("cuda" by default, which
raises without CUDA).  Tracking is a plain PyTorch loop on the planner's
device: the gains of every reference step come from one batched ``lqr``
call, then x_{k+1} = f(x_k, sat(uff_k + K_k e_k)) step by step (the JAX
package's tracker is one jitted ``lax.scan``, not a kernel).

``out=None`` draws no figure; a path draws one with matplotlib, and raises
``ImportError`` where matplotlib is missing.  A run that fails its check
returns 1.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..planner import Planner


def build_planner(prob, seed=0, device="cuda", **overrides):
    """The demos' planner: batch 256, capacity 8192, FPR 0.2 and a 0.3-1.0 s
    budget (the reference's ~1 s replan)."""
    kw = dict(min_time=0.3, max_time=1.0, batch_size=256, capacity=8192,
              seed=seed, wrap_dims=prob.get("wrap_dims", ()),
              saturate=prob.get("saturate"), FPR=0.2, device=device)
    kw.update(overrides)
    return Planner(prob["dynamics"], prob["lqr"], prob["constraints"],
                   horizon=prob["horizon"], dt=prob["dt"],
                   goal0=prob["goal"], **kw)


def make_tracker(prob, device="cuda"):
    """track(x0 (n,), xref_seq (T, n), uff_seq (T, m)) -> (T, n) executed
    states on ``device``: x_{k+1} = f(x_k, sat(uff_k + K_k erf(xref_k,
    x_k))), K_k from ``lqr(xref_k, uff_k)``."""
    dynamics, lqr, erf = prob["dynamics"], prob["lqr"], prob["erf"]
    saturate = prob.get("saturate")
    dt = prob["dt"]

    def track(x0, xref_seq, uff_seq):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        x, xref, uff = t(x0), t(xref_seq), t(uff_seq)
        _, K = lqr(xref, uff)
        traj = torch.empty_like(xref)
        for k in range(len(xref)):
            u = uff[k] + K[k] @ erf(xref[k], x)
            if saturate is not None:
                u = saturate(u)
            x = dynamics(x, u, dt)
            traj[k] = x
        return traj

    return track


def track_plan(prob, planner, extra_steps: int = 40):
    """Simulate the vehicle tracking the committed plan; returns (T + extra,
    n) executed states, x0 first, as numpy."""
    dt = prob["dt"]
    n_steps = int(planner.T / dt) + extra_steps
    ts = np.arange(n_steps) * dt
    xref = np.stack([planner.get_state(t) for t in ts])
    uff = np.stack([planner.get_effort(t) for t in ts])
    traj = make_tracker(prob, planner.device)(prob["x0"], xref, uff)
    return np.concatenate([np.asarray(prob["x0"])[None],
                           traj.cpu().numpy()], axis=0)


def min_clearance(prob, traj, pos_dims=(0, 1)):
    """The least distance from the trajectory to an obstacle's rim."""
    centers, radii = prob["obstacles"]
    if len(centers) == 0:
        return float("inf")
    p = traj[:, list(pos_dims)]
    d = np.linalg.norm(p[:, None] - np.asarray(centers)[None], axis=-1)
    return float((d - np.asarray(radii)[None]).min())


def save_figure(prob, planner, traj, out, dx=0, dy=1):
    """The tree, the plan, the executed trajectory and the obstacles, saved
    to ``out``."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ax = planner.visualize(dx, dy, show=False)
    ax.plot(traj[:, dx], traj[:, dy], "--", lw=1.5, c="#3355cc",
            label="executed")
    centers, radii = prob["obstacles"]
    for c, r in zip(np.asarray(centers), np.asarray(radii)):
        ax.add_patch(plt.Circle(c, r, fc="#223344", alpha=0.4))
    ax.legend(loc="best")
    plt.savefig(out, dpi=110, bbox_inches="tight")
    plt.close(ax.figure)
    print(f"figure saved to {out}")


def run_single(name, prob, goal_bias, out=None, seed=0, pos_tol=0.5,
               finish_on_goal=True, device="cuda", **planner_overrides):
    """One-shot demo: warm up, plan once, track, check and, with ``out``,
    save the figure.  Returns the exit code: 0 when the goal was reached,
    the executed trajectory keeps clear of every obstacle and its final
    position is within ``pos_tol`` of the goal's."""
    planner = build_planner(prob, seed=seed, device=device,
                            **planner_overrides)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=0.05, pruning=False)  # warm-up
    t0 = time.time()
    reached = planner.update_plan(prob["x0"], prob["sample_space"],
                                  goal_bias=goal_bias,
                                  finish_on_goal=finish_on_goal)
    print(f"[{name}] plan: reached_goal={reached} in {time.time()-t0:.2f}s "
          f"stats={planner.stats}")
    traj = track_plan(prob, planner)
    err = np.abs(np.asarray(prob["goal"])[:2] - traj[-1][:2])
    clear = min_clearance(prob, traj)
    print(f"[{name}] tracking: final position error = {err} over "
          f"{planner.T:.1f}s plan; min obstacle clearance = {clear:.2f}")
    if out is not None:
        save_figure(prob, planner, traj, out)
    ok = reached and clear > 0 and float(np.linalg.norm(err)) < pos_tol
    return 0 if ok else 1


def run_replan_loop(name, prob, goal_bias, out=None, seed=0, hz=1.0,
                    max_replans=30, device="cuda", **planner_overrides):
    """Replan at ``hz`` from the currently executed state while tracking
    the committed plan (FPR > 0 warm-starts each replan from the previous
    plan).  Returns 0 when the final position is within 1 m of the goal's
    and the trajectory keeps clear of every obstacle."""
    planner = build_planner(prob, seed=seed, device=device,
                            max_time=1.0 / hz, min_time=min(0.3, 1.0 / hz),
                            **planner_overrides)
    planner.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                        specific_time=0.05, pruning=False)  # warm-up
    track = make_tracker(prob, planner.device)
    dt = prob["dt"]
    exec_steps = max(int(round(1.0 / hz / dt)), 1)
    x = np.asarray(prob["x0"], np.float32)
    full_traj = [x.copy()]
    goal = np.asarray(prob["goal"])
    for k in range(max_replans):
        reached = planner.update_plan(x, prob["sample_space"],
                                      goal_bias=goal_bias)
        # execute 1/hz seconds of the fresh plan
        ts = np.arange(exec_steps) * dt
        xref = np.stack([planner.get_state(t) for t in ts])
        uff = np.stack([planner.get_effort(t) for t in ts])
        seg = track(x, xref, uff).cpu().numpy()
        x = seg[-1]
        full_traj.extend(seg)
        pos_err = np.linalg.norm(goal[:2] - x[:2])
        print(f"[{name}] replan {k}: goal={reached} nodes="
              f"{planner.stats['nodes']} pos_err={pos_err:.2f}")
        if reached and pos_err < 1.0:
            break
    traj = np.asarray(full_traj)
    clear = min_clearance(prob, traj)
    print(f"[{name}] replanning run: {k + 1} replans, final pos_err="
          f"{pos_err:.2f}, min clearance = {clear:.2f}")
    if out is not None:
        save_figure(prob, planner, traj, out)
    return 0 if (pos_err < 1.0 and clear > 0) else 1


def parser(doc: str, name: str):
    """The demos' flags: --replan, --seed, --out (a figure's path; none by
    default) and --device."""
    import argparse

    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--replan", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help=f"save a figure here (e.g. {name}_demo.png; needs "
                    "matplotlib)")
    ap.add_argument("--device", default="cuda")
    return ap
