"""Tree and plan figures (port of lqrrt_tpu/viz.py): a matplotlib scatter
of the nodes, the edge segments and the plan, projected on two state dims,
and an animated replay of the tree's growth with a vehicle trace.

Host side only: the planner's device tree is taken to numpy once
(``.cpu().numpy()`` of every field).  matplotlib is imported when a figure
is drawn, not with this module; where it is missing, drawing raises
``ImportError``.
"""
from __future__ import annotations

import numpy as np


def _host_tree(planner):
    """The planner's device tree as numpy arrays, or None."""
    tree = planner._device_tree
    if tree is None:
        return None
    return type(tree)(*(t.cpu().numpy() for t in tree))


def visualize_planner(planner, dx: int = 0, dy: int = 1, ax=None,
                      show: bool = True, max_edges: int = 4000):
    """Draw the tree's nodes and edges, the plan and the goal on dims
    (dx, dy); returns the axes."""
    import matplotlib
    if show is False and matplotlib.get_backend().lower() != "agg":
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(9, 6))
    host = _host_tree(planner)
    if host is not None:
        size = int(host.size)
        states = host.state[:size]
        ax.scatter(states[:, dx], states[:, dy], s=2, c="#8899aa", zorder=2)
        # edge polylines (downsample if huge)
        step = max(size // max_edges, 1)
        for i in range(1, size, step):
            ln = int(host.edge_len[i])
            if ln > 0:
                seg = host.edge_x[:ln, :, i]     # time-major (H, n, N)
                p = host.state[int(host.parent[i])]
                xs = np.concatenate([[p[dx]], seg[:, dx]])
                ys = np.concatenate([[p[dy]], seg[:, dy]])
                ax.plot(xs, ys, lw=0.3, c="#bbccdd", zorder=1)
    if planner.x_seq is not None and len(planner.x_seq) > 1:
        ax.plot(planner.x_seq[:, dx], planner.x_seq[:, dy], lw=2.0,
                c="#cc3333", zorder=3, label="plan")
    if planner.goal is not None:
        g = planner.goal.cpu().numpy()
        ax.plot(g[dx], g[dy], "*", ms=14, c="#33aa33", zorder=4, label="goal")
    ax.set_xlabel(f"state[{dx}]")
    ax.set_ylabel(f"state[{dy}]")
    ax.legend(loc="best")
    ax.set_aspect("equal", adjustable="datalim")
    if show:
        plt.show()
    return ax


def animate_planner(planner, dx: int = 0, dy: int = 1, path: str = None,
                    x_hist=None, fps: int = 20, growth_frames: int = 30,
                    max_edges: int = 2000, dpi: int = 80):
    """Animated tree growth and vehicle trace.

    Phase 1 replays the tree's growth in commit order (rows are stored in
    the order rounds committed them, so sweeping a prefix of the arrays
    replays the growth).  Phase 2 drives a vehicle marker along ``x_hist``
    (a tracked trajectory) or the committed plan.  Saves a GIF when
    ``path`` is given (Pillow writer); returns the FuncAnimation."""
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    host = _host_tree(planner)
    if host is None:
        raise RuntimeError("no tree; call update_plan first")
    size = int(host.size)
    plan = planner.x_seq
    trace = np.asarray(x_hist if x_hist is not None else plan)

    fig, ax = plt.subplots(figsize=(9, 6))
    if planner.goal is not None:
        g = planner.goal.cpu().numpy()
        ax.plot(g[dx], g[dy], "*", ms=14, c="#33aa33", zorder=5)
    # downsampled edge polylines in commit order
    step = max(size // max_edges, 1)
    lines = []
    for i in range(1, size, step):
        ln = int(host.edge_len[i])
        p = host.state[int(host.parent[i])]
        seg = host.edge_x[:ln, :, i] if ln > 0 else host.state[i][None]
        xs = np.concatenate([[p[dx]], seg[:, dx]])
        ys = np.concatenate([[p[dy]], seg[:, dy]])
        (line,) = ax.plot(xs, ys, lw=0.3, c="#bbccdd", zorder=1,
                          visible=False)
        lines.append(line)
    if plan is not None and len(plan) > 1:
        (plan_line,) = ax.plot(plan[:, dx], plan[:, dy], lw=2.0, c="#cc3333",
                               zorder=3, visible=False)
    else:
        plan_line = None
    (veh,) = ax.plot([], [], "o", ms=8, c="#2244cc", zorder=6)
    ax.set_xlabel(f"state[{dx}]")
    ax.set_ylabel(f"state[{dy}]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.relim()
    ax.autoscale_view()

    trace_stride = max(len(trace) // (4 * growth_frames), 1)
    trace_frames = len(range(0, len(trace), trace_stride))
    n_frames = growth_frames + trace_frames

    def update(f):
        if f < growth_frames:               # phase 1: the tree's growth
            upto = int((f + 1) / growth_frames * len(lines))
            for line in lines[:upto]:
                line.set_visible(True)
            return lines[:upto]
        if plan_line is not None:
            plan_line.set_visible(True)
        k = min((f - growth_frames) * trace_stride, len(trace) - 1)
        veh.set_data([trace[k, dx]], [trace[k, dy]])
        return [veh]

    anim = FuncAnimation(fig, update, frames=n_frames, blit=False,
                         interval=1000 / fps)
    if path is not None:
        anim.save(path, writer=PillowWriter(fps=fps), dpi=dpi)
        plt.close(fig)
    return anim
