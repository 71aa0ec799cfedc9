"""The port's figures (``lqrrt_tpu_torch/viz.py``, ``Planner.visualize``)
against the JAX package's (``lqrrt_tpu/viz.py``) on the CPU.

A JAX planner plans the double integrator at the shapes of
tests/test_utils.py's GIF test (batch 32, capacity 128, 0.2 s); its tree
goes through ``interop.tree_from_numpy`` into a port planner, with its plan
and goal.  Both packages then draw from the same tree: the scatter's
points, every line's (x, y) data in order and the legend must be equal
(exact: both draw the same float32 values).  The port's
``animate_planner`` writes a GIF of over 1000 bytes from its own plan at
those shapes, and its frames' lines equal the JAX animation's on the
imported tree.  matplotlib runs with the Agg backend."""
import matplotlib

matplotlib.use("Agg")

import jax  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import lqrrt_tpu  # noqa: E402
from lqrrt_tpu import viz as jviz  # noqa: E402
from lqrrt_tpu.models import double_integrator as jdi  # noqa: E402
from lqrrt_tpu_torch import interop, viz  # noqa: E402
from lqrrt_tpu_torch.models import double_integrator as di  # noqa: E402
from lqrrt_tpu_torch.planner import Planner  # noqa: E402

torch.set_num_threads(2)

SHAPES = dict(printing=False, batch_size=32, capacity=128, nn_block=128,
              seed=4)


def _planner(prob, cls, **kw):
    return cls(prob["dynamics"], prob["lqr"], prob["constraints"],
               horizon=prob["horizon"], dt=prob["dt"], goal0=prob["goal"],
               saturate=prob["saturate"], **SHAPES, **kw)


@pytest.fixture(scope="module")
def planners():
    """(the JAX planner after a 0.2 s plan, a port planner holding its
    tree, plan and goal)."""
    jprob = jdi.default_problem()
    jp = _planner(jprob, lqrrt_tpu.Planner)
    jp.update_plan(jprob["x0"], jprob["sample_space"], goal_bias=0.2,
                   pruning=False, specific_time=0.2)
    p = _planner(di.default_problem(), Planner, device="cpu")
    p._device_tree = interop.tree_from_numpy(jax.device_get(jp._device_tree),
                                             device="cpu")
    p._plan = (np.asarray(jp.x_seq), np.asarray(jp.u_seq), jp.T)
    return jp, p


def _drawn(ax):
    """(scatter points, [(x, y) of each line], legend labels) of an axes."""
    points = [np.asarray(c.get_offsets()) for c in ax.collections]
    lines = [np.asarray(line.get_xydata()) for line in ax.lines]
    legend = ax.get_legend()
    labels = [t.get_text() for t in legend.get_texts()] if legend else []
    return points, lines, labels


@pytest.mark.parametrize("dims", [(0, 1), (2, 3)])
def test_visualize_draws_what_jax_draws(planners, dims):
    jp, p = planners
    jax_ax = jviz.visualize_planner(jp, *dims, show=False)
    port_ax = viz.visualize_planner(p, *dims, show=False)
    (jpts, jlines, jlabels), (ppts, plines, plabels) = (_drawn(jax_ax),
                                                        _drawn(port_ax))
    size = int(jp._device_tree.size)
    assert len(ppts) == 1 and ppts[0].shape == (size, 2)
    assert len(plines) == len(jlines) > 2       # edges, plan and goal
    for a, b in zip(ppts + plines, jpts + jlines):
        np.testing.assert_array_equal(a, b)
    assert plabels == jlabels == ["plan", "goal"]
    assert port_ax.get_xlabel() == f"state[{dims[0]}]"
    plt.close("all")


def test_planner_visualize_delegates(planners):
    _, p = planners
    ax = p.visualize(0, 1, show=False)
    ref = viz.visualize_planner(p, 0, 1, show=False)
    for a, b in zip(_drawn(ax)[1], _drawn(ref)[1]):
        np.testing.assert_array_equal(a, b)
    plt.close("all")


def test_animation_frames_match_jax(planners):
    """animate_planner's edge lines (commit order), plan line and marker
    equal the JAX animation's on the same tree; no file without a path."""
    jp, p = planners
    janim = jviz.animate_planner(jp, growth_frames=4)
    anim = viz.animate_planner(p, growth_frames=4)
    jl, pl = janim._fig.axes[0].lines, anim._fig.axes[0].lines
    assert len(pl) == len(jl) > 3
    for a, b in zip(pl, jl):
        np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())
    plt.close("all")


def test_animate_planner_writes_gif(tmp_path):
    """The port's own plan at tests/test_utils.py's GIF shapes."""
    prob = di.default_problem()
    p = _planner(prob, Planner, device="cpu")
    p.update_plan(prob["x0"], prob["sample_space"], goal_bias=0.2,
                  pruning=False, specific_time=0.2)
    out = tmp_path / "anim.gif"
    viz.animate_planner(p, path=str(out), growth_frames=4, fps=5, dpi=40)
    assert out.stat().st_size > 1000
    assert out.read_bytes()[:6] in (b"GIF87a", b"GIF89a")


def test_no_tree_raises():
    p = _planner(di.default_problem(), Planner, device="cpu")
    with pytest.raises(RuntimeError, match="no tree"):
        viz.animate_planner(p)
    ax = viz.visualize_planner(p, show=False)     # the goal alone
    assert [t.get_text() for t in ax.get_legend().get_texts()] == ["goal"]
    plt.close("all")
