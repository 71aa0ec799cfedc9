"""lqrrt_tpu_torch — the lqrrt_tpu planner in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``lqrrt_tpu`` is the reference; this package keeps its
module names so each counterpart is easy to find, and it never imports
``jax`` or ``lqrrt_tpu``.

Callback convention: BATCH-LEADING.  User callbacks take tensors with any
number of leading batch axes and broadcast over them, so no vmap is needed:

    dynamics(x[..., n], u[..., m], dt) -> x_next[..., n]
    erf(xgoal[..., n], x[..., n])      -> e[..., n]
    is_feasible(x[..., n], u[..., m])  -> bool[...]
    lqr(x[..., n], u[..., m])          -> (S[..., n, n], K[..., m, n])
    saturate(u[..., m])                -> u[..., m]

The device is explicit: ``Planner(..., device="cuda")`` is the default and
raises when CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch
versions of the kernels.

Models: ``models.boat`` (a constant LQR), ``models.car`` and
``models.quadrotor`` (an LQR re-linearized and re-solved at every node),
``models.double_integrator``.

Fleet: ``parallel.FleetPlanner`` grows many scenarios' trees at once (the
boat fleet of ``demos/fleet_demo.py``, measured by ``python3 -m
portbench.run --workload fleet.plan``).

Several devices: one process a device under ``torch.distributed``
(``parallel.mesh``: ``init_distributed``, ``make_mesh`` and its 2-D
forms); ``Planner(mesh=...)`` shards each round's candidates over ranks,
``Planner(mesh=..., feasibility_grid=parallel.map_sharded.ShardedGrid(...))``
shards an occupancy grid, ``FleetPlanner(mesh=...)`` the scenarios.

Host side: ``Tree`` (``Planner.get_tree``'s snapshot), ``utils``
(checkpoints, metrics sinks, the replan watchdog, the phase timer and
span recorder, the card's identity) and
``runtime.TrajectoryServer`` (the plan in a C seqlock for controllers).
"""
from .constraints import Constraints
from .planner import Planner
from .tree import Tree

__all__ = ["Planner", "Tree", "Constraints"]
__version__ = "0.1.0"
