"""Parallel planning (port of lqrrt_tpu/parallel): ``FleetPlanner``, a
fleet of independent planners (its scenarios sharded over ranks with
``mesh=``); ``mesh`` (meshes over ``torch.distributed``), ``sharded`` (the
candidate batch sharded over ranks) and ``map_sharded`` (an occupancy
grid sharded over ranks)."""
from .fleet import FleetPlanner

__all__ = ["FleetPlanner"]
