"""Scenario parallelism (port of lqrrt_tpu/parallel): ``FleetPlanner``, a
fleet of independent planners on one device.  The mesh paths (sharded
rounds, sharded maps) are ROADMAP queue 1, item 16."""
from .fleet import FleetPlanner

__all__ = ["FleetPlanner"]
