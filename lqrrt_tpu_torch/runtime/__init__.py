"""Native host runtime: the controller-rate plan query path in C (a
lock-free seqlock double buffer); see trajectory_server.py."""
from .trajectory_server import (NativeUnavailable,  # noqa: F401
                                TrajectoryServer)
