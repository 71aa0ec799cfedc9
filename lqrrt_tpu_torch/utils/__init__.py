"""Host-side subsystems (port of lqrrt_tpu/utils): phase timers and
traces, structured metrics, checkpoint/resume and the replan watchdog.
The JAX package's ``cache`` (its compile cache) has no counterpart."""
from . import checkpoint, metrics, timing, watchdog  # noqa: F401
from .checkpoint import load, save  # noqa: F401
from .metrics import BufferSink, JsonlSink, StdoutSink, attach  # noqa: F401
from .timing import PhaseTimer, device_trace, timed_call  # noqa: F401
from .watchdog import ReplanWatchdog  # noqa: F401
