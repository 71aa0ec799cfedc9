"""Host-side subsystems (port of lqrrt_tpu/utils): phase timers and
traces, structured metrics, checkpoint/resume, the replan watchdog and
the card's identity.
The JAX package's ``cache`` (its compile cache) has no counterpart."""
from . import checkpoint, device, metrics, timing, watchdog  # noqa: F401
from .checkpoint import load, save  # noqa: F401
from .metrics import BufferSink, JsonlSink, StdoutSink, attach  # noqa: F401
from .timing import PhaseTimer, device_trace, timed_call  # noqa: F401
from .watchdog import ReplanWatchdog  # noqa: F401
