"""Replan watchdog — failure detection & salvage (port of
lqrrt_tpu/utils/watchdog.py, which imports no JAX; kept as its own copy).

The reference's nearest analog is kill_update + the anytime property (a
preempted plan still yields best-so-far).  The watchdog makes that automatic:
if an update_plan exceeds its budget by ``grace`` seconds (a hung callback, a
device stall, a pathological feasibility function), the watchdog fires
kill_update() so the planner salvages the best-so-far branch at the next
chunk boundary instead of blocking the replan loop forever.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class ReplanWatchdog:
    """Arm around each update_plan; fires kill_update on budget overrun.

    >>> wd = ReplanWatchdog(planner, grace=0.5)
    >>> with wd.guard():                       # budget = max_time + grace
    ...     planner.update_plan(x0, space)
    >>> wd.fired                               # True if salvage was forced
    """

    def __init__(self, planner, grace: float = 0.5,
                 on_fire: Optional[Callable] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.planner = planner
        self.grace = float(grace)
        self.on_fire = on_fire
        self.clock = clock
        self.fired = False
        self.fire_count = 0
        self._timer: Optional[threading.Timer] = None
        self._lock = threading.Lock()

    def arm(self, budget_s: Optional[float] = None):
        """Start the countdown: budget_s (default planner.max_time) + grace."""
        budget = self.planner.max_time if budget_s is None else float(budget_s)
        with self._lock:
            self._cancel_locked()
            self.fired = False
            self._timer = threading.Timer(budget + self.grace, self._fire)
            self._timer.daemon = True
            self._timer.start()

    def disarm(self):
        with self._lock:
            self._cancel_locked()

    def _cancel_locked(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def _fire(self):
        self.fired = True
        self.fire_count += 1
        self.planner.kill_update()
        if self.on_fire is not None:
            self.on_fire()

    class _Guard:
        def __init__(self, wd, budget_s):
            self.wd = wd
            self.budget_s = budget_s

        def __enter__(self):
            self.wd.arm(self.budget_s)
            return self.wd

        def __exit__(self, *exc):
            self.wd.disarm()
            return False

    def guard(self, budget_s: Optional[float] = None) -> "_Guard":
        """Context manager: arm on enter, disarm on exit."""
        return self._Guard(self, budget_s)
