"""Tracing and profiling helpers (port of lqrrt_tpu/utils/timing.py).

Per-phase wall timers with device fences (a timer around work queued on
the card measures the enqueue unless the clock waits for the card) and a
thin wrapper over ``torch.profiler`` traces for Perfetto or
chrome://tracing.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def wait_for(tree) -> None:
    """Wait for the card until every CUDA tensor in ``tree`` (a tensor, or
    a dict / list / tuple of them) is computed: one
    ``torch.cuda.synchronize`` a device.  CPU tensors are computed when an
    op returns."""
    devices = set()

    def walk(t):
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                devices.add(t.device)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates fenced wall-time per named phase.

    >>> timer = PhaseTimer()
    >>> with timer.phase("steer", fence=result):
    ...     result = rollout(...)
    >>> timer.summary()   # {'steer': {'total_s': ..., 'count': ..., ...}}
    """

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        """Time a block; the card is synchronised on ``fence``'s devices
        (any tree of tensors, see ``wait_for``) before the clock stops, so
        queued work does not fake instant phases."""
        t0 = self.clock()
        try:
            yield
        finally:
            if fence is not None:
                wait_for(fence)
            self.totals[name] += self.clock() - t0
            self.counts[name] += 1

    def add(self, name: str, seconds: float):
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: dict(total_s=self.totals[name], count=self.counts[name],
                       mean_s=self.totals[name] / max(self.counts[name], 1))
            for name in self.totals
        }

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` over the enclosed block, the card's kernels
    included when CUDA is available; the trace is written to
    ``log_dir/trace.json`` (Perfetto, chrome://tracing).  Yields the
    profiler, whose ``key_averages()`` sums the kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed_call(fn, *args, **kwargs):
    """Run fn, fence its outputs, return (outputs, elapsed_s)."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    wait_for(out)
    return out, time.perf_counter() - t0


class StreamMarks:
    """Marks between pieces of work enqueued on one stream, read once at
    the end: CUDA events on the card (the work runs chained, nothing
    waits between marks), the host clock on the CPU, where an op has run
    when it returns.

    >>> marks = StreamMarks(device)
    >>> marks.mark(); sample(); marks.mark(); steer(); marks.mark()
    >>> marks.intervals_ms()   # [sample ms, steer ms]
    """

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self):
        """ms between consecutive marks (one synchronize on the card)."""
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b)
                    for a, b in zip(self.marks, self.marks[1:])]
        return [1e3 * (b - a) for a, b in zip(self.marks, self.marks[1:])]


def device_busy(fn):
    """(device kernel ms, kernel count) of one synchronised call of fn on
    the card, from ``torch.profiler`` (``device_trace``)."""
    import tempfile

    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp, device_trace(tmp) as prof:
        fn()
        torch.cuda.synchronize()
    busy_us, kernels = 0.0, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            busy_us += getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
            kernels += e.count
    return busy_us / 1e3, kernels
