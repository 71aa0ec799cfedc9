"""Tracing and profiling helpers (port of lqrrt_tpu/utils/timing.py).

Per-phase wall timers with device fences (a timer around work queued on
the card measures the enqueue unless the clock waits for the card), the
span recorder the planner and the fleet time their loops, rounds and
extraction with (host clock, no fence; a ``torch.profiler`` range while
the profiler runs), and a thin wrapper over ``torch.profiler`` traces for
Perfetto or chrome://tracing.
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
    """Accumulates fenced wall-time per named phase, and host-time spans.

    >>> timer = PhaseTimer()
    >>> with timer.phase("steer", fence=result):
    ...     result = rollout(...)
    >>> timer.summary()   # {'steer': {'total_s': ..., 'count': ..., ...}}

    ``span(name)`` times a block on ``time.perf_counter_ns`` and never
    fences: it takes no sync, makes no tensor and launches nothing, so it
    may sit inside work that must not sync (the planner's chunks).  Spans
    nest: each name keeps the names of the spans it ran inside with the
    count of each (``parents``; the top is not counted), the one it ran
    inside most often (``parent``, the first on a tie, None at the top),
    and its self time, the duration less what its child spans cover.
    While ``torch.profiler`` runs, a span is
    also a host range of the same name on the profiler's timeline, beside
    the device's kernels.  The range is a function-scope record
    (``torch._C._profiler._RecordFunctionFast``), not ``record_function``:
    a user-scope range makes the profiler add a device-side annotation
    over every kernel it encloses, which a reader of the trace would take
    for device time.

    >>> with timer.span("planner.chunk"):
    ...     with timer.span("round.steer"):
    ...         ...
    >>> timer.span_summary()  # {'round.steer': {'count': 1, 'total_s':
    ...                       #   ..., 'self_s': ..., 'parent':
    ...                       #   'planner.chunk', 'parents':
    ...                       #   {'planner.chunk': 1}}, ...}

    ``tally(name, n=1)`` counts events on the host beside the spans (the
    planner's steer calls by route, the per-node LQR's rows), read by
    ``tallies()`` and reset with them.

    ``record=False`` makes a recorder whose spans and tallies do nothing
    (``NO_SPANS``, the default of the round factories).
    """

    def __init__(self, clock=time.perf_counter, record: bool = True):
        self.clock = clock
        self.record = record
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        # name -> [count, total_ns, self_ns, {parent: count}, last_ns]
        self._spans: Dict[str, list] = {}
        self._open: list = []        # [name, child_ns] of each open span
        self._tallies: Dict[str, int] = defaultdict(int)

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

    def span(self, name: str):
        """A context manager that times the block as span ``name``."""
        return self._span(name) if self.record else _NO_SPAN

    @contextlib.contextmanager
    def _span(self, name: str):
        parent = self._open[-1] if self._open else None
        frame = [name, 0]
        label = (torch._C._profiler._RecordFunctionFast(name)
                 if torch.autograd._profiler_enabled() else _NO_SPAN)
        with label:
            self._open.append(frame)
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                dur = time.perf_counter_ns() - t0
                self._open.pop()
                if parent is not None:
                    parent[1] += dur
                rec = self._spans.get(name)
                if rec is None:
                    rec = self._spans[name] = [0, 0, 0, {}, 0]
                rec[0] += 1
                rec[1] += dur
                rec[2] += dur - frame[1]
                up = None if parent is None else parent[0]
                rec[3][up] = rec[3].get(up, 0) + 1
                rec[4] = dur

    def span_summary(self) -> Dict[str, dict]:
        """{name: {count, total_s, self_s, parent, parents}} of the spans
        since the last ``reset``, a fresh dict."""
        return {name: dict(count=c, total_s=tot / 1e9, self_s=own / 1e9,
                           parent=max(ups, key=ups.get),
                           parents={k: v for k, v in ups.items()
                                    if k is not None})
                for name, (c, tot, own, ups, _) in self._spans.items()}

    def tally(self, name: str, n: int = 1):
        """Count ``n`` events ``name`` (a host integer: no sync, no
        tensor)."""
        if self.record:
            self._tallies[name] += n

    def tallies(self) -> Dict[str, int]:
        """{name: count} of the tallies since the last ``reset``, a fresh
        dict."""
        return dict(self._tallies)

    def last_s(self, name: str) -> float:
        """Seconds of the last span ``name`` that ended."""
        return self._spans[name][4] / 1e9

    def reset(self):
        self.totals.clear()
        self.counts.clear()
        self._spans.clear()
        self._tallies.clear()


_NO_SPAN = contextlib.nullcontext()
NO_SPANS = PhaseTimer(record=False)


def spanned(fn, spans: PhaseTimer):
    """``fn`` timing itself in ``spans`` where it offers to:
    ``fn.spanned(spans)`` (the re-linearised lqr of
    ``ops.riccati.make_relinearized_lqr``), else ``fn`` itself, unchanged
    (a constant lqr, any other callback, or a recorder that records
    nothing)."""
    make = getattr(fn, "spanned", None)
    return fn if make is None or not spans.record else make(spans)


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
