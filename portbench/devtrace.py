"""The device trace of a traced run: ``torch.profiler`` (CPU and CUDA
activities) around the traced replans, reduced at once to what the
per-layer readers read, so no trace is written to disk.

``Trace`` fields: ``window_s`` (host clock around the traced work, which
ends in a synchronise), ``busy_s`` (the union of the intervals in which a
kernel, copy or fill ran on the device), ``kernels`` ({name: [count,
seconds]}, kernels only), ``n_kernels``, ``rounds`` (set by the caller:
the rounds the program's stats report for the traced work),
``device_ops`` and ``idle_gaps`` (the ``breakdown`` of the result line).
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np

_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
_NAME_CHARS = 160


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)
    n_kernels: int = 0
    rounds: int = 0
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _raw_events(prof):
    """(name, is_device, start_us, dur_us) of every event the profiler
    kept, from kineto's list (no event tree is built)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "cuda" in str(e.device_type()).lower()
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            start, dur = float(e.start_us()), float(e.duration_us())
        out.append((e.name(), dev, start, dur))
    return out


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged [start, end) segments of intervals, sorted."""
    order = np.argsort(starts, kind="stable")
    segs = []
    for s, e in zip(starts[order], ends[order]):
        if segs and s <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], e)
        else:
            segs.append([s, e])
    return segs


def reduce(events, window_s: float) -> Trace:
    """A ``Trace`` from raw events (see ``_raw_events``)."""
    tr = Trace(window_s=window_s)
    dev = [e for e in events if e[1]]
    host = [e for e in events if not e[1]]
    if not dev:
        return tr
    ds = np.array([e[2] for e in dev])
    de = ds + np.array([e[3] for e in dev])
    segs = _union(ds, de)
    tr.busy_s = sum(e - s for s, e in segs) / 1e6
    for name, _, _, dur in dev:
        if name.startswith(_COPY_PREFIXES):
            continue
        rec = tr.kernels.setdefault(name, [0, 0.0])
        rec[0] += 1
        rec[1] += dur / 1e6
        tr.n_kernels += 1
    top = sorted(tr.kernels.items(), key=lambda kv: -kv[1][1])[:10]
    tr.device_ops = [[name[:_NAME_CHARS], secs] for name, (_, secs) in top]
    # the longest idle gaps between device work, each named by the
    # innermost host op running at its middle
    lo = min([e[2] for e in host], default=segs[0][0])
    hi = max([e[2] + e[3] for e in host], default=segs[-1][1])
    bounds = [lo] + [x for s in segs for x in s] + [hi]
    gaps = [(bounds[i], bounds[i + 1]) for i in range(0, len(bounds), 2)
            if bounds[i + 1] > bounds[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    hs = np.array([e[2] for e in host]) if host else np.zeros(0)
    hd = np.array([e[3] for e in host]) if host else np.zeros(0)
    for s, e in gaps[:10]:
        mid = 0.5 * (s + e)
        cover = np.flatnonzero((hs <= mid) & (hs + hd >= mid))
        name = ("host, no op" if cover.size == 0
                else host[cover[np.argmin(hd[cover])]][0])
        tr.idle_gaps.append([name[:_NAME_CHARS], (e - s) / 1e6])
    return tr


@contextlib.contextmanager
def capture(out: list):
    """Trace the enclosed work on the card; appends its ``Trace`` to
    ``out`` once the block has ended (the block's work synchronised)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    out.append(reduce(_raw_events(prof), window))
