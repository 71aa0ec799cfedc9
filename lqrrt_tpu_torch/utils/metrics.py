"""Structured per-replan metrics with pluggable sinks (port of
lqrrt_tpu/utils/metrics.py, which imports no JAX; kept as its own copy).

The reference's only observability is ``printing=True`` progress prints.
Here every ``update_plan`` emits one structured record (nodes, rounds,
expansions/s, latency, goal flag, plan length) to any sink: stdout, JSONL
file, or an in-memory buffer for tests/aggregation.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional


class JsonlSink:
    """Append one JSON object per replan to a file (thread-safe)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def __call__(self, record: Dict):
        line = json.dumps(record, default=float)
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class StdoutSink:
    def __call__(self, record: Dict):
        print(json.dumps(record, default=float), flush=True)


class BufferSink:
    """Keeps records in memory; offers simple aggregation (p50/p99)."""

    def __init__(self):
        self.records: List[Dict] = []
        self._lock = threading.Lock()

    def __call__(self, record: Dict):
        with self._lock:
            self.records.append(record)

    def percentile(self, field: str, q: float) -> float:
        import numpy as np
        vals = [r[field] for r in self.records if field in r]
        if not vals:
            return float("nan")
        return float(np.percentile(np.asarray(vals, float), q))

    def summary(self) -> Dict:
        return dict(
            replans=len(self.records),
            goal_rate=(sum(bool(r.get("goal_found")) for r in self.records)
                       / max(len(self.records), 1)),
            p50_latency_s=self.percentile("total_s", 50),
            p99_latency_s=self.percentile("total_s", 99),
            p50_expansions_per_s=self.percentile("expansions_per_s", 50),
        )


def attach(planner, *sinks: Callable[[Dict], None],
           clock: Optional[Callable[[], float]] = None):
    """Wire sinks to a Planner: each update_plan emits one stamped record.

    Returns the composite hook (also stored as ``planner.on_replan``).
    """
    clock = clock or time.time
    seq = {"n": 0}

    def hook(stats: Dict):
        record = dict(stats)
        record["ts"] = clock()
        record["replan_seq"] = seq["n"]
        seq["n"] += 1
        for sink in sinks:
            sink(record)

    planner.on_replan = hook
    return hook
