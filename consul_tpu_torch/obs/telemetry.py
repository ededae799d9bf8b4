"""In-process metrics registry of the port's gossip daemon (the
in-memory interval sink of ``consul_tpu/utils/telemetry.py``, copied:
the daemon configures no statsd sink and no host name).

``obs/flight.py`` folds the drained flight rows into the process-global
``metrics`` as ``consul.flight.*`` counters and gauges.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

DEFAULT_INTERVAL_S = 10.0
DEFAULT_RETAIN = 6  # 6 x 10s = one minute of history


class AggregateSample:
    """Running aggregate of one timer/sample series inside an interval."""

    __slots__ = ("count", "sum", "min", "max", "sumsq")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.sumsq = 0.0

    def ingest(self, v: float) -> None:
        self.count += 1
        self.sum += v
        self.sumsq += v * v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def wire(self) -> Dict[str, float]:
        return {"count": self.count, "sum": round(self.sum, 3),
                "min": round(self.min, 3) if self.count else 0.0,
                "max": round(self.max, 3) if self.count else 0.0,
                "mean": round(self.mean, 3)}


class _Interval:
    __slots__ = ("start", "counters", "gauges", "samples")

    def __init__(self, start: float) -> None:
        self.start = start
        self.counters: Dict[str, AggregateSample] = {}
        self.gauges: Dict[str, float] = {}
        self.samples: Dict[str, AggregateSample] = {}


class InmemSink:
    """Fixed-width interval ring (NewInmemSink role)."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 retain: int = DEFAULT_RETAIN) -> None:
        self.interval_s = interval_s
        self.retain = retain
        self._intervals: List[_Interval] = []

    def _bucket(self, now: float) -> _Interval:
        start = now - (now % self.interval_s)
        if not self._intervals or self._intervals[-1].start != start:
            self._intervals.append(_Interval(start))
            if len(self._intervals) > self.retain:
                del self._intervals[: len(self._intervals) - self.retain]
        return self._intervals[-1]

    def incr_counter(self, name: str, n: float, now: float) -> None:
        b = self._bucket(now)
        b.counters.setdefault(name, AggregateSample()).ingest(n)

    def set_gauge(self, name: str, v: float, now: float) -> None:
        self._bucket(now).gauges[name] = v

    def snapshot(self) -> List[Dict]:
        """JSON-able interval dump (/v1/agent/metrics shape)."""
        out = []
        for iv in self._intervals:
            out.append({
                "Interval": iv.start,
                "Counters": {k: v.wire() for k, v in sorted(iv.counters.items())},
                "Gauges": {k: round(v, 3) for k, v in sorted(iv.gauges.items())},
                "Samples": {k: v.wire() for k, v in sorted(iv.samples.items())},
            })
        return out


class Metrics:
    """The registry call sites hit: dot-joined keys into the in-memory
    interval sink."""

    def __init__(self) -> None:
        self.inmem = InmemSink()
        self._lock = threading.Lock()

    def incr_counter(self, key: Tuple[str, ...], n: float = 1.0) -> None:
        with self._lock:
            self.inmem.incr_counter(".".join(key), n, time.time())

    def set_gauge(self, key: Tuple[str, ...], v: float) -> None:
        with self._lock:
            self.inmem.set_gauge(".".join(key), v, time.time())

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return self.inmem.snapshot()


# The process-global registry.
metrics = Metrics()
