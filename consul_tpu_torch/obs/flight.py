"""SWIM flight recorder, host side (copy of ``consul_tpu/obs/flight.py``).

The round (``consul_tpu_torch/gossip/kernel.py``) writes one row of
per-round counters into a small device ring (``FlightRing``); the gossip
plane drains the ring every ``flight_drain_every`` dispatches with one
device->host copy and hands the rows to the ``FlightRecorder`` here,
which keeps a bounded host-side timeline for the ``flight`` bridge frame
and folds deltas into the process registry (``obs/telemetry.py``) as
``consul.flight.*`` counters and gauges.  Pure Python;
``tests/test_torch_isolation.py`` holds it to the reference's output on
the same rows.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

from consul_tpu_torch.obs.constants import FLIGHT_COLS, N_COLS  # noqa: F401

# Columns folded into the registry as monotonic counters (per-round
# deltas summed over the drained window) vs. sampled gauges (last row).
_COUNTER_COLS = ("probes", "acks_missed", "indirect_probes", "suspect_new",
                 "alive_events", "dead_events", "dissem_bytes", "drops")
_GAUGE_COLS = ("round", "join_rumors", "queue_occupancy", "members")

TIMELINE_ROWS = 4096  # bounded host-side history for /v1/agent/flight


def fold_summary(metrics: Any, summary: Dict[str, Any]) -> None:
    """Mirror a REMOTE recorder's ``wire()["summary"]`` into a local
    registry as ``consul.flight.*`` gauges.

    The recorder proper lives in the gossip-plane process and folds
    into *that* process's registry; the agent calls this at scrape
    time (``/v1/agent/metrics?format=prometheus``) so its exposition
    carries the flight series too.  Everything is a gauge here — the
    counter columns arrive as cumulative totals, and re-counting them
    locally would double-book deltas across the two processes."""
    for c in FLIGHT_COLS + ("rows_recorded", "rows_overflowed"):
        if c in summary:
            metrics.set_gauge(("consul", "flight", c), summary[c])


class FlightRecorder:
    """Host-side sink for drained flight rings.

    ``ingest(rows, cursor)`` takes the full ring (shape [R, N_COLS],
    any array-like of ints) plus the kernel's monotonically increasing
    write cursor, extracts only the rows written since the previous
    drain (in write order, handling wraparound), and accounts for
    overflow when more than R rounds elapsed between drains.
    """

    def __init__(self, metrics: Optional[Any] = None) -> None:
        if metrics is None:
            from consul_tpu_torch.obs.telemetry import metrics as _global
            metrics = _global
        self._metrics = metrics
        self._lock = threading.Lock()
        self._timeline: "deque[Dict[str, int]]" = deque(maxlen=TIMELINE_ROWS)
        self._totals: Dict[str, int] = {c: 0 for c in _COUNTER_COLS}
        self._last: Dict[str, int] = {}
        self._last_cursor = 0
        self._overflowed = 0  # rows lost to ring wrap between drains

    @property
    def last_cursor(self) -> int:
        """Kernel cursor as of the last drain (lets the drainer skip a
        device sync when nothing new was written)."""
        with self._lock:
            return self._last_cursor

    # -- drain path ---------------------------------------------------------

    def ingest(self, rows: Sequence[Sequence[int]], cursor: int) -> int:
        """Fold one drained ring into the timeline/registry.  Returns
        the number of new rows consumed."""
        cursor = int(cursor)
        ring_len = len(rows)
        dropped = 0
        with self._lock:
            new = cursor - self._last_cursor
            if new <= 0 or ring_len == 0:
                self._last_cursor = max(cursor, self._last_cursor)
                return 0
            if new > ring_len:
                # Rows overwritten before this drain: counted, never
                # silently lost (consul.flight.dropped).
                dropped = new - ring_len
                self._overflowed += dropped
                new = ring_len
            # Ring order: the kernel writes row i at slot i % R, so the
            # oldest retained row sits at slot (cursor - new) % R.
            start = (cursor - new) % ring_len
            picked: List[Dict[str, int]] = []
            for k in range(new):
                raw = rows[(start + k) % ring_len]
                picked.append({c: int(raw[j])
                               for j, c in enumerate(FLIGHT_COLS)})
            for rec in picked:
                self._timeline.append(rec)
                for c in _COUNTER_COLS:
                    self._totals[c] += rec[c]
            self._last = dict(picked[-1])
            self._last_cursor = cursor
            window = {c: sum(r[c] for r in picked) for c in _COUNTER_COLS}
            last = self._last
        # Registry updates outside the lock (sinks may do I/O: statsd).
        for c in _COUNTER_COLS:
            if window[c]:
                self._metrics.incr_counter(("consul", "flight", c), window[c])
        for c in _GAUGE_COLS:
            self._metrics.set_gauge(("consul", "flight", c), last[c])
        if dropped:
            self._metrics.incr_counter(("consul", "flight", "dropped"),
                                       dropped)
        if self._overflowed:
            self._metrics.set_gauge(("consul", "flight", "overflowed"),
                                    self._overflowed)
        return len(picked)

    # -- read side ----------------------------------------------------------

    def timeline(self, limit: int = 256) -> List[Dict[str, int]]:
        """Most recent per-round rows, oldest first."""
        with self._lock:
            out = list(self._timeline)
        return out[-max(0, int(limit)):]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            # Gauge columns from the last row; counter columns are the
            # all-time totals (the last row's per-round delta must not
            # shadow them).
            s: Dict[str, Any] = {c: self._last.get(c, 0)
                                 for c in _GAUGE_COLS}
            s.update(self._totals)
            s["rows_recorded"] = self._last_cursor
            s["rows_overflowed"] = self._overflowed
            return s

    def wire(self, limit: int = 256) -> Dict[str, Any]:
        """Bridge/HTTP payload for /v1/agent/flight."""
        rows = self.timeline(limit)
        return {"cols": list(FLIGHT_COLS),
                "rows": [[r[c] for c in FLIGHT_COLS] for r in rows],
                "summary": self.summary()}
