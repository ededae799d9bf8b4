"""Rolling SLO burn-rate tracking over the detection-latency bank (copy
of ``consul_tpu/obs/slo.py``).

The plane feeds every drained ``detect``-bank delta (``obs/hist.py``)
into a ``SloTracker`` whose objective is a detection latency in rounds;
the tracker keeps cumulative attainment, windowed attainment over the
last ``window`` non-empty drains, and the burn rate ``(1 - windowed
attainment) / (1 - target)``.  ``SloBoard`` keeps one tracker per
scenario label.  Pure Python.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, Optional, Sequence

DEFAULT_WINDOW_DRAINS = 32


class SloTracker:
    """Attainment/burn-rate over per-drain detection-latency deltas.

    ``objective_rounds``: detections at <= this latency (in rounds) are
    within SLO.  ``attainment_target``: the objective's target fraction
    (0.99 = "99% of detections within the bound").
    """

    def __init__(self, objective_rounds: int,
                 attainment_target: float = 0.99,
                 window: int = DEFAULT_WINDOW_DRAINS) -> None:
        if objective_rounds < 0:
            raise ValueError("objective_rounds must be >= 0")
        if not 0.0 < attainment_target < 1.0:
            raise ValueError("attainment_target must be in (0, 1)")
        self.objective_rounds = int(objective_rounds)
        self.attainment_target = float(attainment_target)
        self._lock = threading.Lock()
        # (n_total, n_within) per non-empty drain, newest last.
        self._window: "deque[tuple]" = deque(maxlen=max(1, int(window)))
        self._total = 0
        self._within = 0

    def observe(self, detect_delta: Sequence[int]) -> int:
        """Fold one drained delta of the detect bank (per-bucket new
        observation counts; bucket i = latency i rounds).  Returns the
        number of new detections consumed."""
        counts = [int(c) for c in detect_delta]
        n = sum(counts)
        if n <= 0:
            return 0
        cut = min(self.objective_rounds + 1, len(counts))
        within = sum(counts[:cut])
        with self._lock:
            self._total += n
            self._within += within
            self._window.append((n, within))
        return n

    # -- read side ----------------------------------------------------------

    def _attainment(self, total: int, within: int) -> Optional[float]:
        return None if total == 0 else within / total

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            total, within = self._total, self._within
            wt = sum(n for n, _ in self._window)
            ww = sum(w for _, w in self._window)
        att = self._attainment(total, within)
        watt = self._attainment(wt, ww)
        burn = 0.0
        if watt is not None:
            burn = (1.0 - watt) / (1.0 - self.attainment_target)
        return {
            "objective_rounds": self.objective_rounds,
            "attainment_target": self.attainment_target,
            "detections": total,
            "attainment": att,
            "window_detections": wt,
            "window_attainment": watt,
            "burn_rate": burn,
        }


class SloBoard:
    """Per-scenario SLO trackers sharing one objective.

    The nemesis observatory (gossip/nemesis.py) attributes every
    drained detection delta to the scenario active when it was
    observed; the board keeps an independent ``SloTracker`` per label
    so each failure mode gets its own attainment + burn-rate readout
    (``/v1/agent/slo`` ``scenarios`` key).  Trackers are created
    lazily on first observation — a scenario that never detected
    anything is absent, not a zero row."""

    def __init__(self, objective_rounds: int,
                 attainment_target: float = 0.99,
                 window: int = DEFAULT_WINDOW_DRAINS) -> None:
        self._objective = int(objective_rounds)
        self._target = float(attainment_target)
        self._window = int(window)
        self._lock = threading.Lock()
        self._trackers: Dict[str, SloTracker] = {}

    def observe(self, scenario: str, detect_delta: Sequence[int]) -> int:
        if not scenario:
            return 0
        with self._lock:
            tr = self._trackers.get(scenario)
            if tr is None:
                tr = self._trackers[scenario] = SloTracker(
                    self._objective, self._target, self._window)
        return tr.observe(detect_delta)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            trackers = dict(self._trackers)
        return {scn: tr.snapshot() for scn, tr in sorted(trackers.items())}
