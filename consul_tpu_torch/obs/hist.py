"""Detection-latency histograms, host side (copy of
``consul_tpu/obs/hist.py``, whose docstring explains the banks).

The round accumulates cumulative int32 banks on the device
(``HistBank``: ``detect``, ``dwell``, ``refute``, ``spread``); the plane
drains them on its flight cadence into ``HistRecorder``, which takes the
per-drain deltas modulo 2**32 (the device banks wrap) into host-side
int64 banks that never wrap, and serves exact percentiles and Prometheus
histogram families from them.  Bucket layouts are
``obs/constants.py``'s.  Pure numpy; ``tests/test_torch_isolation.py``
holds it to the reference's output on the same banks.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from consul_tpu_torch.obs.constants import LATENCY_BUCKETS, SPREAD_BUCKETS  # noqa: F401

# Bank name -> (metric name, help text).  Order = exposition order.
BANK_METRICS = {
    "detect": ("consul.swim.detection_latency_rounds",
               "Rounds from a node's failure to its dead verdict firing."),
    "dwell": ("consul.swim.suspicion_dwell_rounds",
              "Rounds a suspicion episode stayed open before its verdict "
              "(dead or refuted)."),
    "refute": ("consul.swim.refutation_latency_rounds",
               "Rounds from episode start to the subject's refutation."),
    "spread": ("consul.swim.spread_members",
               "Members holding an episode's verdict when its slot was "
               "recycled (log2 buckets)."),
}
_LATENCY_BANKS = ("detect", "dwell", "refute")

# Exposed `le` edges: powers of two for the one-round latency banks
# (the fine 256-bucket bank collapses exactly onto them), bit_length
# boundaries for the spread bank.  Each edge maps to the last fine
# bucket it covers (le >= means cum = counts[:idx+1].sum()).
_LATENCY_EDGES = [1, 2, 4, 8, 16, 32, 64, 128]
_SPREAD_EDGES = [(str(2 ** k - 1), k) for k in range(1, SPREAD_BUCKETS)]


def _edges(name: str) -> List[tuple]:
    if name == "spread":
        return [("0", 0)] + _SPREAD_EDGES
    return [(str(e), e) for e in _LATENCY_EDGES]


class HistRecorder:
    """Host-side sink for drained histogram banks.

    ``ingest(banks)`` takes a dict of bank name -> cumulative bucket
    counts (any array-like of ints, straight off the device), computes
    the per-drain deltas modulo 2**32 (the device banks are int32 and
    wrap — module docstring), folds them into a host-side int64
    cumulative view that never wraps, and returns the deltas (new
    observations since the previous drain) for the SLO tracker.

    A shape change (bank layout reconfigured) resets that bank's
    history; a recorder must otherwise live exactly as long as the
    device banks it drains (the plane creates both together).
    """

    _WRAP = np.int64(2) ** 32

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._banks: Dict[str, np.ndarray] = {}   # true cumulative, i64
        self._raw: Dict[str, np.ndarray] = {}     # last device view, u32

    # -- drain path ---------------------------------------------------------

    def ingest(self, banks: Dict[str, Sequence[int]],
               scenario: Optional[str] = None) -> Dict[str, np.ndarray]:
        """``scenario``: attribute this drain's deltas to a nemesis
        scenario (gossip/nemesis.py) as well — the deltas additionally
        fold into ``"<name>@<scenario>"`` banks, which ``families()``
        exposes as scenario-labeled Prometheus series and the SLO board
        reads per scenario.  The wrap bookkeeping (``_raw``) stays
        keyed by the bare bank name: there is ONE physical device bank
        regardless of which scenario is active when it drains."""
        deltas: Dict[str, np.ndarray] = {}
        with self._lock:
            for name, counts in banks.items():
                # reduce the device view to its 32 low bits so int32
                # (possibly negative after a wrap) and uint32 inputs
                # difference identically
                cur = np.asarray(counts, dtype=np.int64) & (self._WRAP - 1)
                prev = self._raw.get(name)
                if prev is None or prev.shape != cur.shape:
                    prev = np.zeros_like(cur)
                    self._banks[name] = np.zeros_like(cur)
                delta = (cur - prev) % self._WRAP
                deltas[name] = delta
                self._raw[name] = cur
                self._banks[name] = self._banks[name] + delta
                if scenario:
                    key = f"{name}@{scenario}"
                    bank = self._banks.get(key)
                    if bank is None or bank.shape != delta.shape:
                        bank = np.zeros_like(delta)
                    self._banks[key] = bank + delta
        return deltas

    # -- read side ----------------------------------------------------------

    def counts(self, name: str) -> np.ndarray:
        with self._lock:
            bank = self._banks.get(name)
            return (np.array([], dtype=np.int64) if bank is None
                    else bank.copy())

    def percentile(self, name: str, q: float) -> Optional[float]:
        """Exact percentile over the recorded multiset (one-round-wide
        buckets; overflow-bucket observations count at the bucket floor).
        Linear interpolation — identical to crossval's ``pct``, computed
        from cumulative counts without materializing the multiset (the
        wrap-aware banks legitimately exceed 2**31 observations)."""
        counts = self.counts(name)
        total = int(counts.sum())
        if total == 0:
            return None
        cum = np.cumsum(counts)
        # np.percentile 'linear': rank q/100*(n-1) = k + f; the value at
        # sorted index i is the first bucket whose cumulative count
        # exceeds i
        rank = (q / 100.0) * (total - 1)
        lo_i = int(np.floor(rank))
        hi_i = int(np.ceil(rank))
        lo = int(np.searchsorted(cum, lo_i, side="right"))
        hi = int(np.searchsorted(cum, hi_i, side="right"))
        return float(lo + (hi - lo) * (rank - lo_i))

    def scenarios(self) -> List[str]:
        """Sorted nemesis scenario labels with attributed banks."""
        with self._lock:
            return sorted({k.split("@", 1)[1] for k in self._banks
                           if "@" in k})

    @staticmethod
    def _one_family(name: str, metric: str, help_text: str,
                    counts: np.ndarray,
                    labels: Optional[Dict[str, str]]) -> Dict[str, Any]:
        cum = np.cumsum(counts)
        buckets = [(le, int(cum[min(idx, len(cum) - 1)]))
                   for le, idx in _edges(name)]
        if name == "spread":
            # bit_length buckets: value floor of bucket k is 2^(k-1)
            floors = np.concatenate(
                [[0], 2 ** np.arange(counts.shape[0] - 1)])
            total_sum = int((counts * floors).sum())
        else:
            total_sum = int((counts * np.arange(counts.shape[0])).sum())
        fam: Dict[str, Any] = {
            "name": metric,
            "help": help_text,
            "buckets": buckets,
            "sum": total_sum,
            "count": int(counts.sum()),
        }
        if labels:
            fam["labels"] = dict(labels)
        return fam

    def families(self) -> List[Dict[str, Any]]:
        """Prometheus histogram families over the cumulative banks.

        ``sum`` is exact below the overflow bucket; overflow
        observations contribute the bucket floor (a lower bound).

        Scenario-attributed banks (``ingest(..., scenario=...)``) emit
        additional families with the SAME metric name and a
        ``{"scenario": ...}`` label set, right after their unlabeled
        aggregate (obs/prom.py emits HELP/TYPE once per name)."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            banks = {n: b.copy() for n, b in self._banks.items()}
        scns = sorted({k.split("@", 1)[1] for k in banks if "@" in k})
        for name, (metric, help_text) in BANK_METRICS.items():
            counts = banks.get(name)
            if counts is None:
                continue
            out.append(self._one_family(name, metric, help_text, counts,
                                        None))
            for scn in scns:
                sc_counts = banks.get(f"{name}@{scn}")
                if sc_counts is not None:
                    out.append(self._one_family(
                        name, metric, help_text, sc_counts,
                        {"scenario": scn}))
        return out

    def summary(self, scenario: Optional[str] = None) -> Dict[str, Any]:
        """Latency percentiles for /v1/agent/slo (None until data).
        ``scenario``: read the scenario-attributed banks instead of the
        aggregate."""
        suffix = f"@{scenario}" if scenario else ""
        s: Dict[str, Any] = {}
        for name in _LATENCY_BANKS:
            key = name + suffix
            s[name] = {
                "count": int(self.counts(key).sum()),
                "p50_rounds": self.percentile(key, 50),
                "p99_rounds": self.percentile(key, 99),
            }
        return s
