"""The millisecond latency histogram the port's observatories share
(``LatencyHist`` and ``MS_EDGES``, copied from
``consul_tpu/obs/raftstats.py``; the consensus plane's ``RaftStats``
stays in the JAX package's host plane).

``obs/devstats.py`` keeps its dispatch latencies in these banks and
``obs/journey.py`` its stage latencies.  Banks are plain Python ints
(never wrap); everything runs on the daemon's single event loop.
"""

from __future__ import annotations

from bisect import bisect_left
from typing import Any, Dict, Optional, Tuple

# Millisecond bucket ladder shared by every latency histogram.
# Cumulative counts over these edges render directly as a Prometheus
# histogram family.
MS_EDGES: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
                               50.0, 100.0, 250.0, 500.0, 1000.0, 2500.0)

# Forward sink for the journey ledger (obs/journey.py sets it when it is
# imported; this module cannot import that one, it would be a cycle).
journey_sink: Optional[Any] = None


def _le(edge: float) -> str:
    return str(int(edge)) if edge == int(edge) else repr(edge)


class LatencyHist:
    """Fixed-edge cumulative millisecond histogram.

    ``observe(ms, n=1)`` is the only write; banks are plain ints so a
    bucket legitimately holding more than 2**32 observations stays
    exact (the wrap-aware HistRecorder contract, minus the device
    drain).
    """

    __slots__ = ("name", "help", "edges", "_counts", "_sum", "_count")

    def __init__(self, name: str, help_text: str,
                 edges: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.help = help_text
        # Custom edges let non-latency distributions reuse the same
        # bank/render machinery.
        self.edges = MS_EDGES if edges is None else tuple(edges)
        self._counts = [0] * len(self.edges)
        self._sum = 0.0
        self._count = 0

    def observe(self, ms: float, n: int = 1) -> None:
        self._count += n
        self._sum += ms * n
        i = bisect_left(self.edges, ms)
        if i < len(self._counts):
            self._counts[i] += n
        # else: overflow — counted only by the +Inf bucket (count)

    @property
    def count(self) -> int:
        return self._count

    def family(self) -> Dict[str, Any]:
        """obs/prom.py ``histograms=`` family shape."""
        cum = 0
        buckets = []
        for edge, c in zip(self.edges, self._counts):
            cum += c
            buckets.append((_le(edge), cum))
        return {"name": self.name, "help": self.help, "buckets": buckets,
                "sum": round(self._sum, 3), "count": self._count}

    def quantile_ms(self, q: float) -> Optional[float]:
        """Upper bucket edge covering quantile ``q`` (None until data;
        observations past the last edge report that edge — an
        operator-facing bound, not an exact percentile)."""
        if self._count == 0:
            return None
        need = q * self._count
        cum = 0
        for edge, c in zip(self.edges, self._counts):
            cum += c
            if cum >= need:
                return edge
        return self.edges[-1]

    def wire(self) -> Dict[str, Any]:
        return {"count": self._count, "sum_ms": round(self._sum, 3),
                "p50_ms": self.quantile_ms(0.50),
                "p99_ms": self.quantile_ms(0.99)}
