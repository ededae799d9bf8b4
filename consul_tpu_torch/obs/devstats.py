"""Device & kernel observatory of the port's gossip plane (port of
``consul_tpu/obs/devstats.py`` onto ``torch.cuda``).

A ``DevStats`` rides on the plane (``gossip/plane.py``) and collects:

* **dispatch telemetry** — host-monotonic latency histograms per
  dispatch class (``round_step``, ``sharded_round``, ``multidc_outer``,
  ``drain``) and a rounds/s EWMA refreshed every dispatch.  A dispatch
  ends in a device->host read of its trace, so its latency includes the
  device work;
* **device telemetry** — for the plane's CUDA card: the caching
  allocator's bytes in use and their peak, the card's memory, and the
  live allocations (``torch.cuda.memory_stats`` /
  ``mem_get_info``).  A plane on the CPU reports no device rows;
* **build telemetry** — the wall time of the plane's warm-up work: the
  first-use build of the Hopper kernels (``kernel_build``; a hit when
  the content-hashed library was already built) and the warm-up
  dispatches;
* **a roofline gauge** — bytes a dense round moves times rounds/s over
  the H100 SXM's memory rate.

The bytes are the port's own tail: the Hopper kernel reads the belief
matrix once and writes it once whatever ``dissem`` names, so a dense
round moves ``2 * S * N`` bytes.  There is no lowered cost analysis in
PyTorch, so the byte count's source is always ``"dense"``.

``CONSUL_TPU_DEV_OBS=0`` compiles the observatory out: the plane then
carries ``_dev = None`` and every hook is one attribute-is-None test.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

from consul_tpu_torch.obs.raftstats import LatencyHist

# The memory rate of one NVIDIA H100 SXM (data sheet, 700 W): the
# roofline's ceiling.
HBM_GBPS = 3350.0
# A dense (non-quiescent) round's passes over the [S, N] belief matrix:
# one read and one write by the dissemination kernel.
DENSE_PASSES_PER_ROUND = 2

# Dispatch classes the plane attributes latency to.  ``multidc_outer``
# is reserved for a multi-DC plane; its ladder renders zero-count until
# then so dashboards see the full schema.
DISPATCH_CLASSES: Tuple[str, ...] = ("round_step", "sharded_round",
                                     "multidc_outer", "drain")

_EWMA_ALPHA = 0.2   # rounds/s gauge smoothing per dispatch sample


def enabled() -> bool:
    """Observatory switch: CONSUL_TPU_DEV_OBS=0 compiles it out."""
    return os.environ.get("CONSUL_TPU_DEV_OBS", "1").lower() not in (
        "0", "false", "no")


def dense_bytes_per_round(slots: int, n: int) -> float:
    """Device-memory bytes one dense round's tail moves."""
    return float(DENSE_PASSES_PER_ROUND) * float(slots) * float(n)


def roofline_utilization(bytes_per_round: float, rounds_per_sec: float,
                         ceiling_gbps: float = HBM_GBPS) -> Optional[float]:
    """Achieved memory traffic over the ceiling, as a 0..1 fraction
    (it can exceed 1 when rounds take the quiescent path and skip the
    passes the estimate assumes).  None when either input is unknown or
    zero."""
    if not bytes_per_round or not rounds_per_sec:
        return None
    if bytes_per_round < 0 or rounds_per_sec < 0 or ceiling_gbps <= 0:
        return None
    return (bytes_per_round * rounds_per_sec) / (ceiling_gbps * 1e9)


def device_rows(device) -> List[Dict[str, Any]]:
    """The plane's card as one row: name, the caching allocator's bytes
    in use and their peak, the card's memory, and the live allocations.
    A CPU device reports no rows."""
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return []
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    stats = torch.cuda.memory_stats(idx)
    _free, total = torch.cuda.mem_get_info(idx)
    return [{
        "id": int(idx),
        "platform": "cuda",
        "kind": torch.cuda.get_device_name(idx),
        "hbm_bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "hbm_bytes_peak": int(stats.get("allocated_bytes.all.peak", 0)),
        "hbm_bytes_limit": int(total),
        "live_buffers": int(stats.get("active.all.current", 0)),
        "live_buffer_bytes": int(stats.get("active_bytes.all.current", 0)),
    }]


class DevStats:
    """Per-plane device/kernel observatory (module docstring).  All
    writes happen on the plane's event loop; reads ship over the bridge
    as the ``device`` frame."""

    def __init__(self, device="cpu") -> None:
        self.device = device
        self.dispatch: Dict[str, LatencyHist] = {
            cls: self._hist() for cls in DISPATCH_CLASSES}
        self.rounds_per_sec_ewma = 0.0
        self._ewma_last_t: Optional[float] = None
        self.compile_wall_s: Dict[str, float] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self._slots = 0
        self._n = 0
        # Device rows sampled on the plane's flight-drain cadence.
        self._device_rows: List[Dict[str, Any]] = []
        self._device_sampled_at = 0.0

    @staticmethod
    def _hist() -> LatencyHist:
        return LatencyHist(
            "consul_kernel_dispatch_ms",
            "Host-monotonic dispatch latency by dispatch class, "
            "milliseconds.")

    # -- hot-path hooks ----------------------------------------------------

    def note_dispatch(self, cls: str, ms: float, rounds: int,
                      now: Optional[float] = None) -> None:
        """One completed dispatch of ``rounds`` kernel rounds that took
        ``ms`` host-monotonic milliseconds.  ``rounds > 0`` refreshes the
        rounds/s EWMA from the inter-dispatch wall time (the plane idles
        between ticks, so the in-dispatch rate would overstate it)."""
        h = self.dispatch.get(cls)
        if h is None:
            h = self.dispatch[cls] = self._hist()
        h.observe(ms)
        if rounds <= 0:
            return
        t = time.monotonic() if now is None else now
        if self._ewma_last_t is not None:
            dt = t - self._ewma_last_t
            if dt > 0:
                inst = rounds / dt
                if self.rounds_per_sec_ewma:
                    self.rounds_per_sec_ewma += _EWMA_ALPHA * (
                        inst - self.rounds_per_sec_ewma)
                else:
                    self.rounds_per_sec_ewma = inst
        self._ewma_last_t = t

    def note_drain(self, ms: float) -> None:
        """A flight/hist drain's host transfer completed (the ``drain``
        class; no EWMA contribution)."""
        self.note_dispatch("drain", ms, 0)

    # -- session bookkeeping (cold path) -----------------------------------

    def set_session(self, slots: int, n: int) -> None:
        """The session's [S, N], for the roofline's bytes per round."""
        self._slots = int(slots)
        self._n = int(n)

    def note_compile(self, name: str, wall_s: float,
                     cache_hit: Optional[bool] = None) -> None:
        """Warm-up work ``name`` took ``wall_s`` seconds; ``cache_hit``
        says whether a build was served from the build directory (None:
        no build involved — neither counter moves)."""
        self.compile_wall_s[name] = round(float(wall_s), 3)
        if cache_hit is True:
            self.cache_hits += 1
        elif cache_hit is False:
            self.cache_misses += 1

    def sample_devices(self) -> None:
        """Refresh the cached device rows (the plane calls this on the
        flight-drain cadence and before serving a device query)."""
        self._device_rows = device_rows(self.device)
        self._device_sampled_at = time.time()

    # -- derived roofline ----------------------------------------------------

    def bytes_per_round(self) -> Tuple[Optional[float], str]:
        if self._slots and self._n:
            return dense_bytes_per_round(self._slots, self._n), "dense"
        return None, "unknown"

    def roofline(self) -> Dict[str, Any]:
        bpr, source = self.bytes_per_round()
        util = roofline_utilization(bpr or 0.0, self.rounds_per_sec_ewma)
        return {
            "bytes_per_round": None if bpr is None else round(bpr, 1),
            "bytes_source": source,
            "rounds_per_sec_ewma": round(self.rounds_per_sec_ewma, 2),
            "ceiling_gbps": HBM_GBPS,
            "utilization": None if util is None else round(util, 6),
        }

    # -- read side -----------------------------------------------------------

    def wire(self) -> Dict[str, Any]:
        """The ``device`` frame's payload."""
        if not self._device_rows:
            self.sample_devices()
        return {
            "dispatch": {cls: h.wire()
                         for cls, h in self.dispatch.items()},
            "rounds_per_sec_ewma": round(self.rounds_per_sec_ewma, 2),
            "compile": {
                "wall_s": dict(self.compile_wall_s),
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "cost": {},  # no cost-analysis estimate in PyTorch
            },
            "roofline": self.roofline(),
            "devices": list(self._device_rows),
            "devices_sampled_at": self._device_sampled_at,
        }

    def prom_families(self) -> Tuple[List[Dict[str, Any]],
                                     List[Dict[str, Any]],
                                     List[Dict[str, Any]]]:
        """(histograms, labeled_gauges, labeled_counters) for the scrape.
        Dispatch ladders are always emitted (zero-count included); device
        memory gauges appear only for a card."""
        hists = []
        disp_rows = []
        for cls in sorted(self.dispatch):
            fam = self.dispatch[cls].family()
            fam["labels"] = {"class": cls}
            hists.append(fam)
            disp_rows.append(({"class": cls},
                              float(self.dispatch[cls].count)))
        gauges: List[Dict[str, Any]] = [{
            "name": "consul_kernel_rounds_per_sec",
            "help": "Kernel rounds per second, EWMA over dispatches.",
            "rows": [({}, round(self.rounds_per_sec_ewma, 2))],
        }]
        if self.compile_wall_s:
            gauges.append({
                "name": "consul_kernel_compile_wall_seconds",
                "help": "Warm-up wall time per build or dispatch, seconds.",
                "rows": [({"callable": k}, v) for k, v in
                         sorted(self.compile_wall_s.items())]})
        util = self.roofline()["utilization"]
        if util is not None:
            gauges.append({
                "name": "consul_kernel_roofline_utilization",
                "help": "Achieved device-memory traffic over the H100 "
                        "SXM's 3.35 TB/s, 0..1.",
                "rows": [({}, util)]})
        by_key: Dict[str, List[tuple]] = {}
        for row in self._device_rows:
            labels = {"device": str(row["id"])}
            for key in ("hbm_bytes_in_use", "hbm_bytes_limit",
                        "live_buffers", "live_buffer_bytes"):
                by_key.setdefault(key, []).append((labels, float(row[key])))
        for key, name, help_text in (
                ("hbm_bytes_in_use", "consul_device_hbm_bytes_in_use",
                 "Device memory allocated by the plane, bytes."),
                ("hbm_bytes_limit", "consul_device_hbm_bytes_limit",
                 "Device memory of the card, bytes."),
                ("live_buffers", "consul_device_live_buffers",
                 "Live tensor allocations on the device."),
                ("live_buffer_bytes", "consul_device_live_buffer_bytes",
                 "Bytes of live tensor allocations on the device.")):
            if by_key.get(key):
                gauges.append({"name": name, "help": help_text,
                               "rows": by_key[key]})
        counters: List[Dict[str, Any]] = [
            {"name": "consul_kernel_dispatches_total",
             "help": "Dispatches by dispatch class.",
             "rows": disp_rows},
            {"name": "consul_kernel_compile_cache_hits_total",
             "help": "Kernel builds served from the build directory.",
             "rows": [({}, float(self.cache_hits))]},
            {"name": "consul_kernel_compile_cache_misses_total",
             "help": "Kernel builds that ran nvcc.",
             "rows": [({}, float(self.cache_misses))]},
        ]
        return hists, gauges, counters
