"""End-to-end transition journey ledger (copy of
``consul_tpu/obs/journey.py``, whose docstring explains the nine stages
and the armed-batch protocol).

The gossip plane stamps the first two stages: ``detect`` (the dispatch's
round-start stamp to the plane queueing the member event) and ``drain``
(queued to the ``evbatch`` frame flushed), and carries
``[t_detect, t_flush, detect_ms]`` on each ``evbatch`` event (``jt``
key) for the stages downstream of it, which run in the agents.

``CONSUL_TPU_JOURNEY=0`` compiles the ledger out: the module singleton
``journey`` is then None and every hook is one attribute-is-None test.
Banks are plain-int cumulative counts over ``MS_EDGES``; everything runs
on the daemon's single event loop.
"""

from __future__ import annotations

import os
import time
from bisect import bisect_left
from typing import Any, Dict, List, Optional, Tuple

from consul_tpu_torch.obs import raftstats as _raftstats
from consul_tpu_torch.obs.raftstats import MS_EDGES, LatencyHist
from consul_tpu_torch.obs.slo import SloTracker

# The governing stage enum — table-drift vetted against the prom label
# enumeration in tools/obs_smoke.py and tests/test_journey.py (journey
# stage union group).  Order is pipeline order; it is also the render
# order of the stage-labeled histogram ladder.
STAGES: Tuple[str, ...] = ("detect", "drain", "decode", "enqueue",
                           "submit", "append_quorum", "fsm_apply",
                           "render", "wake")

RECORDS_CAP = 1024        # per-transition journey records retained
DEFAULT_BUDGET_MS = 250.0  # one drain cadence of wall time


def enabled() -> bool:
    """Ledger switch: CONSUL_TPU_JOURNEY=0 compiles it out (every
    hook then short-circuits on ``journey is None``)."""
    return os.environ.get("CONSUL_TPU_JOURNEY", "1").lower() not in (
        "0", "false", "no")


def budget_ms() -> float:
    try:
        return float(os.environ.get("CONSUL_TPU_JOURNEY_BUDGET_MS",
                                    DEFAULT_BUDGET_MS))
    except ValueError:
        return DEFAULT_BUDGET_MS


class JourneyStats:
    """Process-global journey ledger (module docstring)."""

    def __init__(self, budget: Optional[float] = None) -> None:
        self.budget_ms = budget_ms() if budget is None else float(budget)
        self.stage: Dict[str, LatencyHist] = {
            s: LatencyHist(
                "consul_journey_stage_ms",
                "Per-stage transition latency over the fused "
                "membership->catalog path, milliseconds.")
            for s in STAGES
        }
        self.e2e = LatencyHist(
            "consul_journey_e2e_ms",
            "End-to-end transition latency, detection (or injection) "
            "to watcher-visible, milliseconds.")
        self.transitions_total = 0
        self.wakeless_total = 0   # closed without a watcher-wake stamp
        self.aborted_total = 0    # armed batches discarded (submit fail)
        # SLO on the e2e budget: objective = the largest MS_EDGES
        # bucket fully inside the budget (SloTracker speaks bucket
        # indices — "rounds" — so we translate ms edges to indices).
        self._slo_cut = max(0, bisect_left(
            MS_EDGES, self.budget_ms + 1e-9) - 1)
        self.slo = SloTracker(objective_rounds=self._slo_cut)
        self._slo_delta = [0] * (len(MS_EDGES) + 1)
        # Bounded ring of per-transition records, oldest overwritten.
        self._records: List[Dict[str, Any]] = []
        self._rec_next = 0
        # The single in-flight armed batch (one reconcile loop per
        # leader process): None between flushes.
        self._armed: Optional[Dict[str, Any]] = None
        # A closed batch still waiting for its watcher wake: the flush
        # coroutine resumes from the raft ack BEFORE the woken watcher
        # tasks get scheduled, so close() parks the batch here and the
        # first fresh-data long-poll return (or the next arm, as the
        # wakeless fallback) finalizes it.
        self._pending: Optional[Dict[str, Any]] = None

    # -- pipeline-side folds (plane / backend / server hooks) ---------------

    def stage_observe(self, stage: str, ms: float) -> None:
        """Fold one measured stage delta; negative deltas (cross-process
        monotonic clocks) are dropped, not clamped, so the banks only
        ever hold real in-process measurements."""
        if ms >= 0.0:
            self.stage[stage].observe(ms)

    # -- armed-batch protocol (reconcile flush owns the lifecycle) ----------

    def arm(self, records: List[Dict[str, Any]], t_submit: float) -> None:
        """One reconcile flush is in flight: ``records`` are the
        per-member journey dicts riding the batch (keys ``name``,
        ``t0``, ``t_enq``, ``stages``).  A previous batch still parked
        waiting for its wake is finalized wakeless first — its watchers
        never long-polled."""
        if self._pending is not None:
            self._finalize(self._pending, None)
            self._pending = None
        self._armed = {"records": records, "t_submit": t_submit,
                       "quorum_ms": None, "fsm_apply_ms": None,
                       "render_ms": None, "t_wake": None}

    def note_quorum(self, ms: float) -> None:
        """Forwarded from RaftStats.note_commit (the append→quorum
        bank) — folds the consensus stage and binds the armed batch's
        first ack."""
        self.stage_observe("append_quorum", ms)
        a = self._armed
        if a is not None and a["quorum_ms"] is None:
            a["quorum_ms"] = ms

    def note_fsm_apply(self, ms: float) -> None:
        """A BATCH envelope finished its sub-applies on an FSM."""
        self.stage_observe("fsm_apply", ms)
        a = self._armed
        if a is not None and a["fsm_apply_ms"] is None:
            a["fsm_apply_ms"] = ms

    def note_render(self, ms: float) -> None:
        """The batch-boundary health-byte cache re-render completed."""
        self.stage_observe("render", ms)
        a = self._armed
        if a is not None and a["render_ms"] is None:
            a["render_ms"] = ms

    def note_wake(self) -> None:
        """A long-poll returned fresh data.  A parked (closed, not yet
        woken) batch finalizes with this stamp; otherwise the first
        wake after arming binds the in-flight batch — both one branch
        on the hot path."""
        if self._pending is not None:
            p = self._pending
            self._pending = None
            self._finalize(p, time.monotonic())
            return
        a = self._armed
        if a is not None and a["t_wake"] is None:
            a["t_wake"] = time.monotonic()

    def abort(self) -> None:
        """The armed batch's raft submit failed — discard it."""
        if self._armed is not None:
            self._armed = None
            self.aborted_total += 1

    def close(self) -> None:
        """The armed batch's raft submit returned.  If a watcher
        already woke mid-flight the batch finalizes now; otherwise it
        parks until the first fresh-data long-poll return (the flush
        coroutine resumes from the raft ack before the woken watcher
        tasks run) or, failing that, the next arm."""
        a = self._armed
        if a is None:
            return
        self._armed = None
        a["t_close"] = time.monotonic()
        if a["t_wake"] is not None:
            self._finalize(a, a["t_wake"])
        else:
            if self._pending is not None:
                self._finalize(self._pending, None)
            self._pending = a

    def _finalize(self, a: Dict[str, Any],
                  t_wake: Optional[float]) -> None:
        """Fold the batch's submit/wake stages and each member's
        end-to-end latency, push ring records, feed the SLO tracker.
        ``t_wake`` None means no watcher ever woke: the close stamp
        bounds e2e and the batch counts as wakeless."""
        t_submit = a["t_submit"]
        wake_ms = ((t_wake - t_submit) * 1000.0
                   if t_wake is not None else None)
        if wake_ms is not None:
            self.stage_observe("wake", wake_ms)
        else:
            self.wakeless_total += 1
        t_end = t_wake if t_wake is not None else a["t_close"]
        delta = self._slo_delta
        for i in range(len(delta)):
            delta[i] = 0
        for rec in a["records"]:
            submit_ms = (t_submit - rec.get("t_enq", rec["t0"])) * 1000.0
            self.stage_observe("submit", submit_ms)
            e2e_ms = max(0.0, (t_end - rec["t0"]) * 1000.0)
            self.e2e.observe(e2e_ms)
            delta[min(bisect_left(MS_EDGES, e2e_ms), len(MS_EDGES))] += 1
            self.transitions_total += 1
            stages = dict(rec.get("stages") or {})
            stages["submit"] = round(submit_ms, 3)
            if a["quorum_ms"] is not None:
                stages["append_quorum"] = round(a["quorum_ms"], 3)
            if a["fsm_apply_ms"] is not None:
                stages["fsm_apply"] = round(a["fsm_apply_ms"], 3)
            if a["render_ms"] is not None:
                stages["render"] = round(a["render_ms"], 3)
            if wake_ms is not None:
                stages["wake"] = round(wake_ms, 3)
            self._record({"name": rec.get("name", ""),
                          "wall": time.time(),
                          "e2e_ms": round(e2e_ms, 3),
                          "stages": stages})
        self.slo.observe(delta)

    def _record(self, row: Dict[str, Any]) -> None:
        if len(self._records) < RECORDS_CAP:
            self._records.append(row)
        else:
            self._records[self._rec_next] = row
            self._rec_next = (self._rec_next + 1) % RECORDS_CAP

    # -- read side ----------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        """Retained per-transition records, oldest first."""
        if len(self._records) < RECORDS_CAP:
            return list(self._records)
        return (self._records[self._rec_next:]
                + self._records[:self._rec_next])

    def e2e_quantile_records(self, q: float) -> Optional[float]:
        """Exact quantile over the retained records' raw e2e values —
        the bench/test comparison path (bucket-edge quantiles can't hit
        a ±20% agreement bar; raw samples can)."""
        vals = sorted(r["e2e_ms"] for r in self._records)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(q * len(vals)))]

    def stage_sums(self) -> Dict[str, float]:
        """Per-stage cumulative milliseconds — the chaos detectability
        gate diffs these across the fault window."""
        return {s: round(self.stage[s]._sum, 3) for s in STAGES}

    def families(self) -> Tuple[List[Dict[str, Any]],
                                List[Dict[str, Any]]]:
        """(histograms, labeled_counters) for the scrape.  One
        stage-labeled histogram ladder (every stage's labelset always
        emitted, zeros included, sharing one HELP/TYPE block) plus the
        unlabeled e2e family and the transition counters."""
        hists = []
        for s in STAGES:
            fam = self.stage[s].family()
            fam["labels"] = {"stage": s}
            hists.append(fam)
        hists.append(self.e2e.family())
        counters = [
            {"name": "consul_journey_transitions_total",
             "help": "Member transitions closed through the journey "
                     "ledger, by outcome.",
             "rows": [({"outcome": "visible"}, float(
                          self.transitions_total)),
                      ({"outcome": "aborted"}, float(
                          self.aborted_total))]},
            {"name": "consul_journey_wakeless_total",
             "help": "Journey batches closed without observing a "
                     "watcher-wake signal.",
             "rows": [({}, float(self.wakeless_total))]},
        ]
        return hists, counters

    def wire(self, recent: int = 32) -> Dict[str, Any]:
        """JSON payload of /v1/operator/journey (and the debug-bundle
        journey/telemetry.json member)."""
        return {
            "enabled": True,
            "budget_ms": self.budget_ms,
            "stages": {s: self.stage[s].wire() for s in STAGES},
            "e2e": self.e2e.wire(),
            "e2e_records_p99_ms": self.e2e_quantile_records(0.99),
            "slo": self.slo.snapshot(),
            "transitions_total": self.transitions_total,
            "wakeless_total": self.wakeless_total,
            "aborted_total": self.aborted_total,
            "records": self.records()[-max(0, int(recent)):],
        }

    def reset(self) -> None:
        """Zero every bank/ring (bench legs isolate measurements)."""
        self.__init__(budget=self.budget_ms)
        _install(self)


def disabled_wire() -> Dict[str, Any]:
    """Route/bundle shell when the ledger is compiled out."""
    return {"enabled": False, "budget_ms": budget_ms()}


def _install(j: Optional["JourneyStats"]) -> None:
    """Point the raftstats forward sink at the live ledger (raftstats
    can't import this module — it would be a cycle — so the sink is a
    module attribute over there that we own)."""
    _raftstats.journey_sink = j


# Process-global ledger, mirroring obs.raftstats.aestats: one agent (or
# one in-process test cluster) per process; call sites go through the
# module attribute so tests can swap it.  None when compiled out.
journey: Optional[JourneyStats] = JourneyStats() if enabled() else None
_install(journey)
