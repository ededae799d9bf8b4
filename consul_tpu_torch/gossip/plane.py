"""The gossip plane daemon on the port: the SWIM round as a real
membership backend, served from the CUDA card.

Port of ``consul_tpu/gossip/plane.py``, whose docstring describes the
graft: agents configured with ``gossip_backend=tpu`` delegate their LAN
membership to this daemon over the bridge wire.

- **Membership state lives in the round's tensors.**  Every registered
  agent is a node id in the SWIM universe
  (``consul_tpu_torch/gossip/kernel.py``): probe outcomes, suspicion,
  Lifeguard timeouts, dissemination, refutation and the dead verdict run
  on the device, optionally beside simulated nodes in the same tensors
  (``sim_nodes``).  The dense dissemination tail is the Hopper kernel
  ``fused_dissem`` (one column shard) or ``fused_merge``
  (``shard_devices`` > 1).
- **The physical liveness signal is the bridge heartbeat.**  A lapsed
  agent starts failing probes; everything above that signal is round
  dynamics, not host code.
- **Events flow out the serf boundary.**  Membership transitions and
  user events stream to every connected agent.

Under the same key the plane is bit-identical to the reference's: the
same ``SwimState``, ``EventState``, ``FlightRing``, ``HistBank`` and,
under a nemesis scenario, ``NemState`` after every dispatch, and
byte-identical bridge frames (``tests/test_torch_plane.py``).

Wire protocol (shared with the agents' C++ bridge): 4-byte big-endian
length + msgpack map.  Client->plane: register / hb / leave / force-leave / tags / event /
members / stats / flight / slo / device / autotune / profile.
Plane->client: welcome snapshot, pushed membership events (``ev``,
``evbatch``), pushed user events, query replies.

Security posture: TRUSTED NETWORK ASSUMED for non-loopback binds, as in
the reference.  An armed keyring (``encrypt_keys``) gates admission
(registration requires an HMAC proof, :func:`registration_proof`) but
does not encrypt the stream, and the registration replay cache is in
memory only (a restart reopens a replay window of up to
``auth_skew_s``).

Device: ``PlaneConfig.device`` (None = the CUDA card; ``"cpu"`` is the
only way onto the CPU).  ``PlaneConfig.nemesis`` runs the round under a
scenario of the nemesis catalog (``gossip/nemesis.py``): its injection
schedule in every round, its kills folded into the dispatch's fail
rounds, and its detections attributed to it in the observatory.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import hmac
import os
import struct
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

import msgpack
import numpy as np
import torch

from consul_tpu_torch import prng
from consul_tpu_torch._device import resolve_device
from consul_tpu_torch.gossip.kernel import NEVER
from consul_tpu_torch.obs import journey as _journey

EV_JOIN = "member-join"
EV_LEAVE = "member-leave"
EV_FAILED = "member-failed"
EV_UPDATE = "member-update"
EV_USER = "user"

# Fixed rounds per dispatch; wall-clock catch-up runs several dispatches.
STEPS_PER_TICK = 4

# Drain the device flight ring every this many dispatches (64 rounds per
# host transfer at STEPS_PER_TICK=4).  Must stay <= the ring length /
# STEPS_PER_TICK or rows overflow (overflow is counted by obs.flight).
FLIGHT_DRAIN_EVERY = 16


@dataclass
class PlaneConfig:
    bind_addr: str = "127.0.0.1"
    bind_port: int = 8310          # the plane's rendezvous port
    unix_path: str = ""            # serve on a unix socket instead
    capacity: int = 1024           # real-agent universe size (node ids)
    sim_nodes: int = 0             # extra simulated nodes sharing the arrays
    gossip_interval_s: float = 0.2  # kernel round length in wall time
    probe_every: int = 5
    suspicion_mult: float = 4.0
    # heartbeat lapse after which an agent starts failing kernel probes;
    # the default heartbeat period the plane hands to clients is lapse/3.
    hb_lapse_s: float = 2.0
    slots: int = 64
    # Gossip keyring (base64 keys, the agents' encrypt key format).
    # Non-empty => registration requires an HMAC proof derived from an
    # installed key (registration_proof).
    encrypt_keys: List[str] = field(default_factory=list)
    auth_skew_s: float = 30.0      # accepted |now - auth_ts| window
    # Left-name tombstone window (serf's TombstoneTimeout default, 24h).
    tombstone_timeout_s: float = 24 * 3600.0
    # Concurrent user-event slots in the event flood (gossip/events.py).
    event_slots: int = 64
    # Column shards the SWIM round runs on, all on the plane's device.
    # 1 = single shard; >1 = explicit (start() raises if the universe is
    # not divisible by shard_devices and probe_every); 0 = one shard per
    # CUDA card when the alignment constraints hold, else 1; -1 =
    # resolve through a persisted autotune verdict (obs/tuner.py), a
    # misaligned verdict degrading to 1 instead of raising.
    shard_devices: int = -1
    # Detection-latency SLO objective in kernel rounds (obs/slo.py).
    # 0 = auto: the worst-case Lifeguard suspicion window plus one
    # probe-selection period.
    slo_objective_rounds: int = 0
    slo_attainment_target: float = 0.99
    # Nemesis scenario to run the round under (gossip/nemesis.py catalog
    # name; "" = none): its injection schedule runs in every round, its
    # kills merge into the dispatch's fail rounds, and every drained
    # histogram delta is attributed to the scenario (the slo frame's
    # ``scenario`` and ``scenarios``).
    nemesis: str = ""
    # Autotuned knobs (obs/tuner.py): each defaults to an AUTO sentinel
    # that resolves at start() (explicit config value > verdict >
    # registry default).
    dissem: str = ""               # SwimParams.dissem; "" = auto
    hot_slots: int = -1            # SwimParams.hot_slots; -1 = auto
    fused_nb: int = 0              # SwimParams.fused_nb; 0 = auto
    unroll: int = 0                # the reference's scan unroll; 0 = auto
    flight_drain_every: int = 0    # dispatches between drains; 0 = auto
    # The torch device of the session: None = the CUDA card, which must
    # be present; "cpu" runs it on the CPU.
    device: Optional[str] = None


# PlaneConfig knobs resolved through the autotune verdict.
TUNED_FIELDS = ("dissem", "hot_slots", "fused_nb", "shard_devices",
                "unroll", "flight_drain_every")

# The per-field AUTO sentinel (the dataclass default): any other value
# is an explicit operator setting and skips the verdict.
_TUNED_AUTO = {"dissem": "", "hot_slots": -1, "fused_nb": 0,
               "shard_devices": -1, "unroll": 0, "flight_drain_every": 0}


@dataclass
class PlaneNode:
    """Host-side metadata for one registered node id."""

    id: int
    name: str
    addr: str = ""
    port: int = 0
    tags: Dict[str, str] = field(default_factory=dict)
    last_hb: float = 0.0
    writer: Optional[asyncio.StreamWriter] = None
    # lifecycle the AGENTS should believe (derived from kernel verdicts)
    status: str = "alive"          # alive | failed | left
    left_at: float = 0.0           # monotonic time the node went "left"


def registration_proof(key_b64: str, name: str, addr: str, port: int,
                       ts: int, nonce: bytes,
                       tags: Optional[Dict[str, str]] = None) -> bytes:
    """HMAC proof binding a registration to the gossip keyring: the MAC
    covers every register field, msgpack-canonicalized (length-prefixed,
    never joined with in-band delimiters)."""
    msg = msgpack.packb(
        ["consul-tpu-plane-register", name, addr, int(port), int(ts),
         nonce, sorted((tags or {}).items())], use_bin_type=True)
    return hmac.new(base64.b64decode(key_b64), msg,
                    hashlib.sha256).digest()


def _set(t: torch.Tensor, i: int, v) -> torch.Tensor:
    """``t.at[i].set(v)``: a copy of ``t`` with element ``i`` replaced."""
    t = t.clone()
    t[i] = v
    return t


def _release_slot(st, i: int):
    """Clear node ``i``'s rumor slot, if it holds one: its belief row in
    every column shard, the slot registers and the node's slot pointer
    (control-plane surgery between dispatches)."""
    slot = int(st.slot_of_node[i])
    if slot < 0:
        return st
    heard = (tuple(_set(h, slot, 0) for h in st.heard)
             if isinstance(st.heard, tuple) else _set(st.heard, slot, 0))
    return st._replace(
        heard=heard,
        slot_node=_set(st.slot_node, slot, -1),
        slot_phase=_set(st.slot_phase, slot, 0),
        slot_dead_round=_set(st.slot_dead_round, slot, -1),
        slot_of_node=_set(st.slot_of_node, i, -1))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class GossipPlane:
    """The daemon: round session + bridge server + event fanout."""

    def __init__(self, config: Optional[PlaneConfig] = None) -> None:
        self.config = config or PlaneConfig()
        self._seen_nonces: Dict[tuple, float] = {}  # (ts, nonce) -> expiry
        self._nodes_by_name: Dict[str, PlaneNode] = {}
        self._nodes_by_id: Dict[int, PlaneNode] = {}
        self._free_ids: List[int] = []
        self._declared_dead: Set[int] = set()
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()   # every live bridge connection's writer
        self._tick_task: Optional[asyncio.Task] = None
        self._started = False
        # round session state, created in start()
        self._device: Optional[torch.device] = None
        self._p = None
        self._state = None
        self._key = None
        self._fail: Optional[np.ndarray] = None
        self._rounds_done = 0
        self._t0 = 0.0
        self._ndev = 1       # resolved in start() (config.shard_devices)
        self._run = None     # bound round-runner (sharded or not)
        # Autotune resolution (obs/tuner.py), bound in start(); the
        # pre-start defaults keep operator queries and stop() safe.
        self._autotune = None
        self._drain_every = FLIGHT_DRAIN_EVERY
        # Event-flood session: fires queue between dispatches; slot
        # metadata (payloads never enter device tensors) lives host-side,
        # keyed by (slot, start_round).
        self._ev_state = None
        self._fire_queue: List[tuple] = []   # (origin_id, meta dict)
        self._ev_meta: Dict[tuple, Dict[str, Any]] = {}
        # Flight recorder: the device ring the round writes, drained
        # every flight_drain_every dispatches.
        self._flight = None                  # FlightRing (device)
        self._flight_recorder = None         # obs.flight.FlightRecorder
        self._dispatches_since_drain = 0
        # Structured membership-event batch: detect/refute/join verdicts
        # accumulate per drain cadence (identity resolved at queue time)
        # and ship as one ``evbatch`` frame.
        self._pending_events: List[Dict[str, Any]] = []
        self._dispatches_since_event_flush = 0
        # Journey ledger: the round-start stamp of the dispatch whose
        # verdicts are being queued; 0.0 while no dispatch is in flight.
        self._journey_round0 = 0.0
        # Detection-latency banks, drained on the flight cadence into the
        # host recorder + SLO tracker.
        self._hist = None                    # kernel.HistBank (device)
        self._hist_recorder = None           # obs.hist.HistRecorder
        self._slo = None                     # obs.slo.SloTracker
        self._slo_board = None               # obs.slo.SloBoard (nemesis)
        self._nem = None                     # nemesis.NemesisParams
        self._nem_state = None               # kernel.NemState (device)
        self._nem_fail = None                # scheduled kills (np i32 [n])
        # Device/kernel observatory (obs/devstats.py); None when
        # CONSUL_TPU_DEV_OBS=0.
        self._dev = None                     # devstats.DevStats

    # -- universe ----------------------------------------------------------

    @property
    def n_universe(self) -> int:
        return self.config.capacity + self.config.sim_nodes

    def _alloc_id(self) -> Optional[int]:
        if self._free_ids:
            return self._free_ids.pop()
        return None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        from consul_tpu_torch.gossip.events import (init_events,
                                                    run_event_rounds)
        from consul_tpu_torch.gossip.kernel import (
            _check_shardable, init_flight, init_hist, init_nem_state,
            init_state, run_rounds, run_rounds_sharded, shard_state)
        from consul_tpu_torch.gossip.params import SwimParams
        from consul_tpu_torch.obs import devstats, tuner
        from consul_tpu_torch.obs.flight import FlightRecorder
        from consul_tpu_torch.obs.hist import HistRecorder
        from consul_tpu_torch.obs.slo import SloBoard, SloTracker

        c = self.config
        dev = resolve_device(c.device)
        self._device = dev
        n = self.n_universe
        # Resolve the autotuned knobs before any session tensor exists:
        # explicit config value > persisted verdict > registry default.
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
        explicit = {f: getattr(c, f) for f in TUNED_FIELDS
                    if getattr(c, f) != _TUNED_AUTO[f]}
        self._autotune = tuner.resolve(list(TUNED_FIELDS), explicit,
                                       platform=dev.type,
                                       device_count=n_cards)
        knob = self._autotune.value
        self._p = SwimParams(
            n=n, slots=c.slots, probe_every=c.probe_every,
            suspicion_mult=c.suspicion_mult,
            gossip_interval_s=c.gossip_interval_s,
            dissem=knob("dissem"), hot_slots=int(knob("hot_slots")),
            fused_nb=int(knob("fused_nb")))
        self._drain_every = max(1, int(knob("flight_drain_every")))
        state = init_state(self._p, device=dev)
        # Only registered agents (and live sim nodes) are members; start
        # with an empty membership and admit on register.  Simulated
        # nodes occupy ids [capacity, capacity+sim) and never fail.
        member = torch.zeros((n,), dtype=torch.bool, device=dev)
        member[c.capacity:] = True
        self._state = state._replace(member=member)
        self._key = prng.key(int.from_bytes(os.urandom(4), "big",
                                            signed=True))
        self._fail = np.full((n,), int(NEVER), np.int32)
        # Joins are round dynamics too: registration sets the id's
        # join_round and the round admits it (kernel._join_tick); EV_JOIN
        # broadcasts once the membership flip is visible (_pending_join).
        self._join = np.full((n,), int(NEVER), np.int32)
        self._pending_join: Dict[int, PlaneNode] = {}
        self._free_ids = list(range(c.capacity - 1, -1, -1))
        # Vectorized lapse bookkeeping indexed by node id.
        self._hb_at = np.zeros((c.capacity,), np.float64)
        self._eligible = np.zeros((c.capacity,), bool)  # registered, not left
        self._alive_mask = np.zeros((c.capacity,), bool)  # status == alive
        self._ev_state = init_events(self._p, slots=c.event_slots, device=dev)
        # Nemesis injection (config docstring): the schedule runs in the
        # round, the scenario's kills merge into the dispatch's fail
        # rounds, and LHM scenarios thread NemState through the carry.
        self._nem = self._nem_state = self._nem_fail = None
        if c.nemesis:
            from consul_tpu_torch.gossip.nemesis import build
            sc = build(c.nemesis, n)
            self._nem = sc.nem
            self._nem_fail = (np.asarray(sc.fail_round)
                              if bool(sc.killed.any()) else None)
            if sc.nem.needs_state:
                self._nem_state = init_nem_state(n, device=dev)
        # The shard count (config docstring: 1 = off, >1 = explicit and
        # strict, 0 = one per card when aligned, -1 = verdict).
        ndev = c.shard_devices
        tuned_shard = ndev < 0
        if tuned_shard:
            ndev = int(knob("shard_devices"))
        if ndev == 0:
            ndev = n_cards
            if n % ndev or n % self._p.probe_every:
                ndev = 1
        if ndev > 1:
            if tuned_shard:
                # A verdict settled on another topology must not brick
                # the boot: misaligned => degrade to one shard.
                try:
                    if ndev > n_cards:
                        raise ValueError("fewer devices than verdict")
                    _check_shardable(self._p, ndev)
                except ValueError:
                    ndev = 1
            else:
                _check_shardable(self._p, ndev)  # raises, constraint
        if ndev > 1:
            self._state = shard_state(self._state, ndev, dev)
        self._ndev = ndev
        if ndev > 1:
            def _run(state, key, fail, steps, join_round, flight, hist,
                     nem_state=None):
                return run_rounds_sharded(
                    state, key, fail, self._p, steps=steps, trace=True,
                    join_round=join_round, flight=flight, hist=hist,
                    nem=self._nem, nem_state=nem_state, ndev=self._ndev,
                    device=dev)
        else:
            def _run(state, key, fail, steps, join_round, flight, hist,
                     nem_state=None):
                return run_rounds(
                    state, key, fail, self._p, steps=steps, trace=True,
                    join_round=join_round, flight=flight, hist=hist,
                    nem=self._nem, nem_state=nem_state, device=dev)
        self._run = _run
        # Flight ring sized so a full drain interval fits with headroom
        # (bounded-burst catch-up can run extra dispatches before the
        # drain counter trips).
        self._flight = init_flight(
            ring_rounds=4 * self._drain_every * STEPS_PER_TICK, device=dev)
        self._flight_recorder = FlightRecorder()
        self._dispatches_since_drain = 0
        self._pending_events = []
        self._dispatches_since_event_flush = 0
        self._hist = init_hist(device=dev)
        self._hist_recorder = HistRecorder()
        objective = c.slo_objective_rounds or (
            self._p.suspicion_max_rounds + self._p.probe_every)
        self._slo = SloTracker(objective,
                               attainment_target=c.slo_attainment_target)
        self._slo_board = SloBoard(
            objective, attainment_target=c.slo_attainment_target)
        self._dev = devstats.DevStats(dev) if devstats.enabled() else None
        if self._dev is not None:
            self._dev.set_session(slots=c.slots, n=n)
        # Warm up before serving: the first kernel build (nvcc) and the
        # first dispatches take seconds and must not stall the event loop
        # later (a stalled plane cannot ingest heartbeats, which would
        # read as every agent lapsing at once).  The port's round leaves
        # its inputs intact, so the warm-up runs on the session tensors
        # and its outputs are dropped.
        if dev.type == "cuda":
            from consul_tpu_torch import _build
            from consul_tpu_torch.gossip import fused
            hit = _build.library_path("dissem_tail").exists()
            t_compile = time.monotonic()
            fused._lib("fused_merge" if ndev > 1 else "fused_dissem")
            if self._dev is not None:
                self._dev.note_compile("kernel_build",
                                       time.monotonic() - t_compile,
                                       cache_hit=hit)
        t_compile = time.monotonic()
        self._run(self._state, self._key, self._fail, STEPS_PER_TICK,
                  self._join, self._flight, self._hist, self._nem_state)
        _sync(dev)
        if self._dev is not None:
            self._dev.note_compile("plane_dispatch",
                                   time.monotonic() - t_compile)
        t_compile = time.monotonic()
        run_event_rounds(self._ev_state, self._key, self._state.member,
                         self._p, steps=STEPS_PER_TICK)
        _sync(dev)
        if self._dev is not None:
            self._dev.note_compile("event_dispatch",
                                   time.monotonic() - t_compile)
            self._dev.sample_devices()
        self._rounds_done = 0
        self._t0 = time.monotonic()

        if c.unix_path:
            try:
                os.unlink(c.unix_path)
            except FileNotFoundError:
                pass
            self._server = await asyncio.start_unix_server(
                self._serve, c.unix_path)
        else:
            self._server = await asyncio.start_server(
                self._serve, c.bind_addr, c.bind_port)
        self._tick_task = asyncio.get_event_loop().create_task(self._ticker())
        self._started = True

    @property
    def local_addr(self) -> tuple:
        socks = self._server.sockets if self._server else []
        return socks[0].getsockname()[:2] if socks else ("", 0)

    async def stop(self) -> None:
        self._started = False
        if self._tick_task is not None:
            self._tick_task.cancel()
            try:
                await self._tick_task
            except asyncio.CancelledError:
                pass  # we just cancelled it
            except Exception:  # noqa: E02 — tick's own failure; shutting down
                pass
        # Close every live connection BEFORE wait_closed(): since Python
        # 3.12.1 Server.wait_closed() waits for active handlers, and the
        # agents' heartbeat threads keep their sockets open.
        for writer in list(self._conns):
            try:
                writer.close()
            except Exception:  # noqa: E02 — best-effort close at teardown
                pass
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- round session -----------------------------------------------------

    def _due_rounds(self) -> int:
        elapsed = time.monotonic() - self._t0
        return int(elapsed / self.config.gossip_interval_s) - self._rounds_done

    async def _ticker(self) -> None:
        """Map wall time onto rounds: every gossip interval one round is
        due; catch-up runs whole STEPS_PER_TICK dispatches, at most
        ``max_burst`` per wake.  A backend that cannot sustain the
        configured rate re-bases the round clock (the protocol runs
        slower, which SWIM tolerates) instead of starving the heartbeat
        readers."""
        interval = self.config.gossip_interval_s
        max_burst = 4  # dispatches per wake before yielding/re-basing
        while True:
            await asyncio.sleep(interval * STEPS_PER_TICK / 2)
            try:
                self._mark_lapsed()
                self._reap_tombstones()
                burst = 0
                while self._due_rounds() >= STEPS_PER_TICK:
                    self._dispatch()
                    burst += 1
                    if burst >= max_burst:
                        if self._due_rounds() >= STEPS_PER_TICK:
                            # Hopelessly behind: drop the backlog.
                            self._t0 = (time.monotonic()
                                        - self._rounds_done * interval)
                        break
            except asyncio.CancelledError:
                raise
            except Exception as e:  # keep the plane alive; surface once
                print(f"[gossip-plane] tick error: {e!r}", file=sys.stderr)
                await asyncio.sleep(interval * 4)

    def _mark_lapsed(self) -> None:
        """Heartbeat lapse -> the node starts failing probes; resumed
        heartbeat -> it answers again (refutation takes it from there).
        Pure numpy over the id-indexed arrays."""
        now = time.monotonic()
        rnd = self._rounds_done
        cap = self.config.capacity
        real = self._fail[:cap]
        lapsed = (now - self._hb_at) > self.config.hb_lapse_s
        failing = real != int(NEVER)
        real[self._eligible & lapsed & ~failing] = rnd
        # back before any verdict: stop failing probes; an active
        # suspicion episode resolves by refutation (incarnation bump)
        real[self._eligible & self._alive_mask & ~lapsed & failing] = \
            int(NEVER)

    def _reap_tombstones(self) -> None:
        """Drop "left" names whose tombstone window expired, and release
        registrations that died mid-join (heartbeats lapsed before the
        round ever admitted them: never announced, so they simply
        cease)."""
        now = time.monotonic()
        cutoff = now - self.config.tombstone_timeout_s
        for name in [n for n, node in self._nodes_by_name.items()
                     if node.status == "left" and node.id < 0
                     and node.left_at < cutoff]:
            del self._nodes_by_name[name]
        ghost_cutoff = now - max(10 * self.config.hb_lapse_s, 5.0)
        for node in [n for n in self._nodes_by_id.values()
                     if n.status == "joining"
                     and self._hb_at[n.id] < ghost_cutoff]:
            i = node.id
            self._eligible[i] = False
            self._alive_mask[i] = False
            self._join[i] = int(NEVER)
            self._fail[i] = int(NEVER)
            self._pending_join.pop(i, None)
            self._nodes_by_id.pop(i, None)
            self._nodes_by_name.pop(node.name, None)
            self._free_ids.append(i)
            node.id = -1
            # Kill any still-open session: a revenant must re-register
            # through the redial path (fresh id, fresh welcome).
            if node.writer is not None:
                try:
                    node.writer.close()
                except Exception:  # noqa: E02 — best-effort close
                    pass
                node.writer = None

    def _dispatch(self) -> None:
        """Advance the round by STEPS_PER_TICK rounds and fan out the
        membership transitions the verdicts imply."""
        from consul_tpu_torch.gossip.kernel import PHASE_DEAD

        dev = self._dev
        t_disp = time.monotonic() if dev is not None else 0.0
        # The journey's detect stage anchors on the same round-start
        # stamp; take one when the device recorder didn't already.
        self._journey_round0 = (
            t_disp if t_disp else
            (time.monotonic() if _journey.journey is not None else 0.0))
        fail = self._fail
        if self._nem_fail is not None:
            # Scenario-scheduled kills (absolute rounds) override live
            # heartbeats: an injected fault is the node failing.
            fail = np.minimum(fail, self._nem_fail)
        out, trace = self._run(
            self._state, self._key, fail, STEPS_PER_TICK,
            self._join, self._flight, self._hist, self._nem_state)
        if self._nem_state is not None:
            state, self._flight, self._hist, self._nem_state = out
        else:
            state, self._flight, self._hist = out
        self._state = state
        self._rounds_done += STEPS_PER_TICK
        # Amortized drain: one host transfer per drain cadence.
        self._dispatches_since_drain += 1
        if self._dispatches_since_drain >= self._drain_every:
            self._drain_flight()

        # Joins the round admitted this dispatch: EV_JOIN is the
        # membership flip, not host-side bookkeeping.
        if self._pending_join:
            mem = state.member.cpu().numpy()
            for i, node in list(self._pending_join.items()):
                if node.status != "joining":   # evicted while pending
                    self._pending_join.pop(i, None)
                elif mem[i]:
                    self._pending_join.pop(i, None)
                    node.status = "alive"
                    self._queue_member_event(EV_JOIN, node)

        # Dead verdicts declared during this dispatch (the trace carries
        # the per-round slot registers: subject + phase).
        slot_node = trace.slot_node.cpu().numpy()    # [T, S]
        slot_phase = trace.slot_phase.cpu().numpy()  # [T, S]
        if dev is not None:
            # The trace fetch above waited for the device work, so this
            # is the dispatch's true host-visible latency.
            dev.note_dispatch(
                "sharded_round" if self._ndev > 1 else "round_step",
                (time.monotonic() - t_disp) * 1e3, STEPS_PER_TICK)
        dead_mask = (slot_phase == PHASE_DEAD) & (slot_node >= 0)
        for sid in np.unique(slot_node[dead_mask]):
            node = self._nodes_by_id.get(int(sid))
            if node is None or node.id in self._declared_dead:
                continue
            if node.status != "alive":
                continue
            self._declared_dead.add(node.id)
            node.status = "failed"
            self._alive_mask[node.id] = False
            self._queue_member_event(EV_FAILED, node)

        # Ship the cadence's structured batch: the counter only runs
        # while events are queued.
        if not self._pending_events:
            self._dispatches_since_event_flush = 0
        else:
            self._dispatches_since_event_flush += 1
            if self._dispatches_since_event_flush >= self._drain_every:
                self._flush_member_events()

        self._dispatch_events()

    def _dispatch_events(self) -> None:
        """User events ride the event flood: queued fires enter the
        [E, N] flood (lamport stamp, flood dynamics and coverage are
        device state).  Registered agents are seeded into the flood and
        notified over the bridge with the event's lamport time; the flood
        carries it across the rest of the universe."""
        from consul_tpu_torch.gossip.events import (_SEEN, fire_events,
                                                    run_event_rounds)

        if not self._fire_queue and not self._ev_meta:
            # No live event anywhere: skip the event dispatch (the event
            # clock lags while idle; every TTL compare is relative to it).
            return
        ev = self._ev_state
        if self._fire_queue:
            fires, self._fire_queue = self._fire_queue, []
            before_used = ev.slot_used.cpu().numpy()
            fire_round = int(ev.round)
            ev = fire_events(ev, torch.tensor([f[0] for f in fires],
                                              dtype=torch.int32))
            # fire_events hands free slots out in ascending index order,
            # one per fire: recover the mapping to attach host metadata.
            free_list = [s for s in range(before_used.shape[0])
                         if not before_used[s]]
            ltimes = ev.ltime.cpu().numpy()
            live = [n for n in self._nodes_by_id.values()
                    if n.id >= 0 and n.status in ("alive", "joining")]
            seed_ids = torch.tensor([n.id for n in live] or [0],
                                    dtype=torch.long, device=self._device)
            for k, (_oid, meta) in enumerate(fires):
                if k >= len(free_list):
                    # dropped, counted in ev.drops
                    continue
                s = free_list[k]
                meta = dict(meta, ltime=int(ltimes[s]))
                self._ev_meta[(s, fire_round)] = meta
                if live:
                    # Seeding = witnessing: the seeded nodes' lamport
                    # clocks advance by the witness rule
                    # (max(clock, event) + 1).
                    has = ev.has.clone()
                    has[s, seed_ids] = _SEEN
                    nl = ev.node_ltime.clone()
                    nl[seed_ids] = torch.maximum(nl[seed_ids],
                                                 ev.ltime[s]) + 1
                    ev = ev._replace(has=has,
                                     n_seen=_set(ev.n_seen, s, len(live)),
                                     node_ltime=nl)
                for node in live:
                    if node.writer is not None:
                        self._send(node.writer, {
                            "t": "user", "name": meta["name"],
                            "payload": meta["payload"],
                            "ltime": meta["ltime"], "from": meta["from"],
                            "coalesce": meta["coalesce"]})

        ev, _cov = run_event_rounds(ev, self._key, self._state.member,
                                    self._p, steps=STEPS_PER_TICK)
        self._ev_state = ev
        # GC host metadata for slots whose flood window closed.
        if self._ev_meta:
            used = ev.slot_used.cpu().numpy()
            startr = ev.start_round.cpu().numpy()
            for (s, sr) in list(self._ev_meta):
                if not used[s] or int(startr[s]) != sr:
                    self._ev_meta.pop((s, sr), None)

    def _drain_flight(self) -> None:
        """Pull the device flight ring to the host recorder: one
        device->host transfer for the whole batch."""
        if self._flight is None or self._flight_recorder is None:
            return
        self._dispatches_since_drain = 0
        dev = self._dev
        t_drain = time.monotonic() if dev is not None else 0.0
        cursor = int(self._flight.cursor)
        if cursor == self._flight_recorder.last_cursor:
            return  # nothing new since the last drain (banks idle too)
        self._flight_recorder.ingest(self._flight.rows.cpu().numpy(), cursor)
        self._drain_hist()
        if dev is not None:
            dev.note_drain((time.monotonic() - t_drain) * 1e3)
            # Device sampling rides this cadence, never the dispatch.
            dev.sample_devices()

    def _drain_hist(self) -> None:
        """Pull the device histogram banks to the host recorder and feed
        the detect delta to the SLO tracker (and, under a nemesis
        scenario, to its row of the SLO board)."""
        if self._hist is None or self._hist_recorder is None:
            return
        scenario = self._nem.scenario if self._nem is not None else None
        deltas = self._hist_recorder.ingest(
            {f: getattr(self._hist, f).cpu().numpy()
             for f in self._hist._fields}, scenario=scenario)
        if "detect" in deltas:
            if self._slo is not None:
                self._slo.observe(deltas["detect"])
            if scenario and self._slo_board is not None:
                self._slo_board.observe(scenario, deltas["detect"])

    def event_coverage(self) -> Dict[int, float]:
        """Live event slots -> fraction of members holding the event
        (the convergence observable, incl. the sim swarm)."""
        from consul_tpu_torch.gossip.events import coverage
        cov = coverage(self._ev_state, self._state.member).cpu().numpy()
        used = self._ev_state.slot_used.cpu().numpy()
        return {int(s): float(cov[s]) for s in np.nonzero(used)[0]}

    # -- registration / membership ops ------------------------------------

    def _admit(self, node: PlaneNode) -> None:
        """(Re)admission is a round join: the host only releases the id
        (clears membership + any stale episode) and stamps
        ``join_round``; the round's join tick flips membership, bumps the
        incarnation and disseminates alive@inc, and EV_JOIN is broadcast
        when that flip lands (_dispatch)."""
        i = node.id
        self._fail[i] = int(NEVER)
        st = _release_slot(self._state, i)
        self._state = st._replace(member=_set(st.member, i, False))
        self._join[i] = self._rounds_done  # next dispatch's first round
        self._declared_dead.discard(i)
        node.status = "joining"
        self._pending_join[i] = node
        node.last_hb = time.monotonic()
        self._hb_at[i] = node.last_hb
        self._eligible[i] = True
        self._alive_mask[i] = True

    def _evict(self, node: PlaneNode, status: str) -> None:
        i = node.id
        if i < 0:
            return  # already evicted (duplicate leave frame)
        self._eligible[i] = False
        self._alive_mask[i] = False
        self._join[i] = int(NEVER)
        self._pending_join.pop(i, None)
        st = self._state
        st = st._replace(member=_set(st.member, i, False))
        self._state = _release_slot(st, i)
        node.status = status
        if status == "left":
            # A left node's id goes back to the pool; the PlaneNode stays
            # listed as "left" (serf's tombstone window) and re-registers
            # through the id-less path.
            self._declared_dead.discard(i)
            self._nodes_by_id.pop(i, None)
            self._free_ids.append(i)
            node.id = -1
            node.left_at = time.monotonic()

    def members_wire(self) -> List[Dict[str, Any]]:
        return [self._member_wire(n) for n in self._nodes_by_name.values()]

    def _stats_wire(self) -> Dict[str, Any]:
        by = {"alive": 0, "failed": 0, "left": 0, "joining": 0}
        for node in self._nodes_by_name.values():
            by[node.status] = by.get(node.status, 0) + 1
        st = self._state
        return {
            "t": "stats", "round": self._rounds_done,
            "capacity": self.config.capacity,
            "sim_nodes": self.config.sim_nodes,
            "members": by,
            "pending_joins": len(self._pending_join),
            "event_slots_live": len(self._ev_meta),
            # on-demand device reads, fine for an operator query
            "kernel": {"drops": int(st.drops),
                       "n_detected": int(st.n_detected),
                       "n_false_dead": int(st.n_false_dead),
                       "n_refuted": int(st.n_refuted)},
        }

    def _slo_wire(self) -> Dict[str, Any]:
        """``slo`` frame: SLO burn-rate snapshot + exact latency
        percentiles + cumulative histogram families.  Drains the device
        banks first."""
        self._drain_hist()
        out: Dict[str, Any] = {"t": "slo"}
        if self._nem is not None:
            out["scenario"] = self._nem.scenario
        if self._slo is not None:
            out["slo"] = self._slo.snapshot()
        if self._hist_recorder is not None:
            out["latency"] = self._hist_recorder.summary()
            out["hists"] = self._hist_recorder.families()
            # Per scenario: a burn-rate and percentile row for each
            # nemesis scenario with attributed detections.
            board = (self._slo_board.snapshot()
                     if self._slo_board is not None else {})
            scns = self._hist_recorder.scenarios()
            if scns:
                out["scenarios"] = {
                    scn: {"slo": board.get(scn),
                          "latency": self._hist_recorder.summary(scn)}
                    for scn in scns}
        return out

    def _device_wire(self) -> Dict[str, Any]:
        """``device`` frame: dispatch hists, rounds/s EWMA, the card's
        memory rows, build + roofline telemetry, and the Prometheus
        families the agent splices into its scrape."""
        out: Dict[str, Any] = {"t": "device",
                               "enabled": self._dev is not None}
        if self._dev is not None:
            self._dev.sample_devices()
            out.update(self._dev.wire())
            hists, gauges, counters = self._dev.prom_families()
            out["families"] = {"histograms": hists, "gauges": gauges,
                               "counters": counters}
        return out

    def _autotune_wire(self) -> Dict[str, Any]:
        """``autotune`` frame: the knob resolution this plane booted
        with."""
        out: Dict[str, Any] = {"t": "autotune"}
        if self._autotune is not None:
            out.update(self._autotune.wire())
        return out

    def _profile_wire(self, steps: int, phases: bool = False
                      ) -> Dict[str, Any]:
        """On-demand profiling: run ``steps`` rounds from the session
        state (the port's round leaves its inputs intact, and the results
        are dropped) under ``torch.profiler``, the trace exported to a
        fresh temp dir, optionally followed by per-phase timings.
        Synchronous by design: an operator query, bounded to 64
        dispatches."""
        import tempfile

        from torch.profiler import ProfilerActivity, profile

        payload: Dict[str, Any] = {"t": "profile"}
        try:
            steps = max(STEPS_PER_TICK,
                        min(int(steps), 64 * STEPS_PER_TICK))
            ndisp = -(-steps // STEPS_PER_TICK)
            acts = [ProfilerActivity.CPU]
            if self._device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            trace_dir = tempfile.mkdtemp(prefix="consul-tpu-profile-")
            t0 = time.perf_counter()
            with profile(activities=acts) as prof:
                for _ in range(ndisp):
                    self._run(self._state, self._key, self._fail,
                              STEPS_PER_TICK, self._join, self._flight,
                              self._hist, self._nem_state)
                    _sync(self._device)
            wall = time.perf_counter() - t0
            prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            payload.update(
                trace_dir=trace_dir, rounds=ndisp * STEPS_PER_TICK,
                dispatches=ndisp, wall_s=wall,
                round_ms=wall * 1e3 / (ndisp * STEPS_PER_TICK))
            if self._device.type == "cuda":
                # The card's busy time (its kernels' own time); the
                # profiler inflates the host's, so the idle share is
                # read against an unprofiled dispatch.
                from consul_tpu_torch.profile_round import (device_kernels,
                                                            self_device_us)
                busy_us = sum(self_device_us(e) for e in device_kernels(prof))
                payload["device_ms_per_round"] = (
                    busy_us / 1e3 / payload["rounds"])
            # The devstats roofline derivation, so every profiling path
            # agrees on one figure.
            from consul_tpu_torch.obs import devstats
            util = devstats.roofline_utilization(
                devstats.dense_bytes_per_round(self._p.slots, self._p.n),
                1000.0 / payload["round_ms"])
            if util is not None:
                payload["roofline_utilization"] = round(util, 6)
            if phases:
                payload["phases_ms"] = self._profile_phases()
        except Exception as e:  # noqa: E02 — profiling must never kill the plane
            payload["error"] = f"{type(e).__name__}: {e}"
        return payload

    def _profile_phases(self) -> Dict[str, float]:
        """Per-phase timings (ms) of the round's own functions on the
        session state (``profile_round.timed``).  Single-shard sessions
        only: a sharded session reports just the profiler capture."""
        if self._ndev > 1:
            return {}
        from consul_tpu_torch.gossip import round_args
        from consul_tpu_torch.gossip.kernel import (_age_tick, _disseminate,
                                                    _probe_tick,
                                                    round_variant)
        from consul_tpu_torch.gossip.probe import scratch as probe_scratch
        from consul_tpu_torch.profile_round import timed

        p, st, key, dev = self._p, self._state, self._key, self._device
        rnd = int(st.round)
        fail = torch.from_numpy(self._fail).to(dev)
        mf = torch.where(st.member, fail, -1)
        rx = (fail > rnd) & st.member
        cc = torch.clamp(st.slot_nsusp - 1, min=0).clamp(
            max=p.max_confirmations)
        ra = round_args.row_args(
            round_args.layout(p.fanout, p.indirect_k),
            torch.from_numpy(round_args.build(p, key, rnd, 1)[0]).to(dev))
        v = round_variant(p, None, rnd)
        # The probe tick writes the matrix and the slot registers in
        # place: each timed call ticks copies of the session's, restored
        # before it, and the restore's own time is taken off.
        src = (st.heard, st.slot_node, st.slot_phase, st.slot_inc,
               st.slot_start, st.slot_nsusp, st.slot_dead_round,
               st.slot_of_node)
        own = [x.clone() for x in src] + [st.incarnation, st.member,
                                           st.drops.clone()]
        carry = tuple(own)

        def restore():
            for a, b in zip(own, src + (None, None, st.drops)):
                if b is not None:
                    a.copy_(b)

        sp = probe_scratch(p, dev)  # every tick leaves it as it found it

        def probe():
            restore()
            _probe_tick(p, ra, v, mf, carry, sp)

        # The port's tail ages inside the merge, so its row is the merged
        # age+gossip phase and the standalone age row is marked as such.
        out = {
            "age_tick_standalone": timed(lambda: _age_tick(st.heard), dev),
            "probe_tick": timed(probe, dev) - timed(restore, dev),
            "age_gossip_merge": timed(lambda: _disseminate(
                p, ra, v, st.heard, mf, rx, cc), dev),
        }
        return {k: v * 1e3 for k, v in out.items()}

    # -- bridge server -----------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        me: Optional[PlaneNode] = None
        if not self._started:
            # Accepted in the closing window: stop() snapshotted _conns
            # before this task ran — bail so wait_closed() can finish.
            try:
                writer.close()
            except Exception:  # noqa: E02 — best-effort close
                pass
            return
        self._conns.add(writer)
        try:
            while True:
                hdr = await reader.readexactly(4)
                (ln,) = struct.unpack(">I", hdr)
                if ln > 1 << 20:
                    break
                m = msgpack.unpackb(await reader.readexactly(ln), raw=False)
                t = m.get("t")
                if t == "register":
                    me, refuse = self._register(m, writer)
                    if me is None:
                        self._send(writer, {"t": "err", "error": refuse})
                        break
                elif me is None:
                    continue
                elif t == "hb":
                    me.last_hb = time.monotonic()
                    if me.id >= 0:
                        self._hb_at[me.id] = me.last_hb
                    if me.status == "failed":
                        # heartbeats resumed after a dead verdict: the
                        # node rejoins at a fresh incarnation; EV_JOIN
                        # fires when the membership flip lands
                        self._admit(me)
                elif t == "leave":
                    self._evict(me, "left")
                    self._broadcast_member_event(EV_LEAVE, me)
                elif t == "force-leave":
                    tgt = self._nodes_by_name.get(m.get("node", ""))
                    if tgt is not None and tgt.status == "failed":
                        self._evict(tgt, "left")
                        self._broadcast_member_event(EV_LEAVE, tgt)
                elif t == "tags":
                    me.tags = dict(m.get("tags") or {})
                    self._broadcast_member_event(EV_UPDATE, me)
                elif t == "event":
                    # Enters the event flood at the next dispatch.
                    if me.id >= 0:
                        self._fire_queue.append((me.id, {
                            "name": m.get("name", ""),
                            "payload": m.get("payload", b""),
                            "coalesce": m.get("coalesce", True),
                            "from": me.name}))
                elif t == "members":
                    self._send(writer, {"t": "members",
                                        "members": self.members_wire()})
                elif t == "stats":
                    # Session counters on demand (registered connections
                    # only: an armed keyring gates observability too).
                    self._send(writer, self._stats_wire())
                elif t == "flight":
                    # Drain whatever the round wrote since the last
                    # drain, then serve the host-side timeline.
                    self._drain_flight()
                    payload = {"t": "flight"}
                    if self._flight_recorder is not None:
                        payload.update(self._flight_recorder.wire(
                            limit=int(m.get("limit", 256) or 256)))
                    self._send(writer, payload)
                elif t == "slo":
                    self._drain_flight()
                    self._send(writer, self._slo_wire())
                elif t == "device":
                    self._send(writer, self._device_wire())
                elif t == "autotune":
                    self._send(writer, self._autotune_wire())
                elif t == "profile":
                    # Blocks this connection's loop while capturing: an
                    # explicit, bounded operator action.
                    self._send(writer, self._profile_wire(
                        int(m.get("steps", 8 * STEPS_PER_TICK)
                            or 8 * STEPS_PER_TICK),
                        phases=bool(m.get("phases", False))))
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            # Socket loss is NOT a leave: the failure detector owns that
            # verdict (heartbeats just stop arriving).
            self._conns.discard(writer)
            if me is not None and me.writer is writer:
                me.writer = None
            try:
                writer.close()
            except Exception:  # noqa: E02 — best-effort close
                pass

    def _verify_auth(self, m: Dict[str, Any]) -> bool:
        """Registration proof check against every installed key (agents
        may prove with a non-primary key).  Never raises — malformed auth
        fields are a refusal — and a (ts, nonce) pair is single-use
        within the skew window."""
        try:
            ts = int(m.get("auth_ts", 0) or 0)
            nonce = bytes(m.get("auth_nonce", b"") or b"")
            mac = bytes(m.get("auth", b"") or b"")
            now = time.time()
            if abs(now - ts) > self.config.auth_skew_s:
                return False
            seen = self._seen_nonces
            for k in [k for k, exp in seen.items() if exp < now]:
                del seen[k]
            if (ts, nonce) in seen:
                return False
            for key in self.config.encrypt_keys:
                try:
                    want = registration_proof(
                        key, m.get("name", ""), m.get("addr", ""),
                        int(m.get("port", 0) or 0), ts, nonce,
                        m.get("tags") or {})
                except Exception:
                    continue  # one bad key must not mask the others
                if hmac.compare_digest(want, mac):
                    seen[(ts, nonce)] = now + 2 * self.config.auth_skew_s
                    return True
        except Exception:
            return False
        return False

    def _register(self, m: Dict[str, Any], writer: asyncio.StreamWriter
                  ) -> tuple[Optional[PlaneNode], str]:
        if self.config.encrypt_keys and not self._verify_auth(m):
            return None, "authentication failed (keyring proof required)"
        name = m.get("name", "")
        node = self._nodes_by_name.get(name)
        if node is not None and node.status == "alive" \
                and node.writer is not None and node.writer is not writer \
                and (time.monotonic() - node.last_hb) <= self.config.hb_lapse_s:
            # Name conflict with a LIVE registration: refuse, as
            # memberlist's name-conflict delegate does.  A dead/lapsed
            # holder is a restart and may re-register.
            return None, "name taken by a live node"
        if node is None or node.id < 0:
            nid = self._alloc_id()
            if nid is None:
                return None, "plane full"
            if node is None:
                node = PlaneNode(id=nid, name=name)
                self._nodes_by_name[name] = node
            else:  # a previously-left name re-registering
                node.id = nid
            self._nodes_by_id[nid] = node
        node.addr = m.get("addr", "")
        node.port = int(m.get("port", 0) or 0)
        node.tags = dict(m.get("tags") or {})
        node.writer = writer
        self._admit(node)
        self._send(writer, {
            "t": "welcome", "id": node.id, "round": self._rounds_done,
            "hb_interval_s": self.config.hb_lapse_s / 3.0,
            "members": self.members_wire()})
        # EV_JOIN broadcasts from _dispatch once the round admits the id.
        return node, ""

    def _member_wire(self, node: PlaneNode) -> Dict[str, Any]:
        # "joining" (registered, membership flip pending <1 tick) reads
        # as alive on the wire — serf members show a joiner immediately.
        return {"name": node.name, "addr": node.addr, "port": node.port,
                "tags": node.tags,
                "state": ("dead" if node.status == "failed" else
                          "left" if node.status == "left" else "alive")}

    def _queue_member_event(self, kind: str, node: PlaneNode) -> None:
        """Accumulate one verdict transition into the cadence's batch.
        Identity is resolved now (the id may be reused before the
        flush)."""
        ev: Dict[str, Any] = {"kind": kind, "node": self._member_wire(node)}
        jy = _journey.journey
        if jy is not None:
            now = time.monotonic()
            detect_ms = ((now - self._journey_round0) * 1000.0
                         if self._journey_round0 else -1.0)
            jy.stage_observe("detect", detect_ms)
            # Stamp carriage for downstream stages: [t_detect, t_flush,
            # detect_ms] — monotonic floats, in-process comparisons only.
            ev["jt"] = [now, 0.0, round(detect_ms, 3)]
        self._pending_events.append(ev)

    def _flush_member_events(self) -> None:
        """Ship the queued transitions as one ``evbatch`` frame."""
        self._dispatches_since_event_flush = 0
        if not self._pending_events:
            return
        events, self._pending_events = self._pending_events, []
        jy = _journey.journey
        if jy is not None:
            now = time.monotonic()
            for ev in events:
                jt = ev.get("jt")
                if jt:
                    jy.stage_observe("drain", (now - jt[0]) * 1000.0)
                    jt[1] = now
        self._broadcast({"t": "evbatch", "events": events})

    def _broadcast_member_event(self, kind: str, node: PlaneNode) -> None:
        # Host-driven transitions (leave/force-leave/tags) broadcast
        # immediately; the queued batch flushes FIRST so an agent never
        # sees a leave before the failure that preceded it.
        self._flush_member_events()
        self._broadcast({"t": "ev", "kind": kind,
                         "node": self._member_wire(node)})

    def _broadcast(self, payload: Dict[str, Any]) -> None:
        for node in self._nodes_by_id.values():
            if node.writer is not None:
                self._send(node.writer, payload)

    @staticmethod
    def _send(writer: asyncio.StreamWriter, payload: Dict[str, Any]) -> None:
        try:
            raw = msgpack.packb(payload, use_bin_type=True)
            writer.write(struct.pack(">I", len(raw)) + raw)
        except Exception:  # noqa: E02 — dying peer socket; reaper collects it
            pass


async def run_plane(config: PlaneConfig) -> GossipPlane:
    plane = GossipPlane(config)
    await plane.start()
    return plane
