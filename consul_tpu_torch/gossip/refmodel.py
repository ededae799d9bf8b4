"""Discrete-event reference model of SWIM/Lifeguard membership semantics:
the cross-validation oracle of the round.

A copy of ``consul_tpu/gossip/refmodel.py`` (the reference; its module
docstring describes the model: per-node state with shuffled round-robin
probe lists, independent uniform gossip targets, per-node suspicion
timers, distinct-origin confirmation sets and per-message retransmit
budgets).  It uses ``random`` and numpy only, as the original does, and
imports the port's own ``nemesis`` and ``params`` copies;
``tests/test_torch_isolation.py`` holds it against the original
statement for statement.  Seeded (``random.Random(seed)``), so a run is
the same on every machine.
"""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from consul_tpu_torch.gossip.nemesis import NemesisParams, group_of
from consul_tpu_torch.gossip.params import SwimParams

ALIVE, SUSPECT, DEAD = 0, 1, 2


@dataclasses.dataclass
class Message:
    kind: int          # SUSPECT / DEAD / ALIVE(refute) — ALIVE encoded as 3
    subject: int
    inc: int
    origin: int        # original suspector/declarer (drives Lifeguard distinctness)


REFUTE = 3


@dataclasses.dataclass
class Belief:
    status: int = ALIVE
    inc: int = 0
    heard_tick: int = 0
    confirmers: Optional[Set[int]] = None  # distinct suspicion origins seen


class Broadcast:
    __slots__ = ("msg", "remaining", "born")

    def __init__(self, msg: Message, remaining: int, born: int = -1):
        self.msg = msg
        self.remaining = remaining
        # Tick the broadcast was enqueued: it may not be FORWARDED
        # within the same tick (one gossip hop per tick — the same
        # synchronous-rounds convention the kernel and the event oracle
        # use; without this, shuffled intra-tick processing lets a
        # rumor chain multiple hops per tick and flood measurably
        # faster than either other model).  Beliefs and timers still
        # update at receipt — only re-forwarding waits.
        self.born = born


@dataclasses.dataclass
class DetectionEvent:
    subject: int
    fail_tick: int
    first_suspect_tick: int
    dead_tick: int


class RefModel:
    """Per-node discrete-event SWIM simulation."""

    def __init__(self, p: SwimParams, fail_tick: Dict[int, int], seed: int = 0,
                 join_tick: Optional[Dict[int, int]] = None,
                 nemesis: Optional[NemesisParams] = None):
        self.p = p
        self.n = p.n
        self.rng = random.Random(seed)
        self.fail_tick = dict(fail_tick)
        # Nemesis schedule (gossip/nemesis.py): the oracle models the
        # SAME correlated faults the kernel injects — partition /
        # asymmetric-loss edge drops, flapping truth overrides with
        # rejoin-on-up-edge, heal rejoin, degraded-observer reply drops
        # and the Lifeguard local-health multiplier.
        self.nemesis = nemesis
        self._nem_group = (group_of(nemesis, self.n)
                           if nemesis is not None and nemesis.has_partition
                           else None)
        # Lifeguard LHM registers (kernel.NemState rule, per prober):
        # suspicion initiation gates on streak > lhm; +1 on NACK-style
        # evidence (direct miss while a helper vouches) and on being
        # refuted, -1 on clean probe success.
        self._lhm = [0] * self.n
        self._lhm_streak = [0] * self.n
        # Joins (memberlist: a join is a TCP state sync with one contact
        # node followed by a gossiped alive@inc broadcast —
        # gossip.html.markdown:10-43): nodes with a join_tick do not
        # exist in anyone's view (or act) until that tick.
        self.join_tick = dict(join_tick or {})
        self.tick = 0
        # Per-node protocol state (sparse: only deviations from alive@0).
        self.beliefs: List[Dict[int, Belief]] = [dict() for _ in range(self.n)]
        self.queues: List[List[Broadcast]] = [[] for _ in range(self.n)]
        self.incarnation = [0] * self.n
        # Membership views are stored SPARSELY as per-node exclusion
        # sets (nodes believed dead): everyone starts believing everyone
        # is a member, and a dense per-node member set would be O(n²)
        # memory — ~13 GB at n=10k, which made large oracle runs swap.
        self.not_member: List[Set[int]] = [set() for _ in range(self.n)]
        # Round-robin probe lists (memberlist: shuffled sweep, reshuffle
        # at end).  Lazy + int32-packed: eager Python lists were the
        # other O(n²) memory sink (~4 GB at n=10k).
        self.probe_list: List[Optional[np.ndarray]] = [None] * self.n
        self.probe_pos = [0] * self.n
        self.probe_offset = [self.rng.randrange(p.probe_every) for _ in range(self.n)]
        self.pushpull_offset = ([self.rng.randrange(p.pushpull_every)
                                 for _ in range(self.n)]
                                if p.pushpull_every else [])
        # Suspicion timers: (observer, subject) -> deadline handled lazily.
        self.first_suspect: Dict[int, int] = {}
        self.dead_declared: Dict[int, int] = {}
        self.events: List[DetectionEvent] = []
        self.n_refuted = 0
        self.n_false_dead = 0
        self.dissemination: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        # Incremental dissemination bookkeeping: observers currently
        # holding the dead verdict per subject.  Replaces an O(n) scan
        # per dead subject per tick, which dominated 10k-node oracle
        # runs in the cross-validation harness.
        self._dead_knowers: Dict[int, Set[int]] = defaultdict(set)
        # Join-propagation bookkeeping: who has learned of each joiner.
        self._join_knowers: Dict[int, Set[int]] = defaultdict(set)
        self.join_curve: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for j in self.join_tick:
            for i in range(self.n):
                if i != j:
                    self.not_member[i].add(j)
        # Same Lifeguard decay the kernel uses — one source of truth.
        self._timeouts = p.timeout_table()

    # -- helpers ----------------------------------------------------------

    def _shuffled(self, i: int) -> np.ndarray:
        """Fresh shuffled probe ring for node i: current members only,
        int32-packed (memberlist reshuffles its node ring per sweep)."""
        rng = np.random.default_rng(self.rng.getrandbits(64))
        perm = rng.permutation(self.n).astype(np.int32)
        drop = self.not_member[i] | {i}
        if drop:
            mask = np.ones(self.n, bool)
            mask[list(drop)] = False
            perm = perm[mask[perm]]
        return perm

    def _is_member(self, i: int, x: int) -> bool:
        return x != i and x not in self.not_member[i]

    def _member_count(self, i: int) -> int:
        return self.n - 1 - len(self.not_member[i])

    def _sample_members(self, i: int, k: int,
                        exclude: Tuple[int, ...] = ()) -> List[int]:
        """k distinct members of i's view (rejection sampling — the
        exclusion set is tiny relative to n, so acceptance is high).
        Falls back to an explicit scan for tiny viable sets."""
        viable = self._member_count(i) - sum(
            1 for e in set(exclude) if self._is_member(i, e))
        k = min(k, max(0, viable))
        if k <= 0:
            return []
        out: List[int] = []
        seen = set(exclude)
        seen.add(i)
        attempts = 0
        while len(out) < k and attempts < 20 * (k + 1):
            attempts += 1
            x = self.rng.randrange(self.n)
            if x in seen or x in self.not_member[i]:
                continue
            seen.add(x)
            out.append(x)
        if len(out) < k:  # dense fallback (view almost empty)
            pool = [x for x in range(self.n)
                    if x not in seen and x not in self.not_member[i]]
            self.rng.shuffle(pool)
            out.extend(pool[: k - len(out)])
        return out

    def _alive_truth(self, i: int) -> bool:
        return (self.fail_tick.get(i, 1 << 60) > self.tick
                and self._joined(i) and not self._flap_down(i))

    # -- nemesis fault injection (mirrors kernel._nem_* derivations) ------

    def _nem_window(self, t: Optional[int] = None) -> bool:
        nem = self.nemesis
        if nem is None:
            return False
        t = self.tick if t is None else t
        return nem.start <= t < nem.stop

    def _flap_down(self, i: int, t: Optional[int] = None) -> bool:
        """Square-wave truth override: up ``flap_up`` rounds, then down
        for the rest of the period, inside the fault window."""
        nem = self.nemesis
        if nem is None or not nem.has_flap:
            return False
        if not (nem.flap_lo <= i < nem.flap_hi):
            return False
        t = self.tick if t is None else t
        if not (nem.start <= t < nem.stop):
            return False
        return ((t - nem.start) % nem.flap_period) >= nem.flap_up

    def _edge_lost(self, src: int, dst: int) -> bool:
        """One directed message leg crossing the partition: dropped with
        the source group's edge probability."""
        nem = self.nemesis
        if self._nem_group is None or not self._nem_window():
            return False
        gs = int(self._nem_group[src])
        if gs == int(self._nem_group[dst]):
            return False
        pe = nem.p_ab if gs == 0 else nem.p_ba
        return pe > 0 and self.rng.random() < pe

    def _truth_fail_tick(self, subject: int) -> int:
        """Tick the subject ACTUALLY went down — its scheduled fail
        tick, or the start of its current flap down-phase (flap victims
        have no ``fail_tick`` entry)."""
        ft = self.fail_tick.get(subject)
        if ft is not None and ft <= self.tick:
            return ft
        nem = self.nemesis
        if nem is not None and self._flap_down(subject):
            rel = (self.tick - nem.start) % nem.flap_period
            return self.tick - (rel - nem.flap_up)
        return self.tick

    def _obs_miss(self, i: int) -> bool:
        """Degraded observer: prober ``i`` drops a reply it DID receive
        (the observer is slow, not the target)."""
        nem = self.nemesis
        return (nem is not None and nem.has_degraded and self._nem_window()
                and nem.obs_lo <= i < nem.obs_hi
                and self.rng.random() < nem.p_obs_miss)

    def _joined(self, i: int) -> bool:
        return self.join_tick.get(i, -(1 << 60)) <= self.tick

    def _lost(self) -> bool:
        return self.rng.random() < self.p.loss_rate

    def _belief(self, i: int, subject: int) -> Belief:
        b = self.beliefs[i].get(subject)
        if b is None:
            b = Belief(inc=0)
            self.beliefs[i][subject] = b
        return b

    def _transmit_limit(self) -> int:
        return self.p.transmit_limit

    def _enqueue(self, i: int, msg: Message, originated: bool = False) -> None:
        """``originated``: the node CREATED this message during its own
        probe/join phase — it rides the node's own gossip burst this
        same tick (the kernel's fresh-mark behavior).  Messages enqueued
        while HANDLING received gossip forward from the next tick."""
        # memberlist queue invalidates older broadcasts about the same subject
        self.queues[i] = [b for b in self.queues[i] if b.msg.subject != msg.subject]
        self.queues[i].append(Broadcast(msg, self._transmit_limit(),
                                        born=-1 if originated else self.tick))

    def _suspicion_timeout(self, nconf: int) -> int:
        return int(self._timeouts[min(nconf, self.p.max_confirmations)])

    # -- message handling (SWIM semantics) --------------------------------

    def _handle(self, i: int, msg: Message) -> None:
        if not self._alive_truth(i):
            return
        subject = msg.subject
        if subject == i:
            # About me: refute suspicion/death (alive with bumped incarnation).
            if msg.kind in (SUSPECT, DEAD) and self.p.refute and msg.inc >= self.incarnation[i]:
                self.incarnation[i] = msg.inc + 1
                self.n_refuted += 1
                if self.nemesis is not None and self.nemesis.lhm_max > 0:
                    # Lifeguard: being refuted is evidence the LOCAL
                    # node is degraded — raise its multiplier.
                    self._lhm[i] = min(self._lhm[i] + 1,
                                       self.nemesis.lhm_max)
                self._enqueue(i, Message(REFUTE, i, self.incarnation[i], i))
            return
        b = self._belief(i, subject)
        if msg.kind == SUSPECT:
            if b.status == DEAD or msg.inc < b.inc:
                return
            if b.status == SUSPECT and msg.inc == b.inc:
                if b.confirmers is not None and msg.origin not in b.confirmers:
                    b.confirmers.add(msg.origin)
                    self._enqueue(i, msg)
                return
            b.status, b.inc, b.heard_tick = SUSPECT, msg.inc, self.tick
            b.confirmers = {msg.origin}
            self.first_suspect.setdefault(subject, self.tick)
            self._enqueue(i, msg)
        elif msg.kind == DEAD:
            if b.status == DEAD or msg.inc < b.inc:
                return
            b.status, b.inc, b.heard_tick = DEAD, msg.inc, self.tick
            self.not_member[i].add(subject)
            self._dead_knowers[subject].add(i)
            self._enqueue(i, msg)
        elif msg.kind == REFUTE:
            if msg.inc <= b.inc and b.status != ALIVE:
                return
            if msg.inc > b.inc:
                b.status, b.inc, b.heard_tick = ALIVE, msg.inc, self.tick
                b.confirmers = None
                # Faithfulness fix (was a latent oracle bug): memberlist's
                # aliveNode at a newer incarnation RE-ADMITS the subject to
                # the membership view; the old dense-set code left a
                # refuted node permanently excluded from members[i].
                readmitted = subject in self.not_member[i]
                self.not_member[i].discard(subject)
                self._dead_knowers[subject].discard(i)
                if subject in self.join_tick:
                    first = i not in self._join_knowers[subject]
                    self._join_knowers[subject].add(i)
                    # memberlist aliveNode splices a NEW member into the
                    # probe ring at a random offset immediately (it
                    # would otherwise wait a full sweep for reshuffle).
                    ring = self.probe_list[i]
                    if first and readmitted and ring is not None:
                        pos = self.rng.randrange(len(ring) + 1)
                        self.probe_list[i] = np.insert(
                            ring, pos, np.int32(subject))
                self._enqueue(i, msg)

    def _declare_dead(self, i: int, subject: int, b: Belief) -> None:
        b.status = DEAD
        self.not_member[i].add(subject)
        self._dead_knowers[subject].add(i)
        if subject not in self.dead_declared:
            self.dead_declared[subject] = self.tick
            truly = not self._alive_truth(subject)
            if truly:
                self.events.append(DetectionEvent(
                    subject, self._truth_fail_tick(subject),
                    self.first_suspect.get(subject, self.tick), self.tick))
            else:
                self.n_false_dead += 1
        self._enqueue(i, Message(DEAD, subject, b.inc, i))

    # -- per-tick phases --------------------------------------------------

    def _probe(self, i: int) -> None:
        if self._member_count(i) <= 0:
            return
        # next round-robin target still believed a member
        ring = self.probe_list[i]
        if ring is None:
            ring = self.probe_list[i] = self._shuffled(i)
        for _ in range(len(ring) + 1):
            if self.probe_pos[i] >= len(ring):
                ring = self.probe_list[i] = self._shuffled(i)
                self.probe_pos[i] = 0
                if len(ring) == 0:
                    return
            t = int(ring[self.probe_pos[i]])
            self.probe_pos[i] += 1
            if self._is_member(i, t):
                break
        else:
            return
        target_up = self._alive_truth(t)
        # Direct probe: request i->t, ack t->i — two iid loss draws plus
        # one partition draw per direction plus the degraded-observer
        # chance of dropping the ack after receipt.
        direct_ok = (target_up and not self._lost() and not self._lost()
                     and not self._edge_lost(i, t)
                     and not self._edge_lost(t, i)
                     and not self._obs_miss(i))
        ok = direct_ok
        rescued = False
        if not ok:
            helpers = self._sample_members(i, self.p.indirect_k, exclude=(t,))
            for h in helpers:
                if not self._alive_truth(h):
                    continue
                # Four legs: i->h, h->t, t->h, h->i — each crosses the
                # partition independently; the final reply can still be
                # dropped by a degraded prober.
                if (target_up and not any(self._lost() for _ in range(4))
                        and not self._edge_lost(i, h)
                        and not self._edge_lost(h, t)
                        and not self._edge_lost(t, h)
                        and not self._edge_lost(h, i)
                        and not self._obs_miss(i)):
                    ok = rescued = True
                    break
        nem = self.nemesis
        if nem is not None and nem.lhm_max > 0:
            # Lifeguard local-health multiplier — the kernel NemState
            # rule verbatim: gate on the OLD multiplier, then update.
            miss = not direct_ok
            streak = (min(self._lhm_streak[i] + 1, nem.lhm_max + 1)
                      if miss else 0)
            gate = streak > self._lhm[i]
            self._lhm[i] = min(max(
                self._lhm[i] + (1 if (miss and rescued) else 0)
                - (0 if miss else 1), 0), nem.lhm_max)
            self._lhm_streak[i] = streak
            if not ok and not gate:
                return  # LHM suppresses this round's suspicion
        if not ok:
            b = self._belief(i, t)
            if b.status == ALIVE:
                inc = max(b.inc, 0)
                b.status, b.inc, b.heard_tick = SUSPECT, inc, self.tick
                b.confirmers = {i}  # creator seed; not a confirmation
                self.first_suspect.setdefault(t, self.tick)
                self._enqueue(i, Message(SUSPECT, t, inc, i),
                              originated=True)
            elif b.status == SUSPECT:
                # memberlist suspectNode on an existing suspicion: the local
                # failed probe is an independent confirmation, re-gossiped.
                if b.confirmers is not None and i not in b.confirmers:
                    b.confirmers.add(i)
                    self._enqueue(i, Message(SUSPECT, t, b.inc, i),
                                  originated=True)

    def _gossip(self, i: int) -> None:
        if not self.queues[i] or self._member_count(i) <= 0:
            return
        targets = self._sample_members(i, self.p.fanout)
        for b in list(self.queues[i]):
            if b.born == self.tick:
                continue  # one hop per tick: forwarded from next tick on
            for t in targets:
                if b.remaining <= 0:
                    break
                b.remaining -= 1
                if (self._alive_truth(t) and not self._lost()
                        and not self._edge_lost(i, t)):
                    self._handle(t, b.msg)
        self.queues[i] = [b for b in self.queues[i] if b.remaining > 0]

    def _pushpull(self, i: int) -> None:
        """memberlist PushPullInterval: full bidirectional state sync
        with one random member over TCP (pushPullNode →
        mergeRemoteState).  Each deviating belief merges through the
        ordinary message semantics — this is what recovers rumors whose
        retransmit budget expired before reaching everyone."""
        partners = self._sample_members(i, 1)
        if not partners:
            return
        j = partners[0]
        if not self._alive_truth(j):
            return  # TCP dial to a dead node fails
        if self._edge_lost(i, j) or self._edge_lost(j, i):
            return  # TCP sync crossing the partition fails
        kind_of = {SUSPECT: SUSPECT, DEAD: DEAD, ALIVE: REFUTE}
        for a, b in ((i, j), (j, i)):
            for subject, bel in list(self.beliefs[b].items()):
                if bel.status == ALIVE and bel.inc == 0:
                    continue  # no information beyond the default
                self._handle(a, Message(kind_of[bel.status], subject,
                                        bel.inc, b))

    def _timers(self, i: int) -> None:
        for subject, b in list(self.beliefs[i].items()):
            if b.status != SUSPECT:
                continue
            # memberlist seeds the suspicion with its creator, which does not
            # count as a confirmation; n = distinct origins seen since.
            nconf = min(self.p.max_confirmations, max(0, len(b.confirmers or ()) - 1))
            if self.tick - b.heard_tick >= self._suspicion_timeout(nconf):
                self._declare_dead(i, subject, b)

    def _do_join(self, j: int) -> None:
        """Node ``j`` joins: state sync with one live contact (the TCP
        push/pull leg of memberlist Join), then an alive@inc broadcast
        floods through gossip (the same REFUTE message class)."""
        self.incarnation[j] = max(1, self.incarnation[j] + 1)
        contacts = [x for x in range(self.n)
                    if x != j and self._alive_truth(x)
                    and not self._edge_lost(j, x)
                    and not self._edge_lost(x, j)]
        if contacts:
            c = self.rng.choice(contacts)
            # joiner adopts the contact's membership view...
            self.not_member[j] = set(self.not_member[c]) - {j}
            # ...and appears in the contact's view over the same sync
            self.not_member[c].discard(j)
            self._join_knowers[j].add(c)
        self.probe_list[j] = None  # fresh ring over the synced view
        self.probe_pos[j] = 0
        self._join_knowers[j].add(j)
        self._enqueue(j, Message(REFUTE, j, self.incarnation[j], j),
                      originated=True)

    def step(self) -> None:
        t = self.tick
        nem = self.nemesis
        if nem is not None and nem.has_flap:
            # Flap up edge: the node restarts — incarnation bump +
            # alive@inc flood through the ordinary join path (the
            # kernel re-arms join_round to the same effect).
            for i in range(nem.flap_lo, min(nem.flap_hi, self.n)):
                if (self._flap_down(i, t - 1) and not self._flap_down(i, t)
                        and self.fail_tick.get(i, 1 << 60) > t
                        and self._joined(i)):
                    self._do_join(i)
        if nem is not None and nem.heal_rejoin and t == nem.stop:
            # Partition heal: every node falsely declared dead rejoins
            # (kernel: join_round = min(join_round, stop)).
            for j in range(self.n):
                if self._alive_truth(j) and (j in self.dead_declared
                                             or self._dead_knowers.get(j)):
                    self._do_join(j)
        for j, jt in self.join_tick.items():
            if jt == t and self.fail_tick.get(j, 1 << 60) > t:
                self._do_join(j)
        for i in range(self.n):
            if not self._alive_truth(i):
                continue
            if (t + self.probe_offset[i]) % self.p.probe_every == 0:
                self._probe(i)
            if self.p.pushpull_every and \
                    (t + self.pushpull_offset[i]) % self.p.pushpull_every == 0:
                self._pushpull(i)
        order = list(range(self.n))
        self.rng.shuffle(order)
        for i in order:
            if self._alive_truth(i):
                self._gossip(i)
        for i in range(self.n):
            if self._alive_truth(i):
                self._timers(i)
        # dissemination curve for failed subjects (incremental count;
        # includes observers that themselves die later — the curve is
        # monotone either way and its consumers check the peak)
        for subject in self.dead_declared:
            self.dissemination[subject].append(
                (t, len(self._dead_knowers[subject])))
        for j, jt in self.join_tick.items():
            if jt <= t:
                self.join_curve[j].append((t, len(self._join_knowers[j])))
        self.tick += 1

    def run(self, ticks: int) -> None:
        for _ in range(ticks):
            self.step()

    # -- summary ----------------------------------------------------------

    def detection_latencies(self) -> List[int]:
        return [e.dead_tick - e.fail_tick for e in self.events]
