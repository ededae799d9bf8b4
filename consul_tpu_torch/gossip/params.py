"""SWIM/Lifeguard protocol parameters, expressed in gossip rounds.

A copy of ``consul_tpu/gossip/params.py`` (the port imports nothing of
the reference package).  The reference's timing contract comes from
memberlist's LAN/WAN profiles as consumed by Consul
(``consul/config.go:266-272``): probe interval 1s, gossip interval
200ms, suspicion multiplier 4-6, retransmit multiplier 4, k=3 indirect
probes, gossip fanout 3.  The round is synchronous: **one round = one
gossip interval**, and probes fire every ``probe_every`` rounds.  All
timeouts are converted to rounds here, once — the round itself never
sees wall-clock time.

Lifeguard (arxiv 1707.00788): the suspicion timeout starts at
``max = suspicion_max_mult * min`` and shrinks toward
``min = suspicion_mult * log10(n) * probe interval`` as independent
confirmations arrive, following the paper's logarithmic decay.

``dissem``: the reference has four bit-identical lowerings of the dense
dissemination tail (``swar``, ``planes``, ``prefused`` and the Pallas
``fused`` kernel; ``tests/test_fused_parity.py`` proves them equal).
The port keeps the field and validates it, so every configuration the
reference accepts is accepted here, but it does not branch on it: it has
one dense tail — the hand-written Hopper kernel on a CUDA tensor and its
plain torch version on a CPU tensor (``gossip/fused.py``).  Only the
``fused_nb`` divisibility check of ``dissem="fused"`` is carried over.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SwimParams:
    """Static protocol config; hashable (used as a cache key)."""

    n: int  # number of node ids in the membership universe
    slots: int = 32  # concurrent rumor slots (S); overflow is counted, not silent
    fanout: int = 3  # gossip targets per node per round (memberlist GossipNodes)
    indirect_k: int = 3  # indirect probe helpers (memberlist IndirectChecks)
    probe_every: int = 5  # gossip rounds per probe tick (1s probe / 200ms gossip)
    suspicion_mult: float = 4.0  # memberlist SuspicionMult
    suspicion_max_mult: float = 6.0  # Lifeguard SuspicionMaxTimeoutMult
    max_confirmations: int = 3  # confirmations that drive timeout to min
    retransmit_mult: float = 4.0  # memberlist RetransmitMult
    loss_rate: float = 0.0  # iid packet-loss probability per message
    gossip_interval_s: float = 0.2  # for round<->seconds conversion only
    refute: bool = True  # alive subjects refute suspicion (incarnation bump)
    # Push/pull anti-entropy cadence in rounds; 0 disables.  memberlist
    # default: 30s LAN = 150 rounds, 60s WAN = 120 rounds.
    pushpull_every: int = 0
    # Hot-tier width: rounds with <= this many live episodes process
    # only the gathered subset of belief rows (kernel._hot_tail).
    # 0 disables the tier; lan_profile defaults it to 8.
    hot_slots: int = 0
    # Dissemination strategy of the reference (module docstring): kept
    # and validated, never branched on.
    dissem: str = "swar"
    # Column-block count of the reference's Pallas grid; with
    # dissem="fused" it must divide n.
    fused_nb: int = 1

    def __post_init__(self) -> None:
        if self.dissem not in ("swar", "planes", "prefused", "fused"):
            raise ValueError(
                f"dissem must be swar|planes|prefused|fused, got "
                f"{self.dissem!r}")
        if self.fused_nb < 1:
            raise ValueError(f"fused_nb must be >= 1, got {self.fused_nb}")

    # ---- derived, all static ----

    @property
    def log_n(self) -> float:
        return max(1.0, math.log10(max(self.n, 1)))

    @property
    def suspicion_min_rounds(self) -> int:
        return max(1, math.ceil(self.suspicion_mult * self.log_n * self.probe_every))

    @property
    def suspicion_max_rounds(self) -> int:
        return max(
            self.suspicion_min_rounds,
            math.ceil(self.suspicion_max_mult * self.suspicion_mult * self.log_n * self.probe_every),
        )

    def timeout_table(self) -> np.ndarray:
        """Suspicion timeout (rounds) per confirmation count 0..max_confirmations.

        Lifeguard decay: timeout(c) = max - (max-min) * log(c+1)/log(k+1).
        """
        lo, hi = self.suspicion_min_rounds, self.suspicion_max_rounds
        k = self.max_confirmations
        out = []
        for c in range(k + 1):
            frac = math.log(c + 1) / math.log(k + 1) if k > 0 else 1.0
            out.append(int(max(lo, math.ceil(hi - (hi - lo) * frac))))
        return np.asarray(out, dtype=np.int32)

    @property
    def transmit_limit(self) -> int:
        """Total piggyback transmissions per node per message (memberlist
        retransmit limit: RetransmitMult * ceil(log10(n+1)))."""
        return max(1, int(self.retransmit_mult * math.ceil(math.log10(self.n + 1))))

    @property
    def spread_budget_rounds(self) -> int:
        """Rounds a node keeps gossiping a message: limit / fanout.  Capped
        at 14 to fit the 4-bit age field with its 0xF fresh-mark
        sentinel."""
        return min(14, max(1, math.ceil(self.transmit_limit / self.fanout)))

    @property
    def event_ttl_rounds(self) -> int:
        """Rounds an event slot stays allocated after firing: the flood
        window plus, with push/pull on, log2(n) anti-entropy cycles."""
        ttl = self.spread_budget_rounds + 8
        if self.pushpull_every:
            ttl += self.pushpull_every * math.ceil(math.log2(self.n + 1))
        return ttl

    @property
    def slot_ttl_rounds(self) -> int:
        """Rounds before a rumor slot is recycled: worst-case suspicion
        timer plus two full dissemination sweeps of the final verdict."""
        return self.suspicion_max_rounds + 2 * self.spread_budget_rounds + 8

    @property
    def p_direct_fail_alive(self) -> float:
        """P(direct probe of an alive target fails) = probe or ack lost."""
        q = 1.0 - self.loss_rate
        return 1.0 - q * q

    @property
    def p_indirect_fail_alive(self) -> float:
        """P(one indirect relay of an alive target fails) — four legs."""
        q = 1.0 - self.loss_rate
        return 1.0 - q ** 4


# Ready-made profiles mirroring memberlist's LAN and WAN defaults.
def lan_profile(n: int, **kw) -> SwimParams:
    kw.setdefault("pushpull_every", 150)  # 30s / 200ms gossip
    kw.setdefault("hot_slots", 8)
    return SwimParams(n=n, probe_every=5, suspicion_mult=4.0, retransmit_mult=4.0,
                      fanout=3, gossip_interval_s=0.2, **kw)


def wan_profile(n: int, **kw) -> SwimParams:
    """memberlist DefaultWANConfig: probe 5s / gossip 500ms, wider timers."""
    kw.setdefault("pushpull_every", 120)  # 60s / 500ms gossip
    return SwimParams(n=n, probe_every=10, suspicion_mult=6.0, retransmit_mult=4.0,
                      fanout=4, gossip_interval_s=0.5, **kw)
