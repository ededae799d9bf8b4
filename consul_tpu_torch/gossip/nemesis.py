"""The nemesis scenario catalog: correlated-fault injection schedules
for the SWIM round.

A copy of ``consul_tpu/gossip/nemesis.py`` (the reference; its module
docstring describes the fault axes: correlated kills, partitions and
asymmetric loss, flapping, the heal rejoin, degraded observers with
Lifeguard's local-health multiplier).  It uses numpy only, as the
original does, and ``tests/test_torch_isolation.py`` holds it against
the original.  A ``NemesisParams`` carries only static scalars; the
round (``consul_tpu_torch/gossip/kernel.py``) derives every mask it needs
from them, and mirrors ``group_of`` bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

NEVER = np.int32(2**31 - 1)  # matches kernel.NEVER (no import cycle)

# Knuth's multiplicative hash; the group bit is the top bit of the
# 32-bit product.  uint32 wraparound only — numpy and jnp agree exactly.
HASH_MULT = 2654435761


def hash_group(ids) -> np.ndarray:
    """Hash-partition group bit (0/1) per node id — numpy mirror of the
    round's derivation (kernel._nem_group)."""
    prod = (np.asarray(ids, dtype=np.uint64) * np.uint64(HASH_MULT)) \
        & np.uint64(0xFFFFFFFF)
    return (prod >> np.uint64(31)).astype(np.int32)


@dataclass(frozen=True)
class NemesisParams:
    """One scenario's injection schedule.  Hashable scalars only: the
    round caches the masks it derives per (schedule, n, device)."""

    scenario: str = ""        # label for the observatory dimension
    start: int = 0            # fault window [start, stop) in rounds
    stop: int = int(NEVER)

    # -- partition / asymmetric loss ------------------------------------
    part_kind: str = "none"   # "none" | "contig" | "hash"
    p_ab: float = 0.0         # drop prob on group-0 -> group-1 edges
    p_ba: float = 0.0         # drop prob on group-1 -> group-0 edges
    heal_rejoin: bool = False  # re-arm join_round at ``stop``

    # -- flapping --------------------------------------------------------
    flap_lo: int = 0          # flapping id range [flap_lo, flap_hi)
    flap_hi: int = 0
    flap_period: int = 0      # square wave: up flap_up rounds, then down
    flap_up: int = 0

    # -- degraded observers / Lifeguard LHM ------------------------------
    obs_lo: int = 0           # degraded prober id range [obs_lo, obs_hi)
    obs_hi: int = 0
    p_obs_miss: float = 0.0   # P(degraded prober drops a reply it got)
    lhm_max: int = 0          # local-health multiplier ceiling; 0 = LHM off

    @property
    def has_partition(self) -> bool:
        return self.part_kind != "none" and (self.p_ab > 0 or self.p_ba > 0)

    @property
    def has_flap(self) -> bool:
        return self.flap_hi > self.flap_lo and self.flap_period > 0

    @property
    def has_degraded(self) -> bool:
        return self.obs_hi > self.obs_lo and self.p_obs_miss > 0

    @property
    def needs_state(self) -> bool:
        """True when the scenario threads kernel.NemState (LHM/streak)
        through the round's carry."""
        return self.lhm_max > 0

    @property
    def needs_join(self) -> bool:
        """True when the schedule rewrites join_round — callers must
        pass a join_round array (all-NEVER works)."""
        return self.has_flap or self.heal_rejoin

    @property
    def p_roundtrip(self) -> float:
        """Cross-group round-trip drop probability: any request/reply
        pair crosses both directions once."""
        return 1.0 - (1.0 - self.p_ab) * (1.0 - self.p_ba)


def group_of(nem: NemesisParams, n: int) -> np.ndarray:
    """Partition group bit (0/1) per node id, [n] int32."""
    ids = np.arange(n)
    if nem.part_kind == "hash":
        return hash_group(ids)
    return (ids >= n // 2).astype(np.int32)


@dataclass
class Scenario:
    """A fully-instantiated scenario at cluster size ``n``: the static
    schedule plus its ground-truth arrays and a suggested horizon."""

    name: str
    nem: NemesisParams
    fail_round: np.ndarray               # i32 [n] ground-truth kills
    join_round: Optional[np.ndarray]     # i32 [n] or None (no join path)
    steps: int                           # suggested simulation horizon
    description: str

    @property
    def killed(self) -> np.ndarray:
        return self.fail_round < NEVER


def _base(n: int) -> np.ndarray:
    return np.full((n,), NEVER, dtype=np.int32)


def _block_kill(n: int) -> Scenario:
    fail = _base(n)
    lo, hi = n // 8, n // 4
    fail[lo:hi] = 30
    return Scenario(
        name="block_kill",
        nem=NemesisParams(scenario="block_kill"),
        fail_round=fail, join_round=None, steps=400,
        description=(f"Rack kill: contiguous ids [{lo}, {hi}) all fail at "
                     f"round 30 — correlated loss of n/8 members at once."))


def _zone_kill(n: int) -> Scenario:
    fail = _base(n)
    ids = np.arange(n)
    victims = (hash_group(ids) == 1) & (ids % 8 == 0)
    fail[victims] = 30
    return Scenario(
        name="zone_kill",
        nem=NemesisParams(scenario="zone_kill"),
        fail_round=fail, join_round=None, steps=400,
        description=("Zone kill: a hashed ~n/16 subset striped across the "
                     "id space fails at round 30."))


def _partition_heal(n: int) -> Scenario:
    nem = NemesisParams(scenario="partition_heal", start=40, stop=160,
                        part_kind="contig", p_ab=1.0, p_ba=1.0,
                        heal_rejoin=True)
    return Scenario(
        name="partition_heal",
        nem=nem, fail_round=_base(n), join_round=_base(n), steps=400,
        description=("Full bisection rounds [40, 160): no message crosses "
                     "the halves; both sides declare the other dead, then "
                     "the heal re-arms join_round and membership recovers."))


def _asym_loss(n: int) -> Scenario:
    fail = _base(n)
    ids = np.arange(n)
    fail[ids % 37 == 5] = 40
    nem = NemesisParams(scenario="asym_loss", start=20,
                        part_kind="hash", p_ab=0.6, p_ba=0.0)
    return Scenario(
        name="asym_loss",
        nem=nem, fail_round=fail, join_round=None, steps=400,
        description=("Asymmetric loss from round 20 on: hashed group-0 -> "
                     "group-1 edges drop 60% (replies die, requests "
                     "arrive), plus scattered true kills at round 40."))


def _flapping(n: int) -> Scenario:
    hi = max(2, n // 64)
    # Down phases must outlast the Lifeguard suspicion timeout
    # (~50-290 rounds at oracle scale, params.timeout_table) or no
    # verdict ever fires and the scenario measures nothing: 60 up / 80
    # down gives two full detect->rejoin cycles inside the window.
    nem = NemesisParams(scenario="flapping", start=30, stop=310,
                        flap_lo=0, flap_hi=hi, flap_period=140, flap_up=60)
    return Scenario(
        name="flapping",
        nem=nem, fail_round=_base(n), join_round=_base(n), steps=420,
        description=(f"Flapping: ids [0, {hi}) oscillate 60 rounds up / 80 "
                     "down through rounds [30, 310), rejoining through the "
                     "join tick (incarnation bump) on every up edge."))


def _degraded_observer(n: int) -> Scenario:
    fail = _base(n)
    ids = np.arange(n)
    fail[ids % 29 == 7] = 30
    nem = NemesisParams(scenario="degraded_observer",
                        obs_lo=0, obs_hi=max(1, n // 4),
                        p_obs_miss=0.3, lhm_max=3)
    return Scenario(
        name="degraded_observer",
        nem=nem, fail_round=fail, join_round=None, steps=400,
        description=("Slow observers: probers in [0, n/4) drop 30% of the "
                     "replies they receive; the Lifeguard local-health "
                     "multiplier suppresses their false suspicions while "
                     "true kills at round 30 must still be detected."))


CATALOG: Dict[str, Callable[[int], Scenario]] = {
    "block_kill": _block_kill,
    "zone_kill": _zone_kill,
    "partition_heal": _partition_heal,
    "asym_loss": _asym_loss,
    "flapping": _flapping,
    "degraded_observer": _degraded_observer,
}


def names() -> List[str]:
    return list(CATALOG)


def build(name: str, n: int) -> Scenario:
    """Instantiate a catalog scenario at cluster size ``n``."""
    try:
        factory = CATALOG[name]
    except KeyError:
        raise ValueError(
            f"unknown nemesis scenario {name!r}; have {sorted(CATALOG)}"
        ) from None
    return factory(n)
