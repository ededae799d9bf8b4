"""User-event dissemination on torch tensors (port of
``consul_tpu/gossip/events.py``, whose docstring explains the protocol:
Serf's lamport-clocked user-event flood over the membership kernel's
circulant gossip graph).

Layout: E concurrent event slots over N nodes.

    has[e, i]  (uint8)  bits 7: seen   bits 3-0: age (rounds since seen)

Under the same key and inputs every function here is bit-identical to
the reference's (``tests/test_torch_events.py``).  How the JAX program
maps onto eager PyTorch:

- the round counter is mirrored on the host (one read per
  ``run_event_rounds`` call), so the round key, the gossip offsets and
  the push/pull cadence (a ``lax.cond`` in the reference) are host
  decisions that cost no device read;
- the reference's ``mode="drop"`` scatters write into a padded sink
  element that is sliced off (``kernel._set_drop``);
- the Lamport witness max over ``[E, N]`` stays int32 (an int64
  promotion would double a 256 MB temporary at [64, 1M]).

These are plain torch ops: the reference has no Pallas kernel here.
Tensors passed in are never modified in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from consul_tpu_torch import prng
from consul_tpu_torch._device import resolve_device
from consul_tpu_torch.gossip.kernel import (_host_int, _set_drop,
                                            alloc_free_slots, gossip_offsets)
from consul_tpu_torch.gossip.params import SwimParams

_SEEN = 0x80
_AGE_MASK = 0x0F

_I32 = torch.int32


class EventState(NamedTuple):
    round: torch.Tensor        # i32 scalar
    has: torch.Tensor          # u8 [E, N] seen-bit + age
    slot_used: torch.Tensor    # bool [E]
    ltime: torch.Tensor        # i32 [E] lamport time of each event
    origin: torch.Tensor       # i32 [E] firing node
    start_round: torch.Tensor  # i32 [E]
    node_ltime: torch.Tensor   # i32 [N] per-node lamport clock
    n_seen: torch.Tensor       # i32 [E] cumulative deliveries (wraps mod 2**32)
    drops: torch.Tensor        # i32 — fires lost to full slots


def init_events(p: SwimParams, slots: int = 64, device=None) -> EventState:
    dev = resolve_device(device)
    E, N = slots, p.n

    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=dev)

    return EventState(
        round=z(),
        has=torch.zeros((E, N), dtype=torch.uint8, device=dev),
        slot_used=torch.zeros((E,), dtype=torch.bool, device=dev),
        ltime=z(E),
        origin=torch.full((E,), -1, dtype=_I32, device=dev),
        start_round=z(E),
        node_ltime=z(N),
        n_seen=z(E),
        drops=z(),
    )


def fire_events(state: EventState, nodes) -> EventState:
    """Originate one event per entry of ``nodes`` (int32 firing node ids;
    -1 entries are ignored, repeats fire once each).  Each takes a free
    slot in ascending slot order; overflow counts into ``drops``.
    Lamport: fire = local clock + 1."""
    dev = state.has.device
    nodes = torch.as_tensor(nodes).to(device=dev, dtype=_I32)
    E, N = state.has.shape
    want = nodes >= 0
    can, _slot_for, sidx = alloc_free_slots(~state.slot_used, want)
    node_c = nodes.clamp(0, N - 1)

    fire_lt = state.node_ltime[node_c.long()] + 1
    # A repeated node writes the same value from every entry, so which
    # duplicate lands does not matter; dropped entries go to the sink N.
    node_ltime = _set_drop(state.node_ltime, torch.where(can, node_c, N),
                           fire_lt)
    slot_used = _set_drop(state.slot_used, sidx, True)
    ltime = _set_drop(state.ltime, sidx, fire_lt)
    origin = _set_drop(state.origin, sidx, nodes)
    start_round = _set_drop(state.start_round, sidx,
                            state.round.expand(sidx.shape))
    flat = torch.where(can, sidx * N + node_c, E * N)
    has = _set_drop(state.has.reshape(-1), flat, _SEEN).view(E, N)
    n_seen = _set_drop(state.n_seen, sidx, 1)  # the origin has it
    drops = state.drops + (want & ~can).sum(dtype=_I32)
    return state._replace(has=has, slot_used=slot_used, ltime=ltime,
                          origin=origin, start_round=start_round,
                          node_ltime=node_ltime, n_seen=n_seen, drops=drops)


def _event_round(state: EventState, rnd: int, base_key, alive: torch.Tensor,
                 p: SwimParams) -> EventState:
    """One gossip round of event flooding; ``rnd`` is the host mirror of
    ``state.round``."""
    key = prng.fold_in(prng.fold_in(base_key, 7), rnd)
    N = p.n

    # Gossip on pre-tick ages (a copy received last round, age 0, gets
    # its first send this round even with a 1-round budget).
    cur = state.has
    seen = (cur & _SEEN) > 0

    rx_ok = alive
    new_seen = torch.zeros_like(seen)
    for o in gossip_offsets(key, N, p.fanout):
        src_ok = torch.roll(alive, o)
        hin = torch.roll(cur, o, dims=1)
        active = (src_ok[None, :] & ((hin & _SEEN) > 0)
                  & ((hin & _AGE_MASK) < p.spread_budget_rounds))
        new_seen |= active & rx_ok[None, :]

    # Push/pull anti-entropy: full-state sync with one partner, spread
    # budget ignored.
    if p.pushpull_every and rnd % p.pushpull_every == p.pushpull_every - 1:
        o = int(prng.randint(prng.fold_in(key, 9), (), 1, N))
        for shift in (o, -o):
            ok = rx_ok & torch.roll(alive, shift)
            hin = torch.roll(cur, shift, dims=1)
            new_seen |= ((hin & _SEEN) > 0) & ok[None, :]

    fresh = new_seen & ~seen
    age = cur & _AGE_MASK
    aged = torch.where(seen, _SEEN | torch.clamp(age + 1, max=_AGE_MASK), cur)
    has = torch.where(fresh, _SEEN, aged).to(torch.uint8)
    n_seen = state.n_seen + fresh.sum(dim=1, dtype=_I32)

    # Lamport witness: clock = max(clock, max ltime of newly seen
    # events) + 1, in int32 throughout.
    wit = torch.where(fresh, state.ltime[:, None], 0).amax(dim=0)
    node_ltime = torch.where(wit > 0,
                             torch.maximum(state.node_ltime, wit) + 1,
                             state.node_ltime)

    # Slot GC after the event TTL (flood window + push/pull recovery).
    done = state.slot_used & (rnd - state.start_round > p.event_ttl_rounds)
    has = torch.where(done[:, None], 0, has).to(torch.uint8)
    slot_used = state.slot_used & ~done
    origin = torch.where(done, -1, state.origin)

    return state._replace(round=state.round + 1, has=has,
                          slot_used=slot_used, origin=origin,
                          node_ltime=node_ltime, n_seen=n_seen)


def _alive_on(alive, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(alive).to(device=dev, dtype=torch.bool)


def event_round(state: EventState, base_key, alive, p: SwimParams
                ) -> EventState:
    """One gossip round of event flooding (reference ``event_round``);
    ``base_key`` is a ``prng`` key."""
    alive = _alive_on(alive, state.has.device)
    return _event_round(state, _host_int(state.round), base_key, alive, p)


def coverage(state: EventState, alive) -> torch.Tensor:
    """Fraction of alive nodes that have seen each event slot [E]
    (float32, as the reference's int32 / int32)."""
    alive = _alive_on(alive, state.has.device)
    seen = ((state.has & _SEEN) > 0) & alive[None, :]
    n_alive = alive.sum(dtype=_I32).clamp(min=1)
    return (seen.sum(dim=1, dtype=_I32).to(torch.float32)
            / n_alive.to(torch.float32))


def run_event_rounds(state: EventState, base_key, alive, p: SwimParams,
                     steps: int):
    """``steps`` rounds (reference ``run_event_rounds``): returns the
    state and the per-round coverage trace ``[steps, E]``.  One
    device->host read per call (the round counter)."""
    dev = state.has.device
    alive = _alive_on(alive, dev)
    rnd = _host_int(state.round)
    covs = []
    for _ in range(steps):
        state = _event_round(state, rnd, base_key, alive, p)
        rnd += 1
        covs.append(coverage(state, alive))
    cov = (torch.stack(covs) if covs else
           torch.zeros((0, state.has.shape[0]), dtype=torch.float32,
                       device=dev))
    return state, cov
