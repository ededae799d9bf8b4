"""User-event dissemination on torch tensors (port of
``consul_tpu/gossip/events.py``, whose docstring explains the protocol:
Serf's lamport-clocked user-event flood over the membership kernel's
circulant gossip graph).

Layout: E concurrent event slots over N nodes.

    has[e, i]  (uint8)  bits 7: seen   bits 3-0: age (rounds since seen)

Under the same key and inputs every function here is bit-identical to
the reference's (``tests/test_torch_events.py``,
``tests/test_torch_event_program.py``).  How the JAX program maps onto
PyTorch:

- ``jax.jit(run_event_rounds)`` (and ``event_round``) is
  ``gossip/program.py``'s ``EventProgram`` on a card: one event round
  captured as a CUDA graph per push/pull variant and replayed once a
  round.  The eager loop here is its plain version: the CPU runs it, and
  so does a card when asked (``graphed=False``).
- The round's scalars (its number, the F gossip shifts and the push/pull
  partner, drawn under ``fold_in(fold_in(key, 7), rnd)``) are a row of
  the event layout's table, made for a whole call (on a card by the table
  kernel, ``round_table.fill``; eagerly on the host,
  ``round_args.build_events``) and read on the device; the round counter is mirrored on the host (one
  read per call), so the push/pull cadence (a ``lax.cond`` in the
  reference) is a host decision, the program's variant.
- The whole round on ``[E, N]`` is one function, ``flood``: on a CUDA
  tensor one launch of the Hopper kernel ``csrc/event_flood.cu``
  (``event_flood``), on a CPU tensor its plain version
  ``event_flood_ref`` (the reference's rolls as gathers by the row's
  device shifts, ``kernel._roll``).  There is no fallback.
- The reference's ``mode="drop"`` scatters write into a padded sink
  element that is sliced off (``slot_ops.set_drop``);
- the Lamport witness max over ``[E, N]`` stays int32 (an int64
  promotion would double a 256 MB temporary at [64, 1M]); ``n_seen``
  wraps mod 2**32 as the reference's int32 sum does.

Tensors passed in are never modified in place.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from consul_tpu_torch import _build
from consul_tpu_torch._device import (check_tensor, require_cuda,
                                      resolve_device)
from consul_tpu_torch.gossip import round_args
from consul_tpu_torch.gossip.kernel import _host_int, _roll
from consul_tpu_torch.gossip.params import SwimParams
from consul_tpu_torch.gossip.slot_ops import alloc_free_slots, set_drop

_SEEN = 0x80
_AGE_MASK = 0x0F

_I32 = torch.int32

MAX_FANOUT = 8     # kMaxFanout of csrc/event_flood.cu
MAX_SLOTS = 3072   # kMaxSlots
TILE_COLS = 512    # kTile: the columns of one block
STRIPES = 32       # kStripes: copies of each slot's counts in the scratch
# Kernel launches made by ``event_flood`` (one per launch, nowhere else).
launches = 0
# (E, N, F, budget, ttl, pushpull) of every launch, so a smoke run can
# hold each shape its paths launched at against the plain version.
launch_shapes: set = set()
# A list while a caller records the floods (None otherwise): per flood
# asked for, its shape and by-value arguments (the round and the shifts
# are read from device memory).
launch_log: list | None = None


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
    node_ltime = set_drop(state.node_ltime, torch.where(can, node_c, N),
                           fire_lt)
    slot_used = set_drop(state.slot_used, sidx, True)
    ltime = set_drop(state.ltime, sidx, fire_lt)
    origin = set_drop(state.origin, sidx, nodes)
    start_round = set_drop(state.start_round, sidx,
                            state.round.expand(sidx.shape))
    flat = torch.where(can, sidx * N + node_c, E * N)
    has = set_drop(state.has.reshape(-1), flat, _SEEN).view(E, N)
    n_seen = set_drop(state.n_seen, sidx, 1)  # the origin has it
    drops = state.drops + (want & ~can).sum(dtype=_I32)
    return state._replace(has=has, slot_used=slot_used, ltime=ltime,
                          origin=origin, start_round=start_round,
                          node_ltime=node_ltime, n_seen=n_seen, drops=drops)


class Flood(NamedTuple):
    """What one event round writes: the fields of ``EventState`` it
    changes (but the round counter)."""

    has: torch.Tensor          # u8 [E, N]
    slot_used: torch.Tensor    # bool [E]
    origin: torch.Tensor       # i32 [E]
    node_ltime: torch.Tensor   # i32 [N]
    n_seen: torch.Tensor       # i32 [E]
    alive_seen: torch.Tensor   # i32 [E]: live nodes holding each slot after
                               #   the round (``coverage``'s numerator)


def event_flood_ref(has, alive, slot_used, ltime, origin, start_round,
                    node_ltime, n_seen, row, budget: int, ttl: int,
                    pushpull: bool, out: Flood | None = None) -> Flood:
    """One event round on any device, in plain torch (the reference's
    ``event_round`` body).  ``row``: the round's event row, int32 ``[rnd,
    o_0 .. o_F-1, pp_o, -pp_o]`` (``round_args.build_events``); the
    rolls are gathers by its device shifts.  ``pushpull``: a push/pull
    round (both partner legs, no budget).  With ``out`` (tensors of the
    result's shapes, ``out.has`` apart from ``has``) the result is
    written into them, the new ``has`` by the op that makes it, and
    ``out`` is returned."""
    ea = round_args.event_args(row.shape[0] - 3, row)
    rnd = ea.rnd
    # Gossip on pre-tick ages (a copy received last round, age 0, gets
    # its first send this round even with a 1-round budget).
    cur = has
    seen = (cur & _SEEN) > 0
    rx_ok = alive
    new_seen = torch.zeros_like(seen)
    for o in ea.gossip:
        src_ok = _roll(alive, o, 0)
        hin = _roll(cur, o, 1)
        active = (src_ok[None, :] & ((hin & _SEEN) > 0)
                  & ((hin & _AGE_MASK) < budget))
        new_seen |= active & rx_ok[None, :]
    if pushpull:
        # Anti-entropy: full-state sync with one partner, both ways,
        # spread budget ignored.
        for shift in ea.pp:
            ok = rx_ok & _roll(alive, shift, 0)
            hin = _roll(cur, shift, 1)
            new_seen |= ((hin & _SEEN) > 0) & ok[None, :]

    fresh = new_seen & ~seen
    age = cur & _AGE_MASK
    aged = torch.where(seen, _SEEN | torch.clamp(age + 1, max=_AGE_MASK), cur)
    nxt = torch.where(fresh, _SEEN, aged).to(torch.uint8)
    n_seen = n_seen + fresh.sum(dim=1, dtype=_I32)

    # Lamport witness: clock = max(clock, max ltime of newly seen
    # events) + 1, in int32 throughout.
    wit = torch.where(fresh, ltime[:, None], 0).amax(dim=0)
    node_ltime = torch.where(wit > 0, torch.maximum(node_ltime, wit) + 1,
                             node_ltime)

    # Slot GC after the event TTL (flood window + push/pull recovery).
    done = slot_used & (rnd - start_round > ttl)
    zero = torch.zeros((), dtype=torch.uint8, device=has.device)
    nxt = torch.where(done[:, None], zero, nxt,
                      out=None if out is None else out.has)
    alive_seen = (((nxt & _SEEN) > 0) & alive[None, :]).sum(dim=1,
                                                          dtype=_I32)
    res = Flood(has=nxt, slot_used=slot_used & ~done,
                origin=torch.where(done, -1, origin),
                node_ltime=node_ltime, n_seen=n_seen, alive_seen=alive_seen)
    if out is None:
        return res
    for f in Flood._fields[1:]:
        getattr(out, f).copy_(getattr(res, f))
    return out


_VP, _CI = ctypes.c_void_p, ctypes.c_int
# The C entry point's argument types: 15 pointers, E, N, F, the row, the
# budget, the TTL, the push/pull flag and the stream.
_ARGTYPES = [_VP] * 15 + [_CI] * 3 + [_VP] + [_CI] * 3 + [_VP]


def scratch_words(E: int, N: int) -> int:
    """The int32 words of ``event_flood``'s scratch at ``[E, N]``
    (``event_flood_scratch_words`` of ``csrc/event_flood.cu``): the
    witness [N], one arrival counter a column tile, two counts a slot in
    each of ``STRIPES`` copies, the grid's arrival counter."""
    return N + -(-N // TILE_COLS) + 2 * STRIPES * E + 1


def flood_scratch(E: int, N: int, device) -> torch.Tensor:
    """A zero scratch for ``event_flood`` at ``[E, N]``: every launch
    leaves it zero, so a caller that floods one launch at a time keeps one
    (an ``EventProgram`` does) and its rounds need no memset."""
    return torch.zeros(scratch_words(E, N), dtype=_I32, device=device)


@functools.lru_cache(maxsize=None)
def _lib():
    """``event_flood`` of ``csrc/event_flood.cu``, built and loaded, and
    the library's error-string function, both typed."""
    lib = _build.load("event_flood")
    fn, err = lib.event_flood, lib.event_flood_error
    fn.argtypes, fn.restype = _ARGTYPES, _CI
    err.argtypes, err.restype = [_CI], ctypes.c_char_p
    return fn, err


def event_flood(has, alive, slot_used, ltime, origin, start_round,
                node_ltime, n_seen, row, budget: int, ttl: int,
                pushpull: bool, out: Flood | None = None,
                scratch: torch.Tensor | None = None) -> Flood:
    """Launch ``event_flood`` of ``csrc/event_flood.cu`` on CUDA tensors
    (the arguments of ``event_flood_ref``; ``row`` contiguous int32 [F +
    3] in device memory, which the kernel reads when it runs): the whole
    event round in one launch.  Returns new tensors, or ``out`` written
    (its ``has`` apart from ``has``).  ``scratch``: a ``flood_scratch``
    that no other launch uses meanwhile (else a new one, a memset).
    Launches on the current stream and does not synchronise.  Raises on
    anything the kernel does not take."""
    global launches
    require_cuda("event_flood", has)
    if has.dim() != 2 or has.dtype != torch.uint8:
        raise ValueError(f"has must be u8 [E, N], got {has.dtype}"
                         f"{list(has.shape)}")
    E, N = has.shape
    dev = has.device
    check_tensor("has", has, torch.uint8, (E, N), dev)
    check_tensor("alive", alive, torch.bool, (N,), dev)
    check_tensor("slot_used", slot_used, torch.bool, (E,), dev)
    for name, t in (("ltime", ltime), ("origin", origin),
                    ("start_round", start_round), ("n_seen", n_seen)):
        check_tensor(name, t, _I32, (E,), dev)
    check_tensor("node_ltime", node_ltime, _I32, (N,), dev)
    F = row.shape[0] - 3 if row.dim() == 1 else 0
    if not 1 <= F <= MAX_FANOUT:
        raise ValueError(f"row must be int32 [F + 3] with F in [1, "
                         f"{MAX_FANOUT}], got {list(row.shape)}")
    check_tensor("row", row, _I32, (F + 3,), dev)
    if E > MAX_SLOTS:
        raise ValueError(f"E must be at most {MAX_SLOTS}, got {E}")
    if N >= 2**31 - 8:
        raise ValueError(f"N must be below 2**31 - 8, got {N}")
    if out is None:
        out = Flood(*(torch.empty_like(t) for t in (
            has, slot_used, origin, node_ltime, n_seen, n_seen)))
    else:
        for name, t, ref in zip(Flood._fields, out, (
                has, slot_used, origin, node_ltime, n_seen, n_seen)):
            check_tensor(f"out.{name}", t, ref.dtype, tuple(ref.shape), dev)
        if out.has.data_ptr() == has.data_ptr():
            raise ValueError("out.has must not be has: the flood reads "
                             "neighbouring columns")
    if E == 0 or N == 0:
        out.node_ltime.copy_(node_ltime)
        out.n_seen.copy_(n_seen)
        return out
    if scratch is None:
        scratch = flood_scratch(E, N, dev)
    check_tensor("scratch", scratch, _I32, (scratch_words(E, N),), dev)
    _build.launch(*_lib(), "event_flood", dev, has.data_ptr(),
                  alive.data_ptr(), slot_used.data_ptr(), ltime.data_ptr(),
                  origin.data_ptr(), start_round.data_ptr(),
                  node_ltime.data_ptr(), n_seen.data_ptr(),
                  out.has.data_ptr(), out.slot_used.data_ptr(),
                  out.origin.data_ptr(), out.node_ltime.data_ptr(),
                  out.n_seen.data_ptr(), out.alive_seen.data_ptr(),
                  scratch.data_ptr(), E, N, F, row.data_ptr(),
                  int(budget), int(ttl), int(bool(pushpull)))
    launches += 1
    launch_shapes.add((E, N, F, int(budget), int(ttl), bool(pushpull)))
    return out


def flood(has, alive, slot_used, ltime, origin, start_round, node_ltime,
          n_seen, row, budget: int, ttl: int, pushpull: bool,
          out: Flood | None = None,
          scratch: torch.Tensor | None = None) -> Flood:
    """One event round on ``[E, N]``: the kernel on CUDA tensors, its
    plain version on CPU tensors (``out`` and ``scratch`` as
    ``event_flood`` takes them; the plain version needs no scratch)."""
    args = (has, alive, slot_used, ltime, origin, start_round, node_ltime,
            n_seen, row, budget, ttl, pushpull, out)
    if launch_log is not None:
        launch_log.append(("event_flood", tuple(has.shape), row.shape[0],
                           int(budget), int(ttl), bool(pushpull)))
    if has.device.type == "cpu":
        return event_flood_ref(*args)
    return event_flood(*args, scratch=scratch)


def is_pushpull(p: SwimParams, rnd: int) -> bool:
    """Whether round ``rnd`` is a push/pull round (the reference's
    ``lax.cond`` predicate, on the host mirror)."""
    return bool(p.pushpull_every) and (rnd % p.pushpull_every
                                       == p.pushpull_every - 1)


# The fields of EventState that an event round writes (it only reads the
# rest).
ROUND_WRITES = ("round", "has", "slot_used", "origin", "node_ltime",
                "n_seen")


def _event_round(state: EventState, row: torch.Tensor, alive: torch.Tensor,
                 p: SwimParams, pushpull: bool,
                 dst: EventState | None = None,
                 held: torch.Tensor | None = None,
                 scratch: torch.Tensor | None = None):
    """One gossip round of event flooding from its table row ``row``
    (device int32 ``[rnd, o .., pp_o, -pp_o]``, ``rnd`` equal to
    ``state.round``); ``pushpull`` is the round's variant.  Returns the
    new state and each slot's live holders after the round: new tensors,
    or, with ``dst`` (a state whose ``ROUND_WRITES`` tensors are apart
    from ``state``'s) and ``held`` (int32 [E]), those written in place,
    the flood taking ``scratch`` (``flood``)."""
    out = None if dst is None else Flood(
        has=dst.has, slot_used=dst.slot_used, origin=dst.origin,
        node_ltime=dst.node_ltime, n_seen=dst.n_seen, alive_seen=held)
    fl = flood(state.has, alive, state.slot_used, state.ltime, state.origin,
               state.start_round, state.node_ltime, state.n_seen, row,
               p.spread_budget_rounds, p.event_ttl_rounds, pushpull,
               out=out, scratch=scratch)
    rnd = (state.round + 1 if dst is None
           else torch.add(state.round, 1, out=dst.round))
    new = state._replace(round=rnd, has=fl.has, slot_used=fl.slot_used,
                         origin=fl.origin, node_ltime=fl.node_ltime,
                         n_seen=fl.n_seen)
    return new, fl.alive_seen


def _alive_on(alive, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(alive).to(device=dev, dtype=torch.bool)


def event_round(state: EventState, base_key, alive, p: SwimParams,
                graphed: bool | None = None) -> EventState:
    """One gossip round of event flooding (reference ``event_round``);
    ``base_key`` is a ``prng`` key.  On a card a replay of the event
    program (``graphed=False``: the eager round there)."""
    return run_event_rounds(state, base_key, alive, p, 1, graphed)[0]


def _coverage_of(alive_seen: torch.Tensor, alive: torch.Tensor
                 ) -> torch.Tensor:
    """``coverage`` from the flood's count of live holders (the same
    int32 / int32 in float32)."""
    n_alive = alive.sum(dtype=_I32).clamp(min=1)
    return alive_seen.to(torch.float32) / n_alive.to(torch.float32)


def coverage(state: EventState, alive) -> torch.Tensor:
    """Fraction of alive nodes that have seen each event slot [E]
    (float32, as the reference's int32 / int32)."""
    alive = _alive_on(alive, state.has.device)
    seen = ((state.has & _SEEN) > 0) & alive[None, :]
    n_alive = alive.sum(dtype=_I32).clamp(min=1)
    return (seen.sum(dim=1, dtype=_I32).to(torch.float32)
            / n_alive.to(torch.float32))


def run_event_rounds(state: EventState, base_key, alive, p: SwimParams,
                     steps: int, graphed: bool | None = None):
    """``steps`` rounds (reference ``run_event_rounds``): returns the
    state and the per-round coverage trace ``[steps, E]``.  On a card the
    rounds are replays of ``gossip/program.py``'s ``EventProgram``;
    ``graphed=False`` runs the eager rounds there instead (the plain
    version, bit-identical; the CPU always runs it).  One device->host
    read per call (the round counter)."""
    dev = state.has.device
    alive = _alive_on(alive, dev)
    if graphed is None:
        graphed = dev.type == "cuda"
    if graphed:
        if dev.type != "cuda":
            raise ValueError(f"graphed rounds run on a CUDA card, not {dev}")
        from consul_tpu_torch.gossip import program
        return program.run_event_rounds(state, base_key, alive, p, steps)
    rnd0 = _host_int(state.round)
    table = round_args.to_device(
        round_args.build_events(p, base_key, rnd0, steps), dev)
    covs = []
    for k in range(steps):
        state, held = _event_round(state, table[k], alive, p,
                                   is_pushpull(p, rnd0 + k))
        covs.append(_coverage_of(held, alive))
    cov = (torch.stack(covs) if covs else
           torch.zeros((0, state.has.shape[0]), dtype=torch.float32,
                       device=dev))
    return state, cov
