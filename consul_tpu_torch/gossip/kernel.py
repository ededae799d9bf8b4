"""The SWIM round on torch tensors: failure detection + dissemination.

Port of ``consul_tpu/gossip/kernel.py`` (the reference; its module
docstring explains the protocol, the ``heard [S, N]`` belief-byte layout
and the circulant gossip graph).  Under the same key and inputs this
round is bit-identical to the reference's — every field of
``SwimState``, ``FlightRing``, ``HistBank``, ``NemState`` and
``RoundTrace`` (``tests/test_torch_kernel.py``; under each nemesis
scenario, ``tests/test_torch_nemesis.py``).

How the JAX program maps onto eager PyTorch:

- ``jit`` has no counterpart; ``lax.scan`` is the Python loop of
  ``run_rounds``.
- The PRNG key lives on the host (``consul_tpu_torch.prng``); keys and
  the small offset draws are host integers, the per-prober uniforms are
  drawn on the device.
- ``run_rounds`` mirrors the round counter on the host (one read per
  call), so everything derived from ``rnd`` — the prober block, the
  push/pull cadence — costs no device→host read.
- Each ``lax.cond`` on a device value becomes a host branch on one read:
  ``n_active`` once per round (quiescent / hot / full tail) and
  ``any_join`` once per round when ``join_round`` is passed.
  ``host_syncs`` counts every such read.
- ``.at[i].set/add(..., mode="drop")`` scatters, whose dropped indices
  equal the axis size, write into a padded sink element that is sliced
  off (``_set_drop``/``_add_drop``); torch would raise on them.
- The hot tier's ``top_k`` over a 0/1 vector (ties to the lowest index)
  is a stable argsort.
- A nemesis schedule (``gossip/nemesis.py``) is decided on the host
  where it can be: the fault window is a host test on the mirrored
  round, and a drop draw whose outcome is certain (outside the window,
  a drop probability of 0 or 1, a prober block with no degraded
  observer) is not made.  Every draw has its own key (``fold_in`` and
  ``split``, never a sequence), so skipping one changes no other.

Tensors are never modified in place except those the round allocated
itself (the belief matrix after the probe tick's rearm clear, the rows
produced by the dissemination tail): the caller's state is left intact.

The sharded round (``run_rounds_sharded``, the reference's "ICI
sharding" section) is the same code with ``sc`` set: the belief matrix
is a tuple of column shards and the branches sit where the reference's
do (the sharding section below).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch import prng
from consul_tpu_torch._device import resolve_device
from consul_tpu_torch.gossip.nemesis import NemesisParams
from consul_tpu_torch.gossip.params import SwimParams
from consul_tpu_torch.obs.constants import LATENCY_BUCKETS as _HIST_LAT
from consul_tpu_torch.obs.constants import N_COLS as _FLIGHT_COLS
from consul_tpu_torch.obs.constants import SPREAD_BUCKETS as _HIST_SPREAD

MSG_NONE = 0
MSG_SUSPECT = 1
MSG_DEAD = 2
MSG_REFUTE = 3   # alive@inc: refutations AND join announcements

PHASE_FREE = 0
PHASE_SUSPECT = 1
PHASE_DEAD = 2
PHASE_REFUTED = 3
PHASE_JOIN = 4   # alive@inc dissemination for a node joining the pool

NEVER = np.int32(2**31 - 1)  # fail_round value for "never fails"

_MSG_SHIFT = 6
_CONF_SHIFT = 4
_CONF_MASK = 0x3
_AGE_MASK = 0xF
_AGE_FRESH = 0xF  # sentinel: written by this round's probe marks, pre-aging

_I32 = torch.int32

# Device->host reads made by the round loop (the round counter and the
# flight cursor once per run_rounds call, n_active once per round,
# any_join once per round when join_round is passed).
host_syncs = 0
# Rounds by the tail they took: only "hot" and "full" rounds run the
# dissemination tail (one kernel launch each on a card).
tail_rounds = {"quiescent": 0, "hot": 0, "full": 0}


def _enc(msg: int, conf: int = 0, age: int = 0) -> int:
    return (msg << _MSG_SHIFT) | (conf << _CONF_SHIFT) | age


def _host_int(t: torch.Tensor) -> int:
    global host_syncs
    host_syncs += 1
    return int(t)


class SwimState(NamedTuple):
    """One LAN pool's protocol state (fields as in the reference)."""

    round: torch.Tensor          # i32 scalar — current gossip round
    heard: torch.Tensor          # u8  [S, N] — per-(slot, observer) belief
    slot_node: torch.Tensor      # i32 [S] — subject node id, -1 = free
    slot_phase: torch.Tensor     # i32 [S] — PHASE_*
    slot_inc: torch.Tensor       # i32 [S] — incarnation the episode speaks at
    slot_start: torch.Tensor     # i32 [S] — round the episode began
    slot_nsusp: torch.Tensor     # i32 [S] — independent suspicion initiators
    slot_dead_round: torch.Tensor  # i32 [S] — verdict round, -1 in suspicion
    slot_of_node: torch.Tensor   # i32 [N] — node -> slot, -1 = none
    incarnation: torch.Tensor    # i32 [N] — per-node incarnation counter
    member: torch.Tensor         # bool [N] — current cluster membership
    # i32 accumulators, wrapping mod 2**32 like the reference's.
    drops: torch.Tensor          # i32 — suspicion initiations lost to full slots
    n_detected: torch.Tensor     # i32 — true failures detected
    sum_detect_rounds: torch.Tensor  # i32 — sum of (dead_round - fail_round)
    n_false_dead: torch.Tensor   # i32 — alive nodes declared dead
    n_refuted: torch.Tensor      # i32 — episodes ended by refutation


def init_state(p: SwimParams, device=None) -> SwimState:
    dev = resolve_device(device)
    S, N = p.slots, p.n

    def z(*shape):
        return torch.zeros(shape, dtype=_I32, device=dev)

    return SwimState(
        round=z(),
        heard=torch.zeros((S, N), dtype=torch.uint8, device=dev),
        slot_node=torch.full((S,), -1, dtype=_I32, device=dev),
        slot_phase=z(S),
        slot_inc=z(S),
        slot_start=z(S),
        slot_nsusp=z(S),
        slot_dead_round=torch.full((S,), -1, dtype=_I32, device=dev),
        slot_of_node=torch.full((N,), -1, dtype=_I32, device=dev),
        incarnation=z(N),
        member=torch.ones((N,), dtype=torch.bool, device=dev),
        drops=z(),
        n_detected=z(),
        sum_detect_rounds=z(),
        n_false_dead=z(),
        n_refuted=z(),
    )


class FlightRing(NamedTuple):
    """Flight-recorder ring: one i32 row per round (column layout
    ``obs.constants.FLIGHT_COLS``) at ``cursor % R``."""

    rows: torch.Tensor    # i32 [R, N_COLS]
    cursor: torch.Tensor  # i32 scalar — total rows ever written


def init_flight(ring_rounds: int = 256, device=None) -> FlightRing:
    dev = resolve_device(device)
    return FlightRing(
        rows=torch.zeros((ring_rounds, _FLIGHT_COLS), dtype=_I32, device=dev),
        cursor=torch.zeros((), dtype=_I32, device=dev))


class HistBank(NamedTuple):
    """Detection-latency observatory banks (layouts in the reference's
    ``obs/hist.py``)."""

    detect: torch.Tensor  # i32 [LATENCY_BUCKETS] — fail_round -> dead verdict
    dwell: torch.Tensor   # i32 [LATENCY_BUCKETS] — episode start -> verdict
    refute: torch.Tensor  # i32 [LATENCY_BUCKETS] — episode start -> refute
    spread: torch.Tensor  # i32 [SPREAD_BUCKETS] — verdict holders at slot GC


def init_hist(device=None) -> HistBank:
    dev = resolve_device(device)
    return HistBank(*(torch.zeros((b,), dtype=_I32, device=dev)
                      for b in (_HIST_LAT, _HIST_LAT, _HIST_LAT,
                                _HIST_SPREAD)))


class NemState(NamedTuple):
    """Per-node Lifeguard local-health registers, threaded through the
    round when a nemesis scenario needs them (``needs_state``).  Held
    once under sharding, like every register but ``heard``."""

    lhm: torch.Tensor     # i32 [N] — local-health multiplier, [0, lhm_max]
    streak: torch.Tensor  # i32 [N] — consecutive direct-probe misses,
                          #   clamped at lhm_max + 1


def init_nem_state(n: int, device=None) -> NemState:
    dev = resolve_device(device)
    return NemState(lhm=torch.zeros((n,), dtype=_I32, device=dev),
                    streak=torch.zeros((n,), dtype=_I32, device=dev))


class RoundTrace(NamedTuple):
    """Per-round observables emitted by run_rounds (small: O(S))."""

    slot_node: torch.Tensor       # [T, S]
    slot_phase: torch.Tensor      # [T, S]
    slot_start: torch.Tensor      # [T, S]
    slot_dead_round: torch.Tensor  # [T, S]
    n_heard_dead: torch.Tensor    # [T, S] — members that hold the dead verdict
    n_heard_alive: torch.Tensor   # [T, S] — members that hold the alive@inc


# -- scatter helpers -----------------------------------------------------------

def _set_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` for a 1-D ``x`` whose dropped
    indices equal ``len(x)``: write into a padded sink element, slice it
    off.  The kept indices are distinct at every call site."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros(1)])
    if not isinstance(val, torch.Tensor):
        # A fill on the device, not a host->device copy (which would
        # synchronise the stream).
        val = out.new_full(idx.shape, val)
    out[idx.long()] = val
    return out[:n]


def _add_drop(x: torch.Tensor, idx: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].add(val, mode="drop")``: duplicates accumulate, the
    sink index ``len(x)`` is dropped."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros(1)])
    out.index_add_(0, idx.long(), val.to(x.dtype))
    return out[:n]


def _dslice(x: torch.Tensor, start: int, size: int) -> torch.Tensor:
    """``lax.dynamic_slice`` along dim 0 with a host start (clamped so
    the window fits, as XLA clamps it)."""
    start = min(max(start, 0), x.shape[0] - size)
    return x[start:start + size]


def _hist_add(bank: torch.Tensor, mask: torch.Tensor,
              val: torch.Tensor) -> torch.Tensor:
    """Scatter masked observations into a bank: value clipped into the
    top (overflow) bucket, unmasked lanes dropped."""
    B = bank.shape[0]
    idx = torch.where(mask, val.clamp(0, B - 1), B)
    return _add_drop(bank, idx, mask.to(_I32))


@functools.lru_cache(maxsize=64)
def _timeout_table(p: SwimParams, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(p.timeout_table(), device=device)


# -- nemesis injection (the reference's statics, decided on the host) ---------

@functools.lru_cache(maxsize=32)
def _nem_group(nem: NemesisParams, n: int, device) -> torch.Tensor:
    """Partition group bit per node, i32 [n] (``nemesis.group_of`` bit
    for bit), built once per (schedule, n, device).  The hash is the
    uint32 product's top bit, carried in int64."""
    ids = torch.arange(n, dtype=torch.int64, device=device)
    if nem.part_kind == "hash":
        return (((ids * 2654435761) & 0xFFFFFFFF) >> 31).to(_I32)
    return (ids >= n // 2).to(_I32)


@functools.lru_cache(maxsize=32)
def _nem_flap_ids(nem: NemesisParams, n: int, device) -> torch.Tensor:
    ids = torch.arange(n, dtype=_I32, device=device)
    return (ids >= nem.flap_lo) & (ids < nem.flap_hi)


def _nem_in_window(nem: NemesisParams, rnd: int) -> bool:
    return nem.start <= rnd < nem.stop


def _nem_schedule(nem: NemesisParams, rnd: int, fail_round, join_round):
    """The round's injection schedule on the ground-truth inputs
    (reference ``_nem_schedule``): a flapping node's down phase fails it
    now, its up phase re-arms ``join_round``; after a healed partition
    every node is join-pending (the join tick ignores members)."""
    if nem.has_flap:
        flap = _nem_flap_ids(nem, fail_round.shape[0], fail_round.device)
        down_phase = ((rnd - nem.start) % nem.flap_period) >= nem.flap_up
        if _nem_in_window(nem, rnd) and down_phase:
            fail_round = torch.where(flap, fail_round.clamp(max=rnd),
                                     fail_round)
        else:
            join_round = torch.where(flap, join_round.clamp(max=rnd),
                                     join_round)
    if nem.heal_rejoin:
        join_round = join_round.clamp(max=nem.stop)
    return fail_round, join_round


def _draw_below(key, shape, p: float, device) -> torch.Tensor:
    """``uniform(key, shape) < p`` for a float32 ``p``; a certain outcome
    (``p`` <= 0 or >= 1, the draw being in [0, 1)) is not drawn."""
    if p <= 0.0 or p >= 1.0:
        return torch.full(shape, p >= 1.0, dtype=torch.bool, device=device)
    return prng.uniform_tensor(key, shape, device) < p


def _nem_edge_drops(nem: NemesisParams, n: int, device, keys,
                    shifts) -> torch.Tensor:
    """Bool ``[len(shifts), n]``: where a message into destination ``d``
    along shift ``o`` (sender ``d - o``) is dropped inside the fault
    window — cross-group senders at their group's edge probability, one
    ``uniform(keys[j], (n,))`` per shift (reference ``_nem_leg_drop``
    and the push/pull legs)."""
    grp = _nem_group(nem, n, device)
    g_src = torch.stack([torch.roll(grp, o) for o in shifts])
    cross = g_src != grp
    p_ab, p_ba = _f32(nem.p_ab), _f32(nem.p_ba)
    if all(q <= 0.0 or q >= 1.0 for q in (p_ab, p_ba)):
        # Certain: every cross edge of a direction drops, or none does.
        if (p_ab >= 1.0) == (p_ba >= 1.0):
            return cross if p_ab >= 1.0 else torch.zeros_like(cross)
        return cross & ((g_src == 0) == (p_ab >= 1.0))
    p_edge = torch.where(g_src == 0, p_ab, p_ba)
    return cross & (prng.uniform_rows(keys, n, device) < p_edge)


# -- sharding along the observer axis -----------------------------------------
#
# The reference's "ICI sharding" section, from one controller.  Only the
# [S, N] belief matrix is sharded: ``heard`` becomes a tuple of ``ndev``
# contiguous u8 [S, L] tensors, shard i holding observer columns
# [i*L, (i+1)*L).  Every other register is held once — the reference
# replicates them by construction, so one copy is exact.  Its
# collectives become tensor code on this known layout: a ppermute is
# indexing into the shard list, a psum the sum of the per-shard
# contributions.  Every shift (gossip offsets, the push/pull shift, the
# prober block) is a host int, so each shard boundary is host
# arithmetic and the sharded round makes no device->host read that the
# single-device round does not.  Bytes cross between shards only in
# ``_roll_sharded``, ``_psum`` and the dissemination tail's merge kernel
# (``fused.fused_merge``, which reads its pins from every shard through a
# table of shard pointers); placing the shards on several cards changes
# those three.

class _ShardCtx(NamedTuple):
    """Sharding context threaded through the round phases; ``None``
    everywhere means the single-device round."""

    ndev: int   # shards along the observer axis
    L: int      # observer columns per shard (N // ndev)


def _sharded(heard) -> bool:
    return isinstance(heard, tuple)


def _per_shard(sc, heard, fn):
    """``fn`` on the matrix, or on each shard of a sharded one."""
    return fn(heard) if sc is None else tuple(fn(h) for h in heard)


def _sloc(sc: _ShardCtx, v: torch.Tensor, i: int) -> torch.Tensor:
    """Shard ``i``'s [L] slice of an [N] per-node vector (a view)."""
    return v[i * sc.L:(i + 1) * sc.L]


def _sloc_roll(sc: _ShardCtx, v: torch.Tensor, o: int, i: int) -> torch.Tensor:
    """Shard ``i``'s [L] slice of ``torch.roll(v, o)``: a view, or two
    slices joined where the window wraps."""
    n = v.shape[0]
    start = (i * sc.L - o) % n
    if start + sc.L <= n:
        return v[start:start + sc.L]
    return torch.cat([v[start:], v[:start + sc.L - n]])


def _owned(sc: _ShardCtx, cols: torch.Tensor, i: int):
    """Which global columns ``cols`` shard ``i`` owns, and their local
    column as an index (clamped into the shard where not owned)."""
    base = i * sc.L
    return ((cols >= base) & (cols < base + sc.L),
            (cols - base).clamp(0, sc.L - 1).long())


def _roll_sharded(sc: _ShardCtx, xs, o: int, out=None):
    """Global ``torch.roll(x, o, dims=-1)`` of a sharded ``x``.

    With ``q, r = divmod(o mod N, L)``, output shard ``i`` is the last
    ``r`` columns of source shard ``(i - q - 1) % ndev`` followed by the
    first ``L - r`` columns of source shard ``(i - q) % ndev``.  ``out``
    (one tensor per shard) receives the result in place."""
    L, nd = sc.L, sc.ndev
    q, r = divmod(o % (L * nd), L)
    res = []
    for i in range(nd):
        prev, this = xs[(i - q - 1) % nd], xs[(i - q) % nd]
        parts = [prev[..., L - r:], this[..., :L - r]] if r else [this]
        if out is not None:
            res.append(torch.cat(parts, dim=-1, out=out[i]))
        else:
            res.append(torch.cat(parts, dim=-1) if r else this)
    return tuple(res)


def _psum(parts):
    """The reference's psum over the shard axis: the sum of the
    per-shard contributions."""
    return functools.reduce(torch.add, parts)


def _win_read(sc: _ShardCtx, hs, blk: int, B: int) -> torch.Tensor:
    """The [S, B] window ``heard[:, blk:blk+B]`` of the sharded matrix.
    It never wraps (``N = B * probe_every``, ``_check_shardable``) and
    spans one, two or three shards: each contributes its overlap, zero
    elsewhere, and ``_psum`` merges the disjoint parts exactly."""
    parts = []
    for i, h in enumerate(hs):
        lo, hi = max(blk, i * sc.L), min(blk + B, (i + 1) * sc.L)
        if lo < hi:
            parts.append(torch.nn.functional.pad(
                h[:, lo - i * sc.L:hi - i * sc.L], (lo - blk, blk + B - hi)))
    return _psum(parts)


def _win_write(sc: _ShardCtx, hs, win: torch.Tensor, blk: int,
               B: int) -> None:
    """Write the [S, B] window ``win`` into columns [blk, blk+B) of the
    sharded matrix, in place: each shard takes only the columns it
    owns."""
    for i, h in enumerate(hs):
        lo, hi = max(blk, i * sc.L), min(blk + B, (i + 1) * sc.L)
        if lo < hi:
            h[:, lo - i * sc.L:hi - i * sc.L] = win[:, lo - blk:hi - blk]


# -- round phases --------------------------------------------------------------

def _age_tick(heard: torch.Tensor) -> torch.Tensor:
    """Advance every in-flight rumor's age by one round: fresh marks
    (``_AGE_FRESH``) become 0, real ages saturate at 14, message-free
    bytes are untouched."""
    msg = heard >> _MSG_SHIFT
    age = heard & _AGE_MASK
    new_age = torch.where(age == _AGE_FRESH, 0,
                          torch.clamp(age + 1, max=_AGE_MASK - 1))
    aged = (heard & (0xFF ^ _AGE_MASK)) | new_age.to(torch.uint8)
    return torch.where(msg > 0, aged, heard)


def alloc_free_slots(free: torch.Tensor, want: torch.Tensor):
    """Rank the True entries of ``want`` onto the free slots of ``free``
    in ascending slot order.  Returns ``(can, slot_ids, sidx)``: ``can``
    marks served entries, ``slot_ids`` their slots, and ``sidx`` the slot
    id for served entries and ``len(free)`` (the drop sink) otherwise."""
    S = free.shape[0]
    free_order = torch.argsort(torch.where(free, 0, 1),
                               stable=True).to(_I32)
    n_free = free.sum(dtype=_I32)
    rank = torch.cumsum(want.to(_I32), 0, dtype=_I32) - 1
    can = want & (rank < n_free)
    slot_ids = free_order[rank.clamp(0, S - 1).long()]
    sidx = torch.where(can, slot_ids, S)
    return can, slot_ids, sidx


def _segment_min(masked: torch.Tensor, kk: int, fill: int) -> torch.Tensor:
    """Min over ``kk`` contiguous segments (padded with ``fill``)."""
    GB = -(-masked.shape[0] // kk)
    pad = kk * GB - masked.shape[0]
    if pad:
        masked = torch.cat([masked, masked.new_full((pad,), fill)])
    return masked.view(kk, GB).amin(dim=1)


def _join_tick(p: SwimParams, rnd: int, carry, join_round, fail_round,
               sc: _ShardCtx | None = None):
    """Activate pending joins (reference ``_join_tick``): a pending node
    that wins a rumor slot becomes a member at a bumped incarnation, any
    stale episode about it clears, and its PHASE_JOIN slot floods the
    alive@inc announcement.  Losers retry next round."""
    (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
     slot_dead_round, slot_of_node, incarnation, member, drops) = carry
    N, S = p.n, p.slots
    dev = member.device

    pending = (join_round <= rnd) & ~member & (fail_round > rnd)
    masked = torch.where(pending, torch.arange(N, dtype=_I32, device=dev), N)
    cand = _segment_min(masked, min(S, N), N)
    in_dom = cand < N
    can_k, slot_k, sidx = alloc_free_slots(slot_node < 0, in_dom)
    cand_c = cand.clamp(0, N - 1)

    joining = _set_drop(torch.zeros((N,), dtype=torch.bool, device=dev),
                        torch.where(can_k, cand_c, N), True)
    incarnation = incarnation + joining.to(_I32)
    member = member | joining

    # Clear any stale episode about a rejoining winner.
    node_c0 = slot_node.clamp(0, N - 1)
    stale = (slot_node >= 0) & joining[node_c0.long()]
    heard = _per_shard(sc, heard, lambda h: h.masked_fill(stale[:, None], 0))
    slot_of_node = _set_drop(slot_of_node, torch.where(stale, node_c0, N), -1)
    slot_node = torch.where(stale, -1, slot_node)
    slot_phase = torch.where(stale, PHASE_FREE, slot_phase)
    slot_dead_round = torch.where(stale, -1, slot_dead_round)

    slot_node = _set_drop(slot_node, sidx, cand_c)
    slot_phase = _set_drop(slot_phase, sidx, PHASE_JOIN)
    slot_inc = _set_drop(slot_inc, sidx, incarnation[cand_c.long()])
    slot_start = _set_drop(slot_start, sidx, rnd)
    slot_nsusp = _set_drop(slot_nsusp, sidx, 0)
    # The join IS the episode's verdict (verdict-done GC).
    slot_dead_round = _set_drop(slot_dead_round, sidx, rnd)
    slot_of_node = _set_drop(slot_of_node, torch.where(can_k, cand_c, N),
                             slot_k)
    # The joiner seeds its own announcement flood: heard[sidx, cand] on
    # the flattened matrix, sink S*N for unserved candidates.  Sharded:
    # the seed column belongs to one shard; the others drop the write.
    seed = _enc(MSG_REFUTE, age=_AGE_FRESH)
    if sc is None:
        flat = torch.where(sidx < S, sidx.long() * N + cand_c, S * N)
        heard = _set_drop(heard.reshape(-1), flat, seed).view(S, N)
    else:
        shards = []
        for i, h in enumerate(heard):
            owned, loc = _owned(sc, cand_c, i)
            flat = torch.where(owned & (sidx < S), sidx * sc.L + loc,
                               S * sc.L)
            shards.append(_set_drop(h.reshape(-1), flat, seed).view(S, sc.L))
        heard = tuple(shards)

    return (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
            slot_dead_round, slot_of_node, incarnation, member, drops)


def _block_size(p: SwimParams) -> int:
    """Probers per round: each node probes once per ``probe_every``
    rounds, in contiguous id blocks."""
    return max(1, -(-p.n // p.probe_every))


def _f32(x: float) -> float:
    """A Python float compared against a float32 draw: jax rounds the
    weakly typed constant to float32 first."""
    return float(np.float32(x))


def _probe_tick(p: SwimParams, rnd: int, keys, mf, carry,
                sc: _ShardCtx | None = None,
                nem: NemesisParams | None = None,
                nem_state: NemState | None = None):
    """One round's probe slice: direct probe -> k indirect probes ->
    suspicion initiation for this round's prober block (reference
    ``_probe_tick``).  ``mf`` packs membership and ground truth:
    ``member ? fail_round : -1``.

    ``nem`` adds the nemesis probe legs: cross-group round-trip drops
    and a degraded observer's missed replies; with ``nem_state`` also
    Lifeguard's local-health multiplier, which holds back a prober's
    suspicion until it has missed more probes in a row than its LHM.
    Returns ``(carry, probe_stats, nem_state)``."""
    (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
     slot_dead_round, slot_of_node, incarnation, member, drops) = carry
    k_t, k_dl, k_h, k_hl = keys
    N, S = p.n, p.slots
    B = _block_size(p)
    dev = mf.device

    # This round's probers: block (rnd % probe_every); ids >= N are
    # padding lanes on the final block and initiate nothing.
    blk = (rnd % p.probe_every) * B
    pid = blk + torch.arange(B, dtype=_I32, device=dev)
    pid_c = pid.clamp(max=N - 1)
    pvalid = pid < N

    mf2 = torch.cat([mf, mf])

    def _mf_block(offset):
        return _dslice(mf2, (blk + offset) % N, B)

    # Direct-probe target pid + o_t, offsets in [1, N-1].
    offs = [int(o) for o in prng.randint(k_t, (1 + p.indirect_k,), 1, N)]
    tgt = (pid_c + offs[0]) % N
    prober_ok = pvalid & (_dslice(mf2, blk, B) > rnd)
    mf_t = _mf_block(offs[0])
    tgt_member = mf_t >= 0
    tgt_alive = mf_t > rnd

    # -- nemesis probe legs, off the probe key k_h (split four ways);
    # inside the fault window only, so outside it nothing is drawn.
    # ``part`` (the partition legs) and ``degraded`` (this block's slow
    # observers) stay None where they cannot drop anything.
    part = degraded = dir_nem_drop = None
    if nem is not None and (nem.has_partition or nem.has_degraded):
        k_np, k_no, k_nip, k_nio = prng.split(k_h, 4)
        in_win = _nem_in_window(nem, rnd)
        if nem.has_partition and in_win:
            grp2 = torch.cat([_nem_group(nem, N, dev)] * 2)
            g_p = _dslice(grp2, blk, B)
            g_t = _dslice(grp2, (blk + offs[0]) % N, B)
            part = (grp2, g_p, g_t)
            # A round trip crosses both directions once: the drop
            # probability does not depend on the direction.
            dir_nem_drop = (g_p != g_t) & _draw_below(
                k_np, (B,), _f32(nem.p_roundtrip), dev)
        if (nem.has_degraded and in_win and blk < nem.obs_hi
                and blk + B > nem.obs_lo):
            degraded = (pid >= nem.obs_lo) & (pid < nem.obs_hi)
            miss = degraded & _draw_below(k_no, (B,), _f32(nem.p_obs_miss),
                                          dev)
            dir_nem_drop = miss if dir_nem_drop is None else (
                dir_nem_drop | miss)

    u = prng.uniform_tensor(k_dl, (B,), dev)
    lost = ~tgt_alive | (u < _f32(p.p_direct_fail_alive))
    if dir_nem_drop is not None:
        lost = lost | dir_nem_drop
    direct_fail = tgt_member & lost

    if p.indirect_k:
        hu = prng.uniform_tensor(k_hl, (B, p.indirect_k), dev)
        helper_alive = torch.stack(
            [_mf_block(offs[1 + j]) > rnd for j in range(p.indirect_k)],
            dim=1)
        ind_ok = (helper_alive & (tgt_alive & tgt_member)[:, None]
                  & (hu >= _f32(p.p_indirect_fail_alive)))
        if part is not None:
            # Prober<->helper and helper<->target are each a round trip
            # that crosses or not; one draw per helper at the combined
            # drop probability of its crossings.
            grp2, g_p, g_t = part
            g_h = torch.stack([_dslice(grp2, (blk + offs[1 + j]) % N, B)
                               for j in range(p.indirect_k)], dim=1)
            n_cross = ((g_p[:, None] != g_h).to(_I32)
                       + (g_h != g_t[:, None]).to(_I32))
            p1 = nem.p_roundtrip
            p_one = _f32(p1)
            p_two = _f32(1.0 - (1.0 - p1) * (1.0 - p1))  # float64 on the host
            shape = (B, p.indirect_k)
            if p_one >= 1.0:
                ind_ok = ind_ok & (n_cross == 0)
            elif p_one > 0.0:
                p_ind = torch.full(shape, p_two, dtype=torch.float32,
                                   device=dev).masked_fill(n_cross == 1, p_one)
                ind_ok = ind_ok & ~((n_cross > 0) & (
                    prng.uniform_tensor(k_nip, shape, dev) < p_ind))
        if degraded is not None:
            # A degraded prober also mishandles replies its helpers
            # relay back.
            ind_ok = ind_ok & ~(degraded[:, None] & _draw_below(
                k_nio, (B, p.indirect_k), _f32(nem.p_obs_miss), dev))
        rescued = ind_ok.any(dim=1)
    else:
        rescued = torch.zeros((B,), dtype=torch.bool, device=dev)
    init = prober_ok & direct_fail & ~rescued

    # Don't re-suspect a target this prober already believes dead.
    # Aligned (N = probe_every * B): prober columns are one contiguous
    # window, read as a slice plus a per-column row pick; otherwise a
    # 2-D gather at (slot, prober).
    aligned = N == B * p.probe_every
    s2 = torch.cat([slot_of_node, slot_of_node])
    s_t = _dslice(s2, (blk + offs[0]) % N, B)
    rows = s_t.clamp(0, S - 1).long()
    if sc is not None:
        # Sharded (aligned by _check_shardable): the window is read once
        # and reused for the post-rearm read below (only the rearm clear
        # touches heard in between, and it is recomputed exactly).
        hblk_pre = _win_read(sc, heard, blk, B)
        cur = hblk_pre.gather(0, rows[None, :])[0]
    elif aligned:
        cur = heard[:, blk:blk + B].gather(0, rows[None, :])[0]
    else:
        cur = heard[rows, pid_c.long()]
    init = init & ~((s_t >= 0) & ((cur >> _MSG_SHIFT) == MSG_DEAD))

    if nem is not None and nem_state is not None:
        # Lifeguard LHM: a prober suspects only after more consecutive
        # direct misses than its LHM (at LHM 0, every miss).  LHM rises
        # on a miss the helpers contradict and falls on a clean probe.
        lhm, streak = nem_state
        lhm_b = _dslice(torch.cat([lhm, lhm]), blk, B)
        streak_b = _dslice(torch.cat([streak, streak]), blk, B)
        miss = prober_ok & tgt_member & direct_fail
        streak_new = torch.where(
            miss, (streak_b + 1).clamp(max=nem.lhm_max + 1), 0)
        init = init & (streak_new > lhm_b)
        lhm_new = (lhm_b + (miss & rescued).to(_I32)
                   - (prober_ok & tgt_member & ~direct_fail).to(_I32)
                   ).clamp(0, nem.lhm_max)
        widx = torch.where(pvalid, pid, N)
        nem_state = NemState(lhm=_set_drop(lhm, widx, lhm_new),
                             streak=_set_drop(streak, widx, streak_new))

    node_c = slot_node.clamp(0, N - 1)
    valid = slot_node >= 0

    # Circulant targets are distinct within a round, so a slot's subject
    # has at most one initiator: i = (subject - blk - o) mod N.
    init_i = init.to(_I32)
    i_s = (node_c - blk - offs[0]) % N
    in_blk = valid & (i_s < B)
    add_here = torch.where(in_blk, init_i[i_s.clamp(max=B - 1).long()], 0)
    slot_want = add_here > 0

    # Existing suspect episodes absorb new initiators.
    slot_nsusp = torch.where((slot_phase == PHASE_SUSPECT) & slot_want,
                             slot_nsusp + add_here, slot_nsusp)

    # A refuted (or freshly-joined) episode whose subject fails probes
    # re-arms as a suspicion at the bumped incarnation.
    rearm = (((slot_phase == PHASE_REFUTED) | (slot_phase == PHASE_JOIN))
             & slot_want)
    slot_phase = torch.where(rearm, PHASE_SUSPECT, slot_phase)
    slot_inc = torch.where(rearm, incarnation[node_c.long()], slot_inc)
    slot_start = torch.where(rearm, rnd, slot_start)
    slot_nsusp = torch.where(rearm, add_here, slot_nsusp)
    slot_dead_round = torch.where(rearm, -1, slot_dead_round)
    # A new tensor (one per shard): from here on the round owns
    # ``heard`` and may write it in place.
    heard = _per_shard(sc, heard, lambda h: h.masked_fill(rearm[:, None], 0))

    # Allocate fresh slots: needy targets compacted to kk candidates
    # with a segmented min, one winner per prober segment.
    need_b = init & (s_t < 0) & (mf_t >= 0)
    masked = torch.where(need_b, tgt, N)
    cand = _segment_min(masked, min(S, N, B), N)
    in_dom = cand < N
    can_k, slot_k, sidx = alloc_free_slots(~valid, in_dom)
    cand_c = cand.clamp(0, N - 1)
    slot_node = _set_drop(slot_node, sidx, cand_c)
    slot_phase = _set_drop(slot_phase, sidx, PHASE_SUSPECT)
    slot_inc = _set_drop(slot_inc, sidx, incarnation[cand_c.long()])
    slot_start = _set_drop(slot_start, sidx, rnd)
    slot_nsusp = _set_drop(slot_nsusp, sidx, 1)
    slot_dead_round = _set_drop(slot_dead_round, sidx, -1)
    slot_of_node = _set_drop(slot_of_node, torch.where(can_k, cand_c, N),
                             slot_k)
    n_need = need_b.sum(dtype=_I32)
    served = can_k.sum(dtype=_I32)
    drops = drops + (n_need - served)

    # Initiators record their own suspicion with a fresh age so the
    # rumor re-enters circulation.
    s2b = torch.cat([slot_of_node, slot_of_node])
    s_t2 = _dslice(s2b, (blk + offs[0]) % N, B)
    rows2 = s_t2.clamp(0, S - 1).long()
    conf_bits = _CONF_MASK << _CONF_SHIFT
    if sc is not None or aligned:
        # Sharded: the post-rearm window, recomputed from the pre-rearm
        # read; the write-back is per shard.
        hblk = (heard[:, blk:blk + B] if sc is None
                else hblk_pre.masked_fill(rearm[:, None], 0))
        cur2 = hblk.gather(0, rows2[None, :])[0]
        mark_ok = (init & (s_t2 >= 0)
                   & ((cur2 >> _MSG_SHIFT) <= MSG_SUSPECT))
        fresh = _enc(MSG_SUSPECT, age=_AGE_FRESH) | (cur2 & conf_bits)
        sel = ((torch.arange(S, device=dev)[:, None] == rows2[None, :])
               & mark_ok[None, :])
        win = torch.where(sel, fresh[None, :], hblk)
        if sc is None:
            heard[:, blk:blk + B] = win
        else:
            _win_write(sc, heard, win, blk, B)
    else:
        cur2 = heard[rows2, pid_c.long()]
        mark_ok = (init & (s_t2 >= 0)
                   & ((cur2 >> _MSG_SHIFT) <= MSG_SUSPECT))
        fresh = _enc(MSG_SUSPECT, age=_AGE_FRESH) | (cur2 & conf_bits)
        flat = torch.where(mark_ok, rows2 * N + pid_c, S * N)
        heard = _set_drop(heard.reshape(-1), flat, fresh).view(S, N)

    probe_stats = (
        prober_ok.sum(dtype=_I32),                                # probes
        (prober_ok & direct_fail).sum(dtype=_I32),                # acks missed
        (prober_ok & direct_fail & tgt_member).sum(dtype=_I32),   # indirect
        init.sum(dtype=_I32),                                     # suspicions
    )
    out_carry = (heard, slot_node, slot_phase, slot_inc, slot_start,
                 slot_nsusp, slot_dead_round, slot_of_node, incarnation,
                 member, drops)
    return out_carry, probe_stats, nem_state


def gossip_offsets(key, n: int, fanout: int) -> list[int]:
    """``fanout`` nonzero circulant shifts for one round's gossip graph:
    node ``i`` pushes to ``i + o_f (mod n)``.  Host integers."""
    return [int(o) for o in prng.randint(key, (fanout,), 1, n)]


def _disseminate(p: SwimParams, rnd: int, k_gossip, heard, mf, rx_ok,
                 conf_cap, sc: _ShardCtx | None = None,
                 nem: NemesisParams | None = None, k_nem=None):
    """One round of rumor push: the dense tail of ``gossip/fused.py`` —
    the Hopper kernels on CUDA tensors, their plain versions on the
    CPU.  Inside a partition's fault window each leg ``f`` drops its
    cross-group deliveries off ``fold_in(k_nem, f)``: the tail takes them
    as its drop operand, ``[fanout, N]`` by destination column."""
    from consul_tpu_torch.gossip.fused import disseminate
    offs = gossip_offsets(k_gossip, p.n, p.fanout)
    drop = None
    if (nem is not None and nem.has_partition
            and _nem_in_window(nem, rnd)):
        drop = _nem_edge_drops(nem, p.n, mf.device,
                               [prng.fold_in(k_nem, f)
                                for f in range(p.fanout)], offs)
    return disseminate(p, rnd, offs, heard, mf, rx_ok, conf_cap, sc, drop)


def _finish_round(p: SwimParams, state: SwimState, rnd: int, fail_round,
                  alive, member, heard_sub, full_heard, idx, slot_node,
                  slot_phase, slot_inc, slot_start, slot_nsusp,
                  slot_dead_round, slot_of_node, incarnation, drops,
                  conf_cap, rx_ok, sc: _ShardCtx | None = None, hist=None,
                  nem: NemesisParams | None = None,
                  nem_state: NemState | None = None):
    """Refutation, suspicion-timer firing, episode GC, stats (reference
    ``_finish_round``).

    Operates on ``heard_sub``, the belief rows of the slots in ``idx``
    (distinct slot ids).  The full path passes ``idx = arange(S)`` with
    ``full_heard=None``; the hot path passes the gathered rows and
    writes them back into ``full_heard``.  Both ``heard_sub`` and
    ``full_heard`` are the round's own tensors (one per shard when
    sharded) and are written in place.  With ``nem_state`` threaded, a
    subject that refuted a suspicion about itself raises its own LHM
    (Lifeguard).  Returns ``(state, hist, nem_state)``."""
    N = p.n
    H = idx.shape[0]
    dev = slot_node.device
    il = idx.long()
    shards = () if sc is None else tuple(enumerate(heard_sub))

    sl_node = slot_node[il]
    sl_phase = slot_phase[il]
    sl_start = slot_start[il]
    sl_dead_round = slot_dead_round[il]
    cc = conf_cap[il]

    # -- refutation: a live subject that hears of its own suspicion
    # bumps its incarnation and spreads alive@inc+1.
    hrows = torch.arange(H, device=dev)
    node_c = sl_node.clamp(0, N - 1)
    ncl = node_c.long()
    n_refuted = state.n_refuted
    refute_now = torch.zeros((H,), dtype=torch.bool, device=dev)
    if p.refute:
        if sc is None:
            own = heard_sub[hrows, ncl]
        else:
            # Each subject's own-belief byte lives on one shard: mask
            # local ownership, psum the disjoint contributions.
            local = []
            for i, h in shards:
                owned, loc = _owned(sc, node_c, i)
                local.append((owned, loc, h[hrows, loc]))
            own = _psum([torch.where(o, b, 0) for o, _, b in local])
        own_msg = own >> _MSG_SHIFT
        refutable = (sl_phase == PHASE_SUSPECT) | (sl_phase == PHASE_DEAD)
        refute_now = (refutable & (sl_node >= 0) & alive[ncl] & member[ncl]
                      & ((own_msg == MSG_SUSPECT) | (own_msg == MSG_DEAD)))
        incarnation = _add_drop(incarnation,
                                torch.where(refute_now, node_c, N),
                                torch.ones_like(node_c))
        sl_phase = torch.where(refute_now, PHASE_REFUTED, sl_phase)
        sl_dead_round = torch.where(refute_now, rnd, sl_dead_round)
        # .at[hrows, node_c].max(refute_val): one (row, column) pair per
        # row, so a gather, a max and a put.
        refute_val = torch.where(refute_now, _enc(MSG_REFUTE), 0).to(
            torch.uint8)
        if sc is None:
            heard_sub[hrows, ncl] = torch.maximum(own, refute_val)
        else:
            # Written only on the owning shard.
            new = torch.maximum(own, refute_val)
            for (i, h), (owned, loc, byte) in zip(shards, local):
                h[hrows, loc] = torch.where(owned, new, byte)
        n_refuted = n_refuted + refute_now.sum(dtype=_I32)

    if nem is not None and nem_state is not None:
        # Subjects are distinct node ids: at most one bump a node.
        lhm = _add_drop(nem_state.lhm, torch.where(refute_now, node_c, N),
                        torch.ones_like(node_c)).clamp(max=nem.lhm_max)
        nem_state = nem_state._replace(lhm=lhm)

    # -- suspicion timers fire -> dead declared.  The reference looks up
    # tbl[min(conf, cc)] per byte; conf is 2 bits, so per row the four
    # outcomes "elapsed >= tbl[min(c, cc)]" fold into a 4-bit mask that
    # each byte indexes by its conf — the same bits without an int32
    # [H, N] intermediate.
    tbl = _timeout_table(p, dev)
    cs = torch.arange(4, device=dev)
    elapsed = rnd - sl_start
    ok = elapsed[:, None] >= tbl[torch.minimum(cs[None, :], cc[:, None].long())]
    ok = ok & (sl_phase == PHASE_SUSPECT)[:, None]
    ok_mask = (ok.to(torch.uint8) << cs.to(torch.uint8)).sum(
        dim=1, dtype=torch.uint8)

    def _fire(h, rx):
        # Bytes whose timer fires take the dead verdict; returns which
        # rows (slots) fired.
        conf = (h >> _CONF_SHIFT) & _CONF_MASK
        fire = (((h >> _MSG_SHIFT) == MSG_SUSPECT) & rx[None, :]
                & (((ok_mask[:, None] >> conf) & 1) == 1))
        h.masked_fill_(fire, _enc(MSG_DEAD))
        return fire.any(dim=1)

    if sc is None:
        slot_fired = _fire(heard_sub, rx_ok)
    else:
        # Any observer on any shard fires the slot's timer.
        slot_fired = _psum([_fire(h, _sloc(sc, rx_ok, i)).to(_I32)
                            for i, h in shards]) > 0
    new_dead = slot_fired & (sl_dead_round < 0)
    sl_phase = torch.where(slot_fired, PHASE_DEAD, sl_phase)
    sl_dead_round = torch.where(new_dead, rnd, sl_dead_round)

    # Detection stats are recorded at declaration time.
    fail_c = fail_round[ncl]
    truly_dead = fail_c <= rnd
    det = new_dead & truly_dead
    n_detected = state.n_detected + det.sum(dtype=_I32)
    sum_detect_rounds = state.sum_detect_rounds + torch.where(
        det, rnd - fail_c, 0).sum(dtype=_I32)
    n_false_dead = state.n_false_dead + (new_dead & ~truly_dead).sum(
        dtype=_I32)

    # -- episode GC: recycle slots whose verdict has disseminated (or
    # whose TTL ran out), apply dead verdicts.
    verdict_done = ((((sl_phase == PHASE_DEAD) | (sl_phase == PHASE_REFUTED)
                      | (sl_phase == PHASE_JOIN))
                     & (sl_dead_round >= 0))
                    & (rnd - sl_dead_round > 2 * p.spread_budget_rounds + 8))
    expired = ((sl_phase > PHASE_FREE)
               & ((rnd - sl_start > p.slot_ttl_rounds) | verdict_done))
    is_dead = expired & (sl_phase == PHASE_DEAD)

    if hist is not None:
        # Spread: members still holding the verdict at slot GC (read
        # before the GC wipe); integer log2 buckets via bit length.
        verdict_msg = torch.where(sl_phase == PHASE_DEAD, MSG_DEAD,
                                  MSG_REFUTE)

        def _n_hold(h, mem):
            return (((h >> _MSG_SHIFT) == verdict_msg[:, None])
                    & mem[None, :]).sum(dim=1, dtype=_I32)

        if sc is None:
            n_hold = _n_hold(heard_sub, member)
        else:
            n_hold = _psum([_n_hold(h, _sloc(sc, member, i))
                            for i, h in shards])
        blen = ((n_hold[:, None]
                 >> torch.arange(31, dtype=_I32, device=dev)) > 0).sum(
            dim=1, dtype=_I32)
        hist = HistBank(
            detect=_hist_add(hist.detect, det, rnd - fail_c),
            dwell=_hist_add(hist.dwell, new_dead | refute_now,
                            rnd - sl_start),
            refute=_hist_add(hist.refute, refute_now, rnd - sl_start),
            spread=_hist_add(hist.spread, expired & (sl_dead_round >= 0),
                             blen),
        )

    member = _set_drop(member, torch.where(is_dead, node_c, N), False)
    slot_of_node = _set_drop(slot_of_node, torch.where(expired, node_c, N),
                             -1)
    _per_shard(sc, heard_sub, lambda h: h.masked_fill_(expired[:, None], 0))
    sl_node = torch.where(expired, -1, sl_node)
    sl_phase = torch.where(expired, PHASE_FREE, sl_phase)
    sl_dead_round = torch.where(expired, -1, sl_dead_round)

    if full_heard is None:
        heard = heard_sub
        slot_node_o, slot_phase_o = sl_node, sl_phase
        slot_dead_o = sl_dead_round
    else:
        heard = full_heard
        if sc is None:
            heard[il] = heard_sub
        else:
            for h, sub in zip(heard, heard_sub):
                h[il] = sub
        slot_node_o = slot_node.index_put((il,), sl_node)
        slot_phase_o = slot_phase.index_put((il,), sl_phase)
        slot_dead_o = slot_dead_round.index_put((il,), sl_dead_round)

    st = SwimState(
        round=state.round + 1,
        heard=heard,
        slot_node=slot_node_o,
        slot_phase=slot_phase_o,
        slot_inc=slot_inc,
        slot_start=slot_start,
        slot_nsusp=slot_nsusp,
        slot_dead_round=slot_dead_o,
        slot_of_node=slot_of_node,
        incarnation=incarnation,
        member=member,
        drops=drops,
        n_detected=n_detected,
        sum_detect_rounds=sum_detect_rounds,
        n_false_dead=n_false_dead,
        n_refuted=n_refuted,
    )
    return st, hist, nem_state


def _swim_round_impl(state: SwimState, rnd: int, base_key,
                     fail_round: torch.Tensor, p: SwimParams,
                     join_round: torch.Tensor | None, collect: bool,
                     hist: HistBank | None = None,
                     sc: _ShardCtx | None = None,
                     nem: NemesisParams | None = None,
                     nem_state: NemState | None = None):
    """One round + (optionally) its flight-recorder row + histograms,
    under a nemesis schedule when ``nem`` is given (with the Lifeguard
    registers when ``nem_state`` is).

    ``rnd`` is the host mirror of ``state.round``.  Returns
    ``(state, row, hist, nem_state)``; ``row`` is None unless
    ``collect``."""
    key = prng.fold_in(base_key, rnd)
    k_probe = prng.split(prng.fold_in(key, 1), 4)
    k_gossip = prng.fold_in(key, 2)

    N, S = p.n, p.slots
    dev = state.slot_node.device
    if nem is not None:
        # The kills half of the schedule rewrites the ground truth before
        # any phase reads it.
        _require_join(nem, join_round)
        fail_round, join_round = _nem_schedule(nem, rnd, fail_round,
                                               join_round)
    alive = fail_round > rnd

    carry = (state.heard, state.slot_node, state.slot_phase, state.slot_inc,
             state.slot_start, state.slot_nsusp, state.slot_dead_round,
             state.slot_of_node, state.incarnation, state.member, state.drops)

    # -- 0. join tick: admit pending joiners (alive@inc rumors).
    if join_round is not None:
        any_join = ((join_round <= rnd) & ~state.member
                    & (fail_round > rnd)).any()
        if _host_int(any_join):
            carry = _join_tick(p, rnd, carry, join_round, fail_round, sc)

    member_now = carry[9]
    mf = torch.where(member_now, fail_round, -1)

    # -- 1. probe tick, on the un-aged matrix.
    carry, probe_stats, nem_state = _probe_tick(p, rnd, k_probe, mf, carry,
                                                sc, nem, nem_state)
    (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
     slot_dead_round, slot_of_node, incarnation, member, drops) = carry

    rx_ok = alive & member
    # Lifeguard confirmations cap (also clamps the timer lookup).
    conf_cap = torch.clamp(slot_nsusp - 1, min=0).clamp(
        max=p.max_confirmations)

    def _maybe_pushpull(h, sub_rx_ok):
        # Push/pull anti-entropy: full belief exchange with one partner
        # along a circulant pairing, both directions, ignoring the
        # spread budget.
        if (not p.pushpull_every
                or rnd % p.pushpull_every != p.pushpull_every - 1):
            return h
        o = int(prng.randint(prng.fold_in(key, 3), (), 1, N))

        def _take(h, hin, ok):
            upgraded = (((hin >> _MSG_SHIFT) > (h >> _MSG_SHIFT))
                        & ok[None, :])
            return torch.where(upgraded, hin, h)

        shifts = (o, -o)
        # Inside a partition's window the two sync legs drop cross-group
        # columns off fold_in(fold_in(key, 5), j), drawn over all N.
        live = [None, None]
        if (nem is not None and nem.has_partition
                and _nem_in_window(nem, rnd)):
            k_pp = prng.fold_in(key, 5)
            live = ~_nem_edge_drops(nem, N, dev, [prng.fold_in(k_pp, j)
                                                  for j in (0, 1)], shifts)
        for shift, lv in zip(shifts, live):
            if sc is None:
                ok = sub_rx_ok & (torch.roll(mf, shift) > rnd)
                if lv is not None:
                    ok = ok & lv
                h = _take(h, torch.roll(h, shift, dims=1), ok)
            else:
                hin = _roll_sharded(sc, h, shift)
                h = tuple(
                    _take(h[i], hin[i], _sloc(sc, sub_rx_ok, i)
                          & (_sloc_roll(sc, mf, shift, i) > rnd)
                          & (True if lv is None else _sloc(sc, lv, i)))
                    for i in range(sc.ndev))
        return h

    # Key 4 is the dissemination legs' drops (5 is push/pull's).
    k_nem = (prng.fold_in(key, 4)
             if nem is not None and nem.has_partition else None)

    def _tail(heard_sub, full_heard, idx, cap):
        heard_sub = _disseminate(p, rnd, k_gossip, heard_sub, mf, rx_ok, cap,
                                 sc, nem, k_nem)
        heard_sub = _maybe_pushpull(heard_sub, rx_ok)
        return _finish_round(p, state, rnd, fail_round, alive, member,
                             heard_sub, full_heard, idx, slot_node,
                             slot_phase, slot_inc, slot_start, slot_nsusp,
                             slot_dead_round, slot_of_node, incarnation,
                             drops, conf_cap, rx_ok, sc, hist, nem,
                             nem_state)

    n_active = _host_int((slot_node >= 0).sum(dtype=_I32))
    hot = bool(p.hot_slots) and S > p.hot_slots and n_active <= p.hot_slots
    tail_rounds["quiescent" if n_active == 0 else "hot" if hot else
                "full"] += 1
    if n_active == 0:
        # Quiescent: the belief matrix is all-zero and every
        # age/gossip/timer/GC pass is a no-op; the banks pass through.
        new_state = SwimState(
            round=state.round + 1, heard=heard, slot_node=slot_node,
            slot_phase=slot_phase, slot_inc=slot_inc, slot_start=slot_start,
            slot_nsusp=slot_nsusp, slot_dead_round=slot_dead_round,
            slot_of_node=slot_of_node, incarnation=incarnation, member=member,
            drops=drops, n_detected=state.n_detected,
            sum_detect_rounds=state.sum_detect_rounds,
            n_false_dead=state.n_false_dead, n_refuted=state.n_refuted)
        hist_out = hist
    else:
        if hot:
            # Hot tier: the H live episodes' rows (top_k over the 0/1
            # activity vector, lowest-index ties = stable argsort),
            # padded with inactive rows, which are no-ops end to end.
            # Sharded: each shard gathers its own [H, L] rows.
            act = (slot_node >= 0).to(_I32)
            idx = torch.argsort(-act, stable=True)[:p.hot_slots].to(_I32)
            il = idx.long()
            out = _tail(_per_shard(sc, heard, lambda h: h[il]), heard, idx,
                        conf_cap[il])
        else:
            out = _tail(heard, None,
                        torch.arange(S, dtype=_I32, device=dev), conf_cap)
        new_state, hist_out, nem_state = out
    if not collect:
        return new_state, None, hist_out, nem_state

    # -- flight row (obs.constants.FLIGHT_COLS order).  Dissemination
    # bytes: every in-budget rumor entry pushed to ``fanout`` peers.
    if n_active:
        def _tx(h):
            live = ((h >> _MSG_SHIFT) > 0) & ((h & _AGE_MASK)
                                              < p.spread_budget_rounds)
            return p.fanout * live.sum(dtype=_I32)

        tx = (_tx(new_state.heard) if sc is None
              else _psum([_tx(h) for h in new_state.heard]))
    else:
        tx = torch.zeros((), dtype=_I32, device=dev)
    dead_before = state.n_detected + state.n_false_dead
    dead_after = new_state.n_detected + new_state.n_false_dead
    row = torch.stack([
        state.round,
        *probe_stats,
        new_state.n_refuted - state.n_refuted,
        dead_after - dead_before,
        (new_state.slot_phase == PHASE_JOIN).sum(dtype=_I32),
        (new_state.slot_node >= 0).sum(dtype=_I32),
        tx,
        new_state.drops - state.drops,
        new_state.member.sum(dtype=_I32),
    ]).to(_I32)
    return new_state, row, hist_out, nem_state


def _on(dev: torch.device, tup):
    return type(tup)(*(tuple(x.to(dev) for x in t) if _sharded(t)
                       else t.to(dev) for t in tup))


def _as_i32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=_I32)


def _require_unsharded(state: SwimState) -> None:
    if _sharded(state.heard):
        raise ValueError("state is sharded (heard is a tuple of shards): "
                         "use run_rounds_sharded/swim_round_sharded, or "
                         "unshard_state first")


def _require_join(nem: NemesisParams, join_round) -> None:
    if nem.needs_join and join_round is None:
        raise ValueError(
            f"nemesis scenario {nem.scenario!r} rewrites join_round; "
            "pass a join_round array (all-NEVER works)")


def _require_nem_state(nem: NemesisParams | None, nem_state) -> None:
    if nem is not None and nem.needs_state and nem_state is None:
        raise ValueError(
            f"nemesis scenario {nem.scenario!r} needs NemState; pass "
            "nem_state=init_nem_state(p.n)")


def swim_round(state: SwimState, base_key, fail_round, p: SwimParams,
               join_round=None, device=None,
               nem: NemesisParams | None = None,
               nem_state: NemState | None = None):
    """Advance the pool by one gossip round (reference ``swim_round``),
    under the nemesis schedule ``nem`` if given: ``state``, or
    ``(state, nem_state)`` when ``nem_state`` is threaded."""
    return _one_round(state, base_key, fail_round, p, None, join_round,
                      device, nem=nem, nem_state=nem_state)


def swim_round_hist(state: SwimState, base_key, fail_round, p: SwimParams,
                    hist: HistBank, join_round=None, device=None,
                    nem: NemesisParams | None = None,
                    nem_state: NemState | None = None):
    """One round threading the observatory banks: ``(state, hist)``, or
    ``(state, hist, nem_state)`` when ``nem_state`` is threaded."""
    return _one_round(state, base_key, fail_round, p, hist, join_round,
                      device, nem=nem, nem_state=nem_state)


def _one_round(state, base_key, fail_round, p, hist, join_round, device,
               sc=None, nem=None, nem_state=None):
    """One round; returns the state packed with whichever of hist and
    nem_state are threaded, in that order."""
    _require_nem_state(nem, nem_state)
    dev = resolve_device(device)
    if sc is None:
        _require_unsharded(state)
    state = _on(dev, state)
    hist = None if hist is None else _on(dev, hist)
    nem_state = None if nem_state is None else _on(dev, nem_state)
    jr = None if join_round is None else _as_i32(join_round, dev)
    st, _, hb, ns = _swim_round_impl(state, _host_int(state.round), base_key,
                                     _as_i32(fail_round, dev), p, jr,
                                     collect=False, hist=hist, sc=sc,
                                     nem=nem, nem_state=nem_state)
    out = ((st,) + ((hb,) if hist is not None else ())
           + ((ns,) if nem_state is not None else ()))
    return out[0] if len(out) == 1 else out


def run_rounds(state: SwimState, base_key, fail_round, p: SwimParams,
               steps: int, trace: bool = False, join_round=None,
               flight: FlightRing | None = None,
               hist: HistBank | None = None, device=None,
               nem: NemesisParams | None = None,
               nem_state: NemState | None = None):
    """Run ``steps`` rounds (reference ``run_rounds``), under the
    nemesis schedule ``nem`` if given.

    Returns ``(carry, trace)``: ``carry`` is ``state`` alone, or the
    tuple ``(state[, flight][, hist][, nem_state])`` when those are
    threaded; ``trace`` is a ``RoundTrace`` of ``[steps, S]`` tensors, or
    None.  ``base_key`` is a ``prng`` key (``uint32[2]``); ``fail_round``
    and ``join_round`` may be numpy arrays or tensors.  A scenario that
    needs ``NemState`` (Lifeguard LHM) must be given one
    (``init_nem_state``)."""
    _require_nem_state(nem, nem_state)
    _require_unsharded(state)
    return _run_rounds_impl(state, base_key, fail_round, p, steps, trace,
                            join_round, flight, hist, resolve_device(device),
                            nem=nem, nem_state=nem_state)


def _run_rounds_impl(state, base_key, fail_round, p, steps, trace,
                     join_round, flight, hist, dev, sc=None, nem=None,
                     nem_state=None):
    state = _on(dev, state)
    fail_round = _as_i32(fail_round, dev)
    join_round = None if join_round is None else _as_i32(join_round, dev)
    hist = None if hist is None else _on(dev, hist)
    nem_state = None if nem_state is None else _on(dev, nem_state)
    if nem is not None:
        _require_join(nem, join_round)
    rnd = _host_int(state.round)
    if flight is not None:
        flight = _on(dev, flight)
        rows = flight.rows.clone()
        R = rows.shape[0]
        cur = _host_int(flight.cursor)
    snaps = []
    for _ in range(steps):
        state, row, hist, nem_state = _swim_round_impl(
            state, rnd, base_key, fail_round, p, join_round,
            collect=flight is not None, hist=hist, sc=sc, nem=nem,
            nem_state=nem_state)
        rnd += 1
        if flight is not None:
            rows[cur % R] = row
            cur += 1
        if trace:
            def _holders(h, mem):
                msg = h >> _MSG_SHIFT
                return (((msg == MSG_DEAD) & mem[None, :]).sum(dim=1,
                                                               dtype=_I32),
                        ((msg == MSG_REFUTE) & mem[None, :]).sum(dim=1,
                                                                 dtype=_I32))

            if sc is None:
                n_dead, n_alive = _holders(state.heard, state.member)
            else:
                per = [_holders(h, _sloc(sc, state.member, i))
                       for i, h in enumerate(state.heard)]
                n_dead = _psum([d for d, _ in per])
                n_alive = _psum([a for _, a in per])
            snaps.append((state.slot_node, state.slot_phase,
                          state.slot_start, state.slot_dead_round,
                          n_dead, n_alive))
    tr = None
    if trace:
        cols = list(zip(*snaps)) if snaps else [()] * 6
        tr = RoundTrace(*(
            torch.stack(c) if c
            else torch.zeros((0, p.slots), dtype=_I32, device=dev)
            for c in cols))
    out = [state]
    if flight is not None:
        out.append(FlightRing(rows=rows, cursor=flight.cursor + steps))
    if hist is not None:
        out.append(hist)
    if nem_state is not None:
        out.append(nem_state)
    return (out[0] if len(out) == 1 else tuple(out)), tr


# -- public sharded entry points -----------------------------------------------
#
# All shards live on one device (``device``; None = the CUDA card).  A
# sharded state is a ``SwimState`` whose ``heard`` is a tuple of ``ndev``
# contiguous [S, N // ndev] tensors (``shard_state``/``unshard_state``).

def _check_shardable(p: SwimParams, ndev: int) -> None:
    """Alignment constraints of the sharded round (reference
    ``_check_shardable``): n divisible by ndev (contiguous observer
    columns per shard) and by probe_every (the prober block is one
    contiguous window)."""
    if ndev < 1:
        raise ValueError(f"ndev must be >= 1, got {ndev}")
    if p.n % ndev:
        raise ValueError(
            f"sharded kernel needs n % ndev == 0 (n={p.n}, ndev={ndev})")
    if p.n % p.probe_every:
        raise ValueError(
            f"sharded kernel needs n % probe_every == 0 (aligned prober "
            f"blocks; n={p.n}, probe_every={p.probe_every})")


def shard_state(state: SwimState, ndev: int, device=None) -> SwimState:
    """``state`` on ``device`` with ``heard`` split into ``ndev``
    contiguous column shards; every other register is held once."""
    _require_unsharded(state)
    dev = resolve_device(device)
    S, N = state.heard.shape
    if ndev < 1 or N % ndev:
        raise ValueError(f"cannot split n={N} observer columns into "
                         f"ndev={ndev} shards")
    L = N // ndev
    st = _on(dev, state)
    return st._replace(heard=tuple(st.heard[:, i * L:(i + 1) * L].contiguous()
                                   for i in range(ndev)))


def unshard_state(state: SwimState) -> SwimState:
    """The inverse of ``shard_state``: ``heard`` as one [S, N] tensor
    (an unsharded state is returned as it is)."""
    if not _sharded(state.heard):
        return state
    return state._replace(heard=torch.cat(state.heard, dim=1))


def _sharded_setup(state, p, ndev, device):
    """(state on the device with ndev shards, its _ShardCtx, device)."""
    dev = resolve_device(device)
    if ndev is None:
        if not _sharded(state.heard):
            raise ValueError("ndev is needed to shard an unsharded state")
        ndev = len(state.heard)
    _check_shardable(p, ndev)
    L = p.n // ndev
    if _sharded(state.heard):
        shapes = [tuple(h.shape) for h in state.heard]
        if shapes != [(p.slots, L)] * ndev:
            raise ValueError(f"state has shards {shapes}, expected {ndev} "
                             f"of {[p.slots, L]}")
        state = _on(dev, state)
    else:
        state = shard_state(state, ndev, dev)
    return state, _ShardCtx(ndev, L), dev


def swim_round_sharded(state: SwimState, base_key, fail_round,
                       p: SwimParams, join_round=None, ndev: int | None = None,
                       device=None, nem: NemesisParams | None = None,
                       nem_state: NemState | None = None):
    """``swim_round`` on ``ndev`` column shards (reference
    ``swim_round_sharded``): bit-identical to it, returns the sharded
    state (with ``nem_state``, as ``swim_round`` does).  ``ndev=None``
    takes a sharded state's own shard count."""
    _require_nem_state(nem, nem_state)
    state, sc, dev = _sharded_setup(state, p, ndev, device)
    return _one_round(state, base_key, fail_round, p, None, join_round,
                      dev, sc, nem, nem_state)


def run_rounds_sharded(state: SwimState, base_key, fail_round, p: SwimParams,
                       steps: int, trace: bool = False, join_round=None,
                       flight: FlightRing | None = None,
                       hist: HistBank | None = None,
                       nem: NemesisParams | None = None,
                       nem_state: NemState | None = None,
                       ndev: int | None = None, device=None):
    """``run_rounds`` on ``ndev`` column shards (reference
    ``run_rounds_sharded``): same contract and return shape, bit-identical
    results, the carry's state sharded; ``nem_state`` is held once.
    ``state`` may be sharded (with ``ndev`` shards) or not (it is sharded
    here).  Constraints: ``_check_shardable``."""
    _require_nem_state(nem, nem_state)
    state, sc, dev = _sharded_setup(state, p, ndev, device)
    return _run_rounds_impl(state, base_key, fail_round, p, steps, trace,
                            join_round, flight, hist, dev, sc, nem,
                            nem_state)
