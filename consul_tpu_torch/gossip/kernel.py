"""The SWIM round on torch tensors: failure detection + dissemination.

Port of ``consul_tpu/gossip/kernel.py`` (the reference; its module
docstring explains the protocol, the ``heard [S, N]`` belief-byte layout
and the circulant gossip graph).  Under the same key and inputs this
round is bit-identical to the reference's single-device round without
nemesis — every field of ``SwimState``, ``FlightRing``, ``HistBank`` and
``RoundTrace`` (``tests/test_torch_kernel.py``).

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

Tensors are never modified in place except those the round allocated
itself (the belief matrix after the probe tick's rearm clear, the rows
produced by the dissemination tail): the caller's state is left intact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch import prng
from consul_tpu_torch._device import resolve_device
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


def _join_tick(p: SwimParams, rnd: int, carry, join_round, fail_round):
    """Activate pending joins (reference ``_join_tick``): a pending node
    that wins a rumor slot becomes a member at a bumped incarnation, any
    stale episode about it clears, and its PHASE_JOIN slot floods the
    alive@inc announcement.  Losers retry next round."""
    (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
     slot_dead_round, slot_of_node, incarnation, member, drops) = carry
    N, S = p.n, p.slots
    dev = heard.device

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
    heard = heard.masked_fill(stale[:, None], 0)
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
    # the flattened matrix, sink S*N for unserved candidates.
    flat = torch.where(sidx < S, sidx.long() * N + cand_c, S * N)
    heard = _set_drop(heard.reshape(-1), flat,
                      _enc(MSG_REFUTE, age=_AGE_FRESH)).view(S, N)

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


def _probe_tick(p: SwimParams, rnd: int, keys, mf, carry):
    """One round's probe slice: direct probe -> k indirect probes ->
    suspicion initiation for this round's prober block (reference
    ``_probe_tick`` without the nemesis legs).  ``mf`` packs membership
    and ground truth: ``member ? fail_round : -1``.  Returns
    ``(carry, probe_stats)``."""
    (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
     slot_dead_round, slot_of_node, incarnation, member, drops) = carry
    k_t, k_dl, _k_h, k_hl = keys
    N, S = p.n, p.slots
    B = _block_size(p)
    dev = heard.device

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

    u = prng.uniform_tensor(k_dl, (B,), dev)
    direct_fail = tgt_member & (~tgt_alive
                                | (u < _f32(p.p_direct_fail_alive)))

    if p.indirect_k:
        hu = prng.uniform_tensor(k_hl, (B, p.indirect_k), dev)
        helper_alive = torch.stack(
            [_mf_block(offs[1 + j]) > rnd for j in range(p.indirect_k)],
            dim=1)
        ind_ok = (helper_alive & (tgt_alive & tgt_member)[:, None]
                  & (hu >= _f32(p.p_indirect_fail_alive)))
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
    if aligned:
        cur = heard[:, blk:blk + B].gather(0, rows[None, :])[0]
    else:
        cur = heard[rows, pid_c.long()]
    init = init & ~((s_t >= 0) & ((cur >> _MSG_SHIFT) == MSG_DEAD))

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
    # A new tensor: from here on the round owns ``heard`` and may write
    # it in place.
    heard = heard.masked_fill(rearm[:, None], 0)

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
    if aligned:
        hblk = heard[:, blk:blk + B]
        cur2 = hblk.gather(0, rows2[None, :])[0]
        mark_ok = (init & (s_t2 >= 0)
                   & ((cur2 >> _MSG_SHIFT) <= MSG_SUSPECT))
        fresh = _enc(MSG_SUSPECT, age=_AGE_FRESH) | (cur2 & conf_bits)
        sel = ((torch.arange(S, device=dev)[:, None] == rows2[None, :])
               & mark_ok[None, :])
        heard[:, blk:blk + B] = torch.where(sel, fresh[None, :], hblk)
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
    return out_carry, probe_stats


def gossip_offsets(key, n: int, fanout: int) -> list[int]:
    """``fanout`` nonzero circulant shifts for one round's gossip graph:
    node ``i`` pushes to ``i + o_f (mod n)``.  Host integers."""
    return [int(o) for o in prng.randint(key, (fanout,), 1, n)]


def _disseminate(p: SwimParams, rnd: int, k_gossip, heard, mf, rx_ok,
                 conf_cap) -> torch.Tensor:
    """One round of rumor push: the dense tail of ``gossip/fused.py`` —
    the Hopper kernel on a CUDA tensor, its plain version on the CPU."""
    from consul_tpu_torch.gossip.fused import disseminate
    offs = gossip_offsets(k_gossip, p.n, p.fanout)
    return disseminate(p, rnd, offs, heard, mf, rx_ok, conf_cap)


def _finish_round(p: SwimParams, state: SwimState, rnd: int, fail_round,
                  alive, member, heard_sub, full_heard, idx, slot_node,
                  slot_phase, slot_inc, slot_start, slot_nsusp,
                  slot_dead_round, slot_of_node, incarnation, drops,
                  conf_cap, rx_ok, hist=None):
    """Refutation, suspicion-timer firing, episode GC, stats (reference
    ``_finish_round``).

    Operates on ``heard_sub``, the belief rows of the slots in ``idx``
    (distinct slot ids).  The full path passes ``idx = arange(S)`` with
    ``full_heard=None``; the hot path passes the gathered rows and
    writes them back into ``full_heard``.  Both ``heard_sub`` and
    ``full_heard`` are the round's own tensors and are written in place.
    Returns ``state`` or ``(state, hist)``."""
    N = p.n
    H = idx.shape[0]
    dev = heard_sub.device
    il = idx.long()

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
        own = heard_sub[hrows, ncl]
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
        heard_sub[hrows, ncl] = torch.maximum(own, refute_val)
        n_refuted = n_refuted + refute_now.sum(dtype=_I32)

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
    conf = (heard_sub >> _CONF_SHIFT) & _CONF_MASK
    fire = (((heard_sub >> _MSG_SHIFT) == MSG_SUSPECT)
            & rx_ok[None, :]
            & (((ok_mask[:, None] >> conf) & 1) == 1))
    slot_fired = fire.any(dim=1)
    new_dead = slot_fired & (sl_dead_round < 0)
    sl_phase = torch.where(slot_fired, PHASE_DEAD, sl_phase)
    sl_dead_round = torch.where(new_dead, rnd, sl_dead_round)
    heard_sub.masked_fill_(fire, _enc(MSG_DEAD))

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
        hold = (((heard_sub >> _MSG_SHIFT) == verdict_msg[:, None])
                & member[None, :])
        n_hold = hold.sum(dim=1, dtype=_I32)
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
    heard_sub.masked_fill_(expired[:, None], 0)
    sl_node = torch.where(expired, -1, sl_node)
    sl_phase = torch.where(expired, PHASE_FREE, sl_phase)
    sl_dead_round = torch.where(expired, -1, sl_dead_round)

    if full_heard is None:
        heard = heard_sub
        slot_node_o, slot_phase_o = sl_node, sl_phase
        slot_dead_o = sl_dead_round
    else:
        heard = full_heard
        heard[il] = heard_sub
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
    return st if hist is None else (st, hist)


def _swim_round_impl(state: SwimState, rnd: int, base_key,
                     fail_round: torch.Tensor, p: SwimParams,
                     join_round: torch.Tensor | None, collect: bool,
                     hist: HistBank | None = None):
    """One round + (optionally) its flight-recorder row + histograms.

    ``rnd`` is the host mirror of ``state.round``.  Returns
    ``(state, row, hist)``; ``row`` is None unless ``collect``."""
    key = prng.fold_in(base_key, rnd)
    k_probe = prng.split(prng.fold_in(key, 1), 4)
    k_gossip = prng.fold_in(key, 2)

    N, S = p.n, p.slots
    dev = state.heard.device
    alive = fail_round > rnd

    carry = (state.heard, state.slot_node, state.slot_phase, state.slot_inc,
             state.slot_start, state.slot_nsusp, state.slot_dead_round,
             state.slot_of_node, state.incarnation, state.member, state.drops)

    # -- 0. join tick: admit pending joiners (alive@inc rumors).
    if join_round is not None:
        any_join = ((join_round <= rnd) & ~state.member
                    & (fail_round > rnd)).any()
        if _host_int(any_join):
            carry = _join_tick(p, rnd, carry, join_round, fail_round)

    member_now = carry[9]
    mf = torch.where(member_now, fail_round, -1)

    # -- 1. probe tick, on the un-aged matrix.
    carry, probe_stats = _probe_tick(p, rnd, k_probe, mf, carry)
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
        for shift in (o, -o):
            ok = sub_rx_ok & (torch.roll(mf, shift) > rnd)
            hin = torch.roll(h, shift, dims=1)
            upgraded = (((hin >> _MSG_SHIFT) > (h >> _MSG_SHIFT))
                        & ok[None, :])
            h = torch.where(upgraded, hin, h)
        return h

    def _tail(heard_sub, full_heard, idx, cap):
        heard_sub = _disseminate(p, rnd, k_gossip, heard_sub, mf, rx_ok, cap)
        heard_sub = _maybe_pushpull(heard_sub, rx_ok)
        return _finish_round(p, state, rnd, fail_round, alive, member,
                             heard_sub, full_heard, idx, slot_node,
                             slot_phase, slot_inc, slot_start, slot_nsusp,
                             slot_dead_round, slot_of_node, incarnation,
                             drops, conf_cap, rx_ok, hist)

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
            act = (slot_node >= 0).to(_I32)
            idx = torch.argsort(-act, stable=True)[:p.hot_slots].to(_I32)
            out = _tail(heard[idx.long()], heard, idx, conf_cap[idx.long()])
        else:
            out = _tail(heard, None,
                        torch.arange(S, dtype=_I32, device=dev), conf_cap)
        new_state, hist_out = (out, hist) if hist is None else out
    if not collect:
        return new_state, None, hist_out

    # -- flight row (obs.constants.FLIGHT_COLS order).  Dissemination
    # bytes: every in-budget rumor entry pushed to ``fanout`` peers.
    if n_active:
        h = new_state.heard
        live = ((h >> _MSG_SHIFT) > 0) & ((h & _AGE_MASK)
                                          < p.spread_budget_rounds)
        tx = p.fanout * live.sum(dtype=_I32)
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
    return new_state, row, hist_out


def _on(dev: torch.device, tup):
    return type(tup)(*(t.to(dev) for t in tup))


def _as_i32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=_I32)


def swim_round(state: SwimState, base_key, fail_round, p: SwimParams,
               join_round=None, device=None) -> SwimState:
    """Advance the pool by one gossip round (reference ``swim_round``)."""
    return _one_round(state, base_key, fail_round, p, None, join_round,
                      device)[0]


def swim_round_hist(state: SwimState, base_key, fail_round, p: SwimParams,
                    hist: HistBank, join_round=None, device=None):
    """One round threading the observatory banks: ``(state, hist)``."""
    return _one_round(state, base_key, fail_round, p, hist, join_round,
                      device)


def _one_round(state, base_key, fail_round, p, hist, join_round, device):
    dev = resolve_device(device)
    state = _on(dev, state)
    hist = None if hist is None else _on(dev, hist)
    jr = None if join_round is None else _as_i32(join_round, dev)
    st, _, hb = _swim_round_impl(state, _host_int(state.round), base_key,
                                 _as_i32(fail_round, dev), p, jr,
                                 collect=False, hist=hist)
    return st, hb


def run_rounds(state: SwimState, base_key, fail_round, p: SwimParams,
               steps: int, trace: bool = False, join_round=None,
               flight: FlightRing | None = None,
               hist: HistBank | None = None, device=None):
    """Run ``steps`` rounds (reference ``run_rounds``).

    Returns ``(carry, trace)``: ``carry`` is ``state`` alone, or the
    tuple ``(state[, flight][, hist])`` when those are threaded;
    ``trace`` is a ``RoundTrace`` of ``[steps, S]`` tensors, or None.
    ``base_key`` is a ``prng`` key (``uint32[2]``); ``fail_round`` and
    ``join_round`` may be numpy arrays or tensors."""
    dev = resolve_device(device)
    state = _on(dev, state)
    fail_round = _as_i32(fail_round, dev)
    join_round = None if join_round is None else _as_i32(join_round, dev)
    hist = None if hist is None else _on(dev, hist)
    rnd = _host_int(state.round)
    if flight is not None:
        flight = _on(dev, flight)
        rows = flight.rows.clone()
        R = rows.shape[0]
        cur = _host_int(flight.cursor)
    snaps = []
    for _ in range(steps):
        state, row, hist = _swim_round_impl(
            state, rnd, base_key, fail_round, p, join_round,
            collect=flight is not None, hist=hist)
        rnd += 1
        if flight is not None:
            rows[cur % R] = row
            cur += 1
        if trace:
            msg = state.heard >> _MSG_SHIFT
            mem = state.member[None, :]
            snaps.append((state.slot_node, state.slot_phase,
                          state.slot_start, state.slot_dead_round,
                          ((msg == MSG_DEAD) & mem).sum(dim=1, dtype=_I32),
                          ((msg == MSG_REFUTE) & mem).sum(dim=1,
                                                          dtype=_I32)))
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
    return (out[0] if len(out) == 1 else tuple(out)), tr
