"""The SWIM round on torch tensors: failure detection + dissemination.

Port of ``consul_tpu/gossip/kernel.py`` (the reference; its module
docstring explains the protocol, the ``heard [S, N]`` belief-byte layout
and the circulant gossip graph).  Under the same key and inputs this
round is bit-identical to the reference's — every field of
``SwimState``, ``FlightRing``, ``HistBank``, ``NemState`` and
``RoundTrace`` (``tests/test_torch_kernel.py``; under each nemesis
scenario, ``tests/test_torch_nemesis.py``).

How the JAX program maps onto PyTorch:

- ``jax.jit(run_rounds)`` is ``gossip/program.py``'s ``RoundProgram`` on
  a card: one round captured as a CUDA graph per variant (below), and a
  call's rounds, up to 512 at a time, one launch of a loop graph over
  them (``lax.scan``).  The eager round of this module is its plain
  version: the CPU runs it, and so does a card when asked
  (``graphed=False``).
- ``lax.scan``'s traced round counter becomes a table: the scalars the
  reference derives from ``rnd`` (the keys of the round's draws, the
  probe offsets, the gossip shifts, the push/pull partner, the prober
  block; ``gossip/round_args.py``) are computed for all of a call's rounds
  at once (on a card by a kernel, ``gossip/round_table.py``) and read on
  the device from row ``step`` (a device counter).  No argument of an
  operation or a launch depends on the round number, so one capture
  serves every round.  ``run_rounds`` mirrors the round counter on the
  host (one read per call).
- Branches on ``rnd`` alone (the push/pull round, the nemesis fault
  window, the degraded observers' prober block, the flapping phase) make
  the round's ``Variant``, one captured graph each; the host takes them
  from that mirror eagerly, and the loop graph on the card from the
  table's column of variant codes (``variant_code``).
- Each ``lax.cond`` on a device value (the join tick on ``any_join``;
  the quiescent / hot / full tail on ``n_active``) is ``_when`` /
  ``_switch``: eagerly a host branch on one read (``host_syncs`` counts
  every such read), and under the round program's capture conditional
  graph nodes behind one chooser node that makes the choice on the card
  (``Choice``; for the tail from ``slot_node`` itself), with no read.
- ``.at[i].set/add(..., mode="drop")`` scatters, whose dropped indices
  equal the axis size, write into a padded sink element that is sliced
  off (``slot_ops.set_drop``); torch would raise on them.
- The hot tier's ``top_k`` over a 0/1 vector (ties to the lowest index)
  is a stable argsort.
- A nemesis schedule (``gossip/nemesis.py``) is decided on the host
  where it can be: the fault window is a host test on the mirrored
  round, and a drop draw whose outcome is certain (outside the window,
  a drop probability of 0 or 1, a prober block with no degraded
  observer) is not made.  Every draw has its own key (``fold_in`` and
  ``split``, never a sequence), so skipping one changes no other.

The round writes its belief matrix in place: the probe and join ticks'
row wipes and point writes, the finish step's fire pass and GC wipe
(``gossip/finish.py``: one launch of ``csrc/finish.cu`` each on a card)
and the hot tail's rows.  So no step outside the dissemination tail
copies the ``[S, N]`` matrix.  The probe tick (``gossip/probe.py``: on a
card two launches of ``csrc/probe.cu``, its rearm's wipe in the second)
also writes the slot registers, ``slot_of_node``, ``drops`` and NemState
in place, and the finish step's slot logic (``gossip/finish_slots.py``:
three launches of ``csrc/finish_slots.cu``) the slot registers,
``slot_of_node``, ``incarnation``, ``member``, the counters, LHM and the
hist banks.
The caller's tensors are never written: an eager entry point
(``swim_round*``, ``run_rounds*``) copies the caller's matrix, those
registers, NemState and the banks once per call (``_own_state``,
``_own_nem``, ``_own_hist``), and the round program copies the state into
its buffers once per call.

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
from consul_tpu_torch.gossip import (finish, finish_slots, observe, probe,
                                     round_args)
from consul_tpu_torch.gossip.belief import (  # noqa: F401
    _AGE_FRESH, _AGE_MASK, _CONF_MASK, _CONF_SHIFT, _MSG_SHIFT, MSG_DEAD,
    MSG_NONE, MSG_REFUTE, MSG_SUSPECT)
from consul_tpu_torch.gossip.nemesis import NemesisParams
from consul_tpu_torch.gossip.params import SwimParams
from consul_tpu_torch.gossip.slot_ops import (alloc_free_slots, put_points,
                                              segment_min, set_drop)
from consul_tpu_torch.obs.constants import LATENCY_BUCKETS as _HIST_LAT
from consul_tpu_torch.obs.constants import N_COLS as _FLIGHT_COLS
from consul_tpu_torch.obs.constants import SPREAD_BUCKETS as _HIST_SPREAD

PHASE_FREE = 0
PHASE_SUSPECT = 1
PHASE_DEAD = 2
PHASE_REFUTED = 3
PHASE_JOIN = 4   # alive@inc dissemination for a node joining the pool

NEVER = np.int32(2**31 - 1)  # fail_round value for "never fails"

_I32 = torch.int32

# Device->host reads made by the round loop: the round counter and the
# flight cursor once per run_rounds call; in the eager round also n_active
# once per round and any_join once per round when join_round is passed.
host_syncs = 0
# Rounds by the tail they took: only "hot" and "full" rounds run the
# dissemination tail (one kernel launch each on a card).  Replayed rounds
# count on the device; ``program.settle_counts()`` adds them here.
tail_rounds = {"quiescent": 0, "hot": 0, "full": 0}
# Rounds whose join tick ran (the ``_when`` on a pending joiner taken);
# replayed rounds count on the device, as ``tail_rounds`` do.
join_rounds = 0
# The round program's recorder while it captures a round
# (``gossip/program.py``), else None: ``_when`` and ``_switch`` then emit
# conditional graph nodes instead of reading their predicate.
_recorder = None


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


# -- helpers -------------------------------------------------------------------

def _roll(x: torch.Tensor, o, dim: int) -> torch.Tensor:
    """``torch.roll(x, o, dims=dim)`` by a device shift ``o`` (an int32
    scalar tensor from the round's row), as a gather, ``out[c] = x[(c - o)
    mod n]``, whose arguments do not depend on the shift's value."""
    n = x.shape[dim]
    return x.index_select(dim, (torch.arange(n, device=x.device)
                                - o).remainder(n))


def _leaves(tree) -> list:
    """The tensors of a nest of tuples (``None`` leaves skipped), in
    order: how ``_when``/``_switch`` pair results with buffers."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _leaves(x)]


def _when(pred: torch.Tensor, fn, operand):
    """``lax.cond(pred, fn, identity, operand)`` for a device ``pred``:
    eagerly one host read, then ``fn(operand)`` or ``operand``.  Under the
    round program's capture, ``fn``'s work is the body of a conditional
    graph node on ``pred`` and writes its result into ``operand``'s own
    tensors (the program's buffers), so nothing is read."""
    global join_rounds
    if _recorder is None:
        if not _host_int(pred):
            return operand
        join_rounds += 1
        return fn(operand)
    return _recorder.when(pred, fn, operand)


class Choice(NamedTuple):
    """A branch group's choice, from its operand: for a cond (``k`` 1,
    the join tick) a device bool, whose branch runs where it holds; for
    the tail's switch (``k`` 2: quiescent, full; 3: quiescent, hot, full)
    ``slot_node`` [S], from the live slots' count ``n_active``: branch 0
    where none is live, 1 where at most ``hot`` are (the hot tier on), else
    the last.  Under the round program's capture it is the argument of
    the group's chooser node (``csrc/round_graph.cu``), whose plain version
    is ``choice_ref``."""

    operand: torch.Tensor
    k: int
    hot: int = 0


def choice_ref(c: Choice):
    """``(which, n_active)`` of a ``Choice``, as int32 device scalars:
    ``which`` the branch taken (-1: a cond's bool is false), ``n_active``
    the live slots (None for a cond)."""
    if c.k == 1:
        return torch.where(c.operand, 0, -1).to(_I32).reshape(()), None
    n_active = (c.operand >= 0).sum(dtype=_I32)
    if c.k == 3:
        which = torch.where(n_active == 0, 0,
                            torch.where(n_active <= c.hot, 1, 2))
    else:
        which = (n_active > 0).to(_I32)
    return which.to(_I32), n_active


def _switch(choice: Choice, branches, names, dst):
    """``lax.switch(which, branches)`` on a device ``Choice``: eagerly one
    host read of ``which`` (``choice_ref``), then ``branches[which]()``
    (counted in ``tail_rounds`` by ``names``).  Under the round program's
    capture, the group's chooser node makes the choice on the card, each
    branch is the body of a conditional graph node that writes its result
    into ``dst`` (the program's buffers, of the results' structure), and
    the chooser counts its rounds on the device.  Returns ``(result,
    n_active)``; under capture ``n_active`` is the program's buffer that
    the chooser writes."""
    if _recorder is None:
        which, n_active = choice_ref(choice)
        i = _host_int(which)
        tail_rounds[names[i]] += 1
        return branches[i](), n_active
    return _recorder.switch(choice, branches, names, dst)


class Variant(NamedTuple):
    """The round's branches on ``rnd`` alone, taken on the host from its
    mirror of the round counter (``round_variant``); each variant is one
    captured graph of the round program.  There are at most
    ``MAX_VARIANTS``: push/pull or not, times outside the fault window or
    inside it with the prober block on the degraded observers or not and
    the flapping nodes down or not."""

    pushpull: bool    # a push/pull round
    in_window: bool   # inside the nemesis fault window
    degraded: bool    # ... and the prober block meets the degraded ids
    flap_down: bool   # ... and the flapping nodes are in a down phase


MAX_VARIANTS = 2 * (1 + 2 * 2)


def round_variant(p: SwimParams, nem: NemesisParams | None,
                  rnd: int) -> Variant:
    pp = bool(p.pushpull_every) and (rnd % p.pushpull_every
                                     == p.pushpull_every - 1)
    if nem is None or not _nem_in_window(nem, rnd):
        return Variant(pp, False, False, False)
    B = probe.block_size(p)
    blk = (rnd % p.probe_every) * B
    degraded = (nem.has_degraded and blk < nem.obs_hi
                and blk + B > nem.obs_lo)
    down = nem.has_flap and (((rnd - nem.start) % nem.flap_period)
                             >= nem.flap_up)
    return Variant(pp, True, bool(degraded), bool(down))


# A variant as one int, the round program's variant column (bit 0
# push/pull, 1 in the window, 2 degraded, 3 flap down): VARIANT_CODES values.
VARIANT_CODES = 16


def variant_code(v: Variant) -> int:
    return (int(v.pushpull) | int(v.in_window) << 1 | int(v.degraded) << 2
            | int(v.flap_down) << 3)


def variant_of(code: int) -> Variant:
    return Variant(*(bool(int(code) >> b & 1) for b in range(4)))


def variant_codes(p: SwimParams, nem: NemesisParams | None, rnd0: int,
                  steps: int) -> np.ndarray:
    """``variant_code(round_variant(p, nem, r))`` for the rounds ``rnd0 ..
    rnd0 + steps - 1``, int32 [steps]: the host's mirror of the table's
    variant column, numpy arithmetic on the round numbers (no hashing)."""
    rnd = np.arange(rnd0, rnd0 + steps, dtype=np.int64)
    code = np.zeros(steps, np.int64)
    if p.pushpull_every:
        code |= rnd % p.pushpull_every == p.pushpull_every - 1
    if nem is not None:
        inside = (rnd >= nem.start) & (rnd < nem.stop)
        code |= inside.astype(np.int64) << 1
        if nem.has_degraded:
            B = probe.block_size(p)
            blk = (rnd % p.probe_every) * B
            code |= (inside & (blk < nem.obs_hi)
                     & (blk + B > nem.obs_lo)).astype(np.int64) << 2
        if nem.has_flap:
            down = (rnd - nem.start) % nem.flap_period >= nem.flap_up
            code |= (inside & down).astype(np.int64) << 3
    return code.astype(np.int32)


# -- nemesis injection (the reference's statics, decided on the host) ---------

@functools.lru_cache(maxsize=32)
def _nem_group(nem: NemesisParams, n: int, device) -> torch.Tensor:
    """Partition group bit per node, i32 [n] (``nemesis.group_of`` bit
    for bit, ``probe.group``), built once per (schedule, n, device)."""
    return probe.group(nem.part_kind == "hash", n, device)


@functools.lru_cache(maxsize=32)
def _nem_flap_ids(nem: NemesisParams, n: int, device) -> torch.Tensor:
    ids = torch.arange(n, dtype=_I32, device=device)
    return (ids >= nem.flap_lo) & (ids < nem.flap_hi)


def _nem_in_window(nem: NemesisParams, rnd: int) -> bool:
    return nem.start <= rnd < nem.stop


def _nem_schedule(nem: NemesisParams, v: Variant, rnd, fail_round,
                  join_round):
    """The round's injection schedule on the ground-truth inputs
    (reference ``_nem_schedule``): a flapping node's down phase (in the
    window; ``v.flap_down``) fails it now, its up phase re-arms
    ``join_round``; after a healed partition every node is join-pending
    (the join tick ignores members)."""
    if nem.has_flap:
        flap = _nem_flap_ids(nem, fail_round.shape[0], fail_round.device)
        if v.flap_down:
            fail_round = torch.where(flap, torch.minimum(fail_round, rnd),
                                     fail_round)
        else:
            join_round = torch.where(flap, torch.minimum(join_round, rnd),
                                     join_round)
    if nem.heal_rejoin:
        join_round = join_round.clamp(max=nem.stop)
    return fail_round, join_round


def _nem_edge_drops(nem: NemesisParams, n: int, device, keys,
                    shifts) -> torch.Tensor:
    """Bool ``[len(shifts), n]``: where a message into destination ``d``
    along shift ``o`` (sender ``d - o``) is dropped inside the fault
    window — cross-group senders at their group's edge probability, one
    ``uniform(keys[j], (n,))`` per shift (reference ``_nem_leg_drop``
    and the push/pull legs); ``prng.edge_drops``: one launch on a card."""
    return prng.edge_drops(keys, _nem_group(nem, n, device), shifts,
                           nem.p_ab, nem.p_ba)


# -- sharding along the observer axis -----------------------------------------
#
# The reference's "ICI sharding" section, from one controller.  Only the
# [S, N] belief matrix is sharded: ``heard`` becomes a tuple of ``ndev``
# contiguous u8 [S, L] tensors, shard i holding observer columns
# [i*L, (i+1)*L).  Every other register is held once — the reference
# replicates them by construction, so one copy is exact.  Its
# collectives become tensor code on this known layout: a ppermute is
# indexing into the shard list, a psum the sum of the per-shard
# contributions.  The shifts (gossip offsets, the push/pull shift, the
# prober block) are device values from the round's row, so a write that
# crosses shards masks each shard's own columns (``_owned``), and the
# sharded round makes no device->host read that the single-device round
# does not.  Bytes cross between shards only in ``_roll_sharded``, the
# dissemination tail's merge kernel (``fused.fused_merge``, which reads
# its pins from every shard through a table of shard pointers), the probe
# tick's and the finish step's kernels (``gossip/probe.py``,
# ``gossip/finish_slots.py``, which read the prober columns and the
# subjects' own bytes through such a table) and the observers' kernel
# (``observe.heard_counts``, which counts every shard in one launch);
# placing the shards on several cards changes those.

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


def _sloc_roll(sc: _ShardCtx, v: torch.Tensor, o, i: int) -> torch.Tensor:
    """Shard ``i``'s [L] slice of ``torch.roll(v, o)`` for a device shift
    ``o``: a gather."""
    cols = i * sc.L + torch.arange(sc.L, device=v.device) - o
    return v[cols.remainder(v.shape[0])]


def _owned(sc: _ShardCtx, cols: torch.Tensor, i: int):
    """Which global columns ``cols`` shard ``i`` owns, and their local
    column as an index (clamped into the shard where not owned)."""
    base = i * sc.L
    return ((cols >= base) & (cols < base + sc.L),
            (cols - base).clamp(0, sc.L - 1).long())


def _roll_sharded(sc: _ShardCtx, xs, o, out=None):
    """Global ``torch.roll(x, o, dims=-1)`` of a sharded ``x`` by a device
    shift ``o``: each output shard's columns gathered from the joined
    matrix.  ``out`` (one tensor per shard) receives the result in
    place."""
    L, nd = sc.L, sc.ndev
    full = torch.cat(xs, dim=-1)
    res = []
    for i in range(nd):
        cols = (i * L + torch.arange(L, device=full.device)
                - o).remainder(L * nd)
        res.append(torch.index_select(full, -1, cols, out=out[i])
                   if out is not None else full.index_select(-1, cols))
    return tuple(res)


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
    cand = segment_min(masked, min(S, N), N)
    in_dom = cand < N
    can_k, slot_k, sidx = alloc_free_slots(slot_node < 0, in_dom)
    cand_c = cand.clamp(0, N - 1)

    joining = set_drop(torch.zeros((N,), dtype=torch.bool, device=dev),
                        torch.where(can_k, cand_c, N), True)
    incarnation = incarnation + joining.to(_I32)
    member = member | joining

    # Clear any stale episode about a rejoining winner (its rows wiped in
    # place: one launch of the wipe kernel on a card).
    node_c0 = slot_node.clamp(0, N - 1)
    stale = (slot_node >= 0) & joining[node_c0.long()]
    finish.wipe(heard, stale)
    slot_of_node = set_drop(slot_of_node, torch.where(stale, node_c0, N), -1)
    slot_node = torch.where(stale, -1, slot_node)
    slot_phase = torch.where(stale, PHASE_FREE, slot_phase)
    slot_dead_round = torch.where(stale, -1, slot_dead_round)

    slot_node = set_drop(slot_node, sidx, cand_c)
    slot_phase = set_drop(slot_phase, sidx, PHASE_JOIN)
    slot_inc = set_drop(slot_inc, sidx, incarnation[cand_c.long()])
    slot_start = set_drop(slot_start, sidx, rnd)
    slot_nsusp = set_drop(slot_nsusp, sidx, 0)
    # The join IS the episode's verdict (verdict-done GC).
    slot_dead_round = set_drop(slot_dead_round, sidx, rnd)
    slot_of_node = set_drop(slot_of_node, torch.where(can_k, cand_c, N),
                             slot_k)
    # The joiner seeds its own announcement flood: heard[sidx, cand] in
    # place for served candidates.  Sharded: the seed column belongs to
    # one shard; the others write nothing.
    served = sidx < S
    row = sidx.clamp(max=S - 1).long()
    seed = torch.full(sidx.shape, _enc(MSG_REFUTE, age=_AGE_FRESH),
                      dtype=torch.uint8, device=dev)
    if sc is None:
        put_points(heard, row * N + cand_c, seed, served)
    else:
        for i, h in enumerate(heard):
            owned, loc = _owned(sc, cand_c, i)
            put_points(h, row * sc.L + loc, seed, owned & served)

    return (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
            slot_dead_round, slot_of_node, incarnation, member, drops)


def _probe_tick(p: SwimParams, ra, v: Variant, mf, carry,
                scratch: torch.Tensor, nem: NemesisParams | None = None,
                nem_state: NemState | None = None):
    """One round's probe slice: direct probe -> k indirect probes ->
    suspicion initiation for this round's prober block (reference
    ``_probe_tick``), as ``gossip/probe.py``'s steps: the prober lanes and
    the slot bookkeeping, then the rearmed rows' wipe and the marks (on a
    card two launches of ``csrc/probe.cu``).  ``ra``:
    the round's row (``round_args.RoundArgs``: the round, the prober
    block, the probe offsets and the draws' keys, all device values).
    ``mf`` packs membership and ground truth: ``member ? fail_round :
    -1``.

    ``nem`` adds the nemesis probe legs: cross-group round-trip drops
    and a degraded observer's missed replies; with ``nem_state`` also
    Lifeguard's local-health multiplier, which holds back a prober's
    suspicion until it has missed more probes in a row than its LHM.

    In place: the belief matrix, the slot registers, ``slot_of_node``,
    ``drops`` and NemState's registers, so the carry's tensors are the
    ones given.  The kernels take a sharded matrix's shards from
    ``heard`` itself.  ``scratch``: the caller's ``probe.scratch(p,
    device)``, made once a call or a program.  Returns ``(carry,
    probe_stats, nem_state)``."""
    (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
     slot_dead_round, slot_of_node, incarnation, member, drops) = carry
    cfg = probe.config(p, v, nem)
    tick = probe.Tick(heard, ra, mf, slot_of_node,
                      nem_state if nem is not None else None,
                      (slot_node, slot_phase, slot_inc, slot_start,
                       slot_nsusp, slot_dead_round), incarnation, drops,
                      scratch)
    rearm, stats = probe.lanes_and_slots(cfg, tick)
    # The rearmed rows wiped in place (none in most rounds), then the
    # marks, as the reference orders them: one launch on a card.
    probe.rearm_and_marks(cfg, tick, rearm)
    return carry, tuple(stats.unbind(0)), nem_state


def gossip_offsets(key, n: int, fanout: int) -> list[int]:
    """``fanout`` nonzero circulant shifts for one round's gossip graph:
    node ``i`` pushes to ``i + o_f (mod n)``.  Host integers."""
    return [int(o) for o in prng.randint(key, (fanout,), 1, n)]


def _disseminate(p: SwimParams, ra, v: Variant, heard, mf, rx_ok, conf_cap,
                 sc: _ShardCtx | None = None,
                 nem: NemesisParams | None = None):
    """One round of rumor push: the dense tail of ``gossip/fused.py`` —
    the Hopper kernels on CUDA tensors, their plain versions on the
    CPU, reading the round and its gossip shifts from the row ``ra``.
    Inside a partition's fault window each leg ``f`` drops its
    cross-group deliveries off ``fold_in(fold_in(key, 4), f)``: the tail
    takes them as its drop operand, ``[fanout, N]`` by destination
    column."""
    from consul_tpu_torch.gossip.fused import disseminate
    drop = None
    if nem is not None and nem.has_partition and v.in_window:
        drop = _nem_edge_drops(nem, p.n, mf.device, ra.k_legs, ra.gossip)
    return disseminate(p, ra.rnd, ra.gossip, heard, mf, rx_ok, conf_cap, sc,
                       drop)


def _finish_round(p: SwimParams, state: SwimState, rnd, fail_round,
                  alive, member, heard_sub, full_heard, idx, slot_node,
                  slot_phase, slot_inc, slot_start, slot_nsusp,
                  slot_dead_round, slot_of_node, incarnation, drops,
                  conf_cap, rx_ok, sc: _ShardCtx | None = None, hist=None,
                  nem: NemesisParams | None = None,
                  nem_state: NemState | None = None, obs_scratch=None):
    """Refutation, suspicion-timer firing, episode GC, stats (reference
    ``_finish_round``), as ``gossip/finish_slots.py``'s steps around the
    matrix passes: the decision (refutation, the timer mask), the fire,
    the verdicts and the GC decision, the spread's count (with the hist
    banks), the banks' adds and the register writes, the GC wipe (on a card
    one launch each, of ``csrc/finish_slots.cu``, ``csrc/finish.cu`` and
    ``csrc/observe.cu``).  ``rnd`` is the round from its row (a device
    value).

    Operates on ``heard_sub``, the belief rows of the slots in ``idx``
    (distinct slot ids).  The full path passes ``idx = arange(S)`` with
    ``full_heard=None``; the hot path passes the gathered rows and
    writes them back into ``full_heard``.  Both ``heard_sub`` and
    ``full_heard`` are the round's own tensors (one per shard when
    sharded) and are written in place, as are the slot registers,
    ``slot_of_node``, ``incarnation``, ``member``, the state's counters,
    NemState's LHM and the banks.  With ``nem_state`` threaded, a subject
    that refuted a suspicion about itself raises its own LHM (Lifeguard).
    ``obs_scratch``: the round's kernels' scratch, which the observers'
    counts (``observe.count``) and the fire pass (``finish.fire``) take in
    turn.  Returns ``(state, hist, nem_state)``."""
    lhm = None if nem is None or nem_state is None else nem_state.lhm
    cfg = finish_slots.config(p, nem if lhm is not None else None)
    t = finish_slots.Step(
        heard_sub, rnd, idx,
        (slot_node, slot_phase, slot_start, slot_dead_round), conf_cap,
        alive, member, fail_round, slot_of_node, incarnation,
        (state.n_detected, state.sum_detect_rounds, state.n_false_dead,
         state.n_refuted), lhm, hist)
    # Right after the tail (or a push/pull round's last take), which
    # writes only heard_sub: on a card decide loads the rest before it
    # waits for that kernel.
    dec = finish_slots.decide(cfg, t)
    # The refutation's byte, then the fire, in place on the rows whose
    # timer can fire alone (one launch of the fire kernel on a card, every
    # shard): ``fired`` says which rows fired on any shard.
    fired = finish.fire(heard_sub, rx_ok, dec.ok_mask, dec.refute,
                        obs_scratch)
    st = finish_slots.settle(cfg, t, fired)
    n_hold = None
    if hist is not None:
        # Spread: members still holding the verdict at slot GC (read
        # before the drop and the GC wipe), counted only on the rows
        # recycled now (one launch of the observers' kernel, all shards).
        n_hold = observe.count(heard_sub, member, p.spread_budget_rounds,
                               st.verdict, st.spread,
                               obs_scratch)[observe.HOLD]
    finish_slots.record(cfg, t, dec, st, n_hold)
    finish.wipe(heard_sub, st.expired)

    if full_heard is None:
        heard = heard_sub
    else:
        heard = full_heard
        il = idx.long()
        if sc is None:
            heard[il] = heard_sub
        else:
            for h, sub in zip(heard, heard_sub):
                h[il] = sub

    st = SwimState(
        round=state.round + 1,
        heard=heard,
        slot_node=slot_node,
        slot_phase=slot_phase,
        slot_inc=slot_inc,
        slot_start=slot_start,
        slot_nsusp=slot_nsusp,
        slot_dead_round=slot_dead_round,
        slot_of_node=slot_of_node,
        incarnation=incarnation,
        member=member,
        drops=drops,
        n_detected=state.n_detected,
        sum_detect_rounds=state.sum_detect_rounds,
        n_false_dead=state.n_false_dead,
        n_refuted=state.n_refuted,
    )
    return st, hist, nem_state


def _swim_round_impl(state: SwimState, ra, v: Variant,
                     fail_round: torch.Tensor, p: SwimParams,
                     join_round: torch.Tensor | None, collect: bool,
                     hist: HistBank | None = None,
                     sc: _ShardCtx | None = None,
                     nem: NemesisParams | None = None,
                     nem_state: NemState | None = None, dst=None,
                     trace: bool = False, obs_scratch=None, *,
                     probe_scratch: torch.Tensor):
    """One round + (optionally) its flight-recorder row + histograms,
    under a nemesis schedule when ``nem`` is given (with the Lifeguard
    registers when ``nem_state`` is).

    ``ra`` is the round's row (``round_args.RoundArgs``), ``v`` its
    ``Variant``.  ``dst``: under the round program's capture, the
    program's buffers ``(state, hist, nem_state)`` that the tail's
    branches write (``_switch``); unused eagerly.  ``obs_scratch``: the
    round's kernels' scratch, an ``observe.counts_scratch`` of at least S
    rows (``observe.count`` and ``finish.fire`` take it in turn; None:
    each launch makes one); ``probe_scratch``: the probe tick's
    (``probe.scratch``, the caller's).  Returns ``(state, row, hist,
    nem_state, holders)``; ``row`` is None unless ``collect``,
    ``holders`` (the trace's DEAD and REFUTE holders a slot) None unless
    ``trace``."""
    rnd = ra.rnd
    N, S = p.n, p.slots
    dev = state.slot_node.device
    # The counters the flight row differences, before any branch writes
    # them (under capture ``state`` is the program's buffers).
    before = (torch.stack([state.round, state.n_refuted,
                           state.n_detected + state.n_false_dead,
                           state.drops]) if collect else None)
    if nem is not None:
        # The kills half of the schedule rewrites the ground truth before
        # any phase reads it.
        _require_join(nem, join_round)
        fail_round, join_round = _nem_schedule(nem, v, rnd, fail_round,
                                               join_round)
    alive = fail_round > rnd

    carry = (state.heard, state.slot_node, state.slot_phase, state.slot_inc,
             state.slot_start, state.slot_nsusp, state.slot_dead_round,
             state.slot_of_node, state.incarnation, state.member, state.drops)

    # -- 0. join tick: admit pending joiners (alive@inc rumors); the
    # reference's lax.cond on any pending joiner.
    if join_round is not None:
        any_join = ((join_round <= rnd) & ~state.member
                    & (fail_round > rnd)).any()
        carry = _when(any_join, lambda c: _join_tick(
            p, rnd, c, join_round, fail_round, sc), carry)

    member_now = carry[9]
    mf = torch.where(member_now, fail_round, -1)

    # -- 1. probe tick, on the un-aged matrix.
    carry, probe_stats, nem_state = _probe_tick(p, ra, v, mf, carry,
                                                probe_scratch, nem,
                                                nem_state)
    (heard, slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
     slot_dead_round, slot_of_node, incarnation, member, drops) = carry

    rx_ok = alive & member
    # Lifeguard confirmations cap (also clamps the timer lookup).
    conf_cap = torch.clamp(slot_nsusp - 1, min=0).clamp(
        max=p.max_confirmations)

    def _maybe_pushpull(h, sub_rx_ok):
        # Push/pull anti-entropy: full belief exchange with one partner
        # along a circulant pairing (shifts o and -o), both directions,
        # ignoring the spread budget.
        if not v.pushpull:
            return h

        def _take(h, hin, ok):
            upgraded = (((hin >> _MSG_SHIFT) > (h >> _MSG_SHIFT))
                        & ok[None, :])
            return torch.where(upgraded, hin, h)

        # Inside a partition's window the two sync legs drop cross-group
        # columns off fold_in(fold_in(key, 5), j), drawn over all N.
        live = [None, None]
        if nem is not None and nem.has_partition and v.in_window:
            live = ~_nem_edge_drops(nem, N, dev, ra.k_pp, ra.pp)
        for shift, lv in zip(ra.pp, live):
            if sc is None:
                ok = sub_rx_ok & (_roll(mf, shift, 0) > rnd)
                if lv is not None:
                    ok = ok & lv
                h = _take(h, _roll(h, shift, 1), ok)
            else:
                hin = _roll_sharded(sc, h, shift)
                h = tuple(
                    _take(h[i], hin[i], _sloc(sc, sub_rx_ok, i)
                          & (_sloc_roll(sc, mf, shift, i) > rnd)
                          & (True if lv is None else _sloc(sc, lv, i)))
                    for i in range(sc.ndev))
        return h

    def _tail(heard_sub, full_heard, idx, cap):
        heard_sub = _disseminate(p, ra, v, heard_sub, mf, rx_ok, cap, sc,
                                 nem)
        heard_sub = _maybe_pushpull(heard_sub, rx_ok)
        return _finish_round(p, state, rnd, fail_round, alive, member,
                             heard_sub, full_heard, idx, slot_node,
                             slot_phase, slot_inc, slot_start, slot_nsusp,
                             slot_dead_round, slot_of_node, incarnation,
                             drops, conf_cap, rx_ok, sc, hist, nem,
                             nem_state, obs_scratch)

    def quiescent():
        # The belief matrix is all-zero and every age/gossip/timer/GC
        # pass is a no-op; the banks pass through.
        st = SwimState(
            round=state.round + 1, heard=heard, slot_node=slot_node,
            slot_phase=slot_phase, slot_inc=slot_inc, slot_start=slot_start,
            slot_nsusp=slot_nsusp, slot_dead_round=slot_dead_round,
            slot_of_node=slot_of_node, incarnation=incarnation, member=member,
            drops=drops, n_detected=state.n_detected,
            sum_detect_rounds=state.sum_detect_rounds,
            n_false_dead=state.n_false_dead, n_refuted=state.n_refuted)
        return st, hist, nem_state

    def hot_tail():
        # Hot tier: the H live episodes' rows (top_k over the 0/1 activity
        # vector, lowest-index ties = stable argsort), padded with inactive
        # rows, which are no-ops end to end.  Sharded: each shard gathers
        # its own [H, L] rows.
        act = (slot_node >= 0).to(_I32)
        idx = torch.argsort(-act, stable=True)[:p.hot_slots].to(_I32)
        il = idx.long()
        return _tail(_per_shard(sc, heard, lambda h: h[il]), heard, idx,
                     conf_cap[il])

    def full_tail():
        return _tail(heard, None, torch.arange(S, dtype=_I32, device=dev),
                     conf_cap)

    # The reference's lax.conds on the live episodes: quiescent, hot or
    # full tail, from the live slots' count.
    if bool(p.hot_slots) and S > p.hot_slots:
        choice = Choice(slot_node, 3, p.hot_slots)
        branches, names = ((quiescent, hot_tail, full_tail),
                           ("quiescent", "hot", "full"))
    else:
        choice = Choice(slot_node, 2)
        branches, names = (quiescent, full_tail), ("quiescent", "full")
    (new_state, hist_out, nem_state), n_active = _switch(choice, branches,
                                                         names, dst)
    if not (collect or trace):
        return new_state, None, hist_out, nem_state, None

    # -- the observers of the final matrix: one launch of the observers'
    # kernel (all shards) for the trace's holders and the flight row's
    # dissemination bytes, every in-budget rumor entry pushed to
    # ``fanout`` peers (0 on the quiescent branch, as the reference's
    # cond gives it).
    counts = observe.count(new_state.heard, new_state.member,
                           p.spread_budget_rounds, scratch=obs_scratch)
    holders = ((counts[observe.DEAD], counts[observe.REFUTE]) if trace
               else None)
    if not collect:
        return new_state, None, hist_out, nem_state, holders
    tx = torch.where(n_active > 0,
                     p.fanout * counts[observe.LIVE].sum(dtype=_I32), 0)

    # -- flight row (obs.constants.FLIGHT_COLS order).
    row = torch.stack([
        before[0],
        *probe_stats,
        new_state.n_refuted - before[1],
        new_state.n_detected + new_state.n_false_dead - before[2],
        (new_state.slot_phase == PHASE_JOIN).sum(dtype=_I32),
        (new_state.slot_node >= 0).sum(dtype=_I32),
        tx,
        new_state.drops - before[3],
        new_state.member.sum(dtype=_I32),
    ]).to(_I32)
    return new_state, row, hist_out, nem_state, holders


def _round_once(p, table, step, state, v, fail_round, join_round, hist,
                nem_state, sc=None, nem=None, rows=None, trace_bufs=None,
                dst=None, obs_scratch=None, *, probe_scratch: torch.Tensor):
    """The round at row ``step`` (a device counter, int64 [1]) of the
    device ``table``: the round itself, its flight row into ``rows`` at
    the row's ring slot and its trace row into ``trace_bufs`` at
    ``step``, when given; then ``step`` advances.  Nothing here depends
    on the round number but through the table, so the round program
    captures this call once per variant; ``obs_scratch`` and
    ``probe_scratch`` are the round's kernels' scratch
    (``_swim_round_impl``).  Returns
    ``(state, hist, nem_state)``."""
    lay = round_args.layout(p.fanout, p.indirect_k)
    ra = round_args.row_args(lay, table.index_select(0, step)[0])
    state, row, hist, nem_state, holders = _swim_round_impl(
        state, ra, v, fail_round, p, join_round, rows is not None, hist, sc,
        nem, nem_state, dst, trace=trace_bufs is not None,
        obs_scratch=obs_scratch, probe_scratch=probe_scratch)
    if rows is not None:
        rows.index_copy_(0, ra.flight.view(1).long(), row[None])
    if trace_bufs is not None:
        # The round's RoundTrace row: the slot registers and the members
        # holding each slot's DEAD and REFUTE.
        for buf, x in zip(trace_bufs, (state.slot_node, state.slot_phase,
                                       state.slot_start,
                                       state.slot_dead_round, *holders)):
            buf.index_copy_(0, step, x[None])
    step.add_(1)
    return state, hist, nem_state


def _on(dev: torch.device, tup):
    return type(tup)(*(tuple(x.to(dev) for x in t) if _sharded(t)
                       else t.to(dev) for t in tup))


# The registers the eager round writes in place besides the belief
# matrix: the probe tick's slot bookkeeping (``gossip/probe.py``) and the
# finish step's (``gossip/finish_slots.py``).
_IN_PLACE = ("slot_node", "slot_phase", "slot_inc", "slot_start",
             "slot_nsusp", "slot_dead_round", "slot_of_node", "incarnation",
             "member", "drops", "n_detected", "sum_detect_rounds",
             "n_false_dead", "n_refuted")


def _own_state(state: SwimState, dev: torch.device,
               heard: bool = True) -> SwimState:
    """``state`` with its belief matrix (each shard of it; not with
    ``heard=False``) and the registers of ``_IN_PLACE`` copied onto
    ``dev``: the eager round writes them in place, so an eager entry point
    gives it copies of the caller's, once a call."""
    regs = {f: getattr(state, f).to(dev, copy=True) for f in _IN_PLACE}
    if heard:
        h = state.heard
        regs["heard"] = (tuple(x.to(dev, copy=True) for x in h)
                         if _sharded(h) else h.to(dev, copy=True))
    return state._replace(**regs)


def _own_nem(nem_state, dev: torch.device):
    """A copy of NemState on ``dev`` (the probe tick and the finish step
    write it in place), or None."""
    if nem_state is None:
        return None
    return NemState(*(x.to(dev, copy=True) for x in nem_state))


def _own_hist(hist, dev: torch.device):
    """A copy of the banks on ``dev`` (the finish step adds into them in
    place), or None."""
    if hist is None:
        return None
    return HistBank(*(x.to(dev, copy=True) for x in hist))


def _graphed(graphed: bool | None, dev: torch.device) -> bool:
    """Whether a call runs the round program (a card's default) or the
    eager round."""
    if graphed is None:
        graphed = dev.type == "cuda"
    if graphed and dev.type != "cuda":
        raise ValueError(f"graphed rounds run on a CUDA card, not {dev}")
    return graphed


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
               sc=None, nem=None, nem_state=None, rnd: int | None = None):
    """One round; returns the state packed with whichever of hist and
    nem_state are threaded, in that order.  ``rnd`` is the caller's host
    mirror of ``state.round`` (None reads the counter from the device).
    The round writes the matrix and the registers of ``_IN_PLACE`` in
    place: an unsharded state is copied here, a sharded one comes from
    ``_sharded_setup(own=True)``."""
    _require_nem_state(nem, nem_state)
    dev = resolve_device(device)
    if sc is None:
        _require_unsharded(state)
        state = _own_state(state, dev)
    state = _on(dev, state)
    hist = _own_hist(hist, dev)
    nem_state = _own_nem(nem_state, dev)
    jr = None if join_round is None else _as_i32(join_round, dev)
    if rnd is None:
        rnd = _host_int(state.round)
    table = round_args.to_device(round_args.build(p, base_key, rnd, 1), dev)
    step = torch.zeros(1, dtype=torch.int64, device=dev)
    st, hb, ns = _round_once(p, table, step, state,
                             round_variant(p, nem, rnd),
                             _as_i32(fail_round, dev), jr, hist, nem_state,
                             sc, nem, probe_scratch=probe.scratch(p, dev))
    out = ((st,) + ((hb,) if hist is not None else ())
           + ((ns,) if nem_state is not None else ()))
    return out[0] if len(out) == 1 else out


def run_rounds(state: SwimState, base_key, fail_round, p: SwimParams,
               steps: int, trace: bool = False, join_round=None,
               flight: FlightRing | None = None,
               hist: HistBank | None = None, device=None,
               nem: NemesisParams | None = None,
               nem_state: NemState | None = None,
               graphed: bool | None = None):
    """Run ``steps`` rounds (reference ``run_rounds``), under the
    nemesis schedule ``nem`` if given.  On a card each chunk of up to
    512 rounds is one launch of the round program's loop graph over its
    captured rounds, its table filled by a kernel (``gossip/program.py``,
    the counterpart of the reference's ``jax.jit``); ``graphed=False``
    runs the eager round there instead (its plain version, bit-identical;
    the CPU always runs it).

    Returns ``(carry, trace)``: ``carry`` is ``state`` alone, or the
    tuple ``(state[, flight][, hist][, nem_state])`` when those are
    threaded; ``trace`` is a ``RoundTrace`` of ``[steps, S]`` tensors, or
    None.  ``base_key`` is a ``prng`` key (``uint32[2]``); ``fail_round``
    and ``join_round`` may be numpy arrays or tensors.  A scenario that
    needs ``NemState`` (Lifeguard LHM) must be given one
    (``init_nem_state``)."""
    _require_nem_state(nem, nem_state)
    _require_unsharded(state)
    dev = resolve_device(device)
    graphed = _graphed(graphed, dev)
    if not graphed:
        state = _own_state(state, dev)
    return _run_rounds_impl(state, base_key, fail_round, p, steps, trace,
                            join_round, flight, hist, dev, nem=nem,
                            nem_state=nem_state, graphed=graphed)


def _run_rounds_impl(state, base_key, fail_round, p, steps, trace,
                     join_round, flight, hist, dev, sc=None, nem=None,
                     nem_state=None, graphed: bool = False):
    """The rounds of ``run_rounds`` / ``run_rounds_sharded`` (``graphed``
    as ``_graphed`` decided it); the eager route's matrix and registers are
    already the call's own (``_own_state``), its NemState and banks are
    copied here."""
    state = _on(dev, state)
    fail_round = _as_i32(fail_round, dev)
    join_round = None if join_round is None else _as_i32(join_round, dev)
    hist = None if hist is None else _on(dev, hist)
    nem_state = None if nem_state is None else _on(dev, nem_state)
    flight = None if flight is None else _on(dev, flight)
    if nem is not None:
        _require_join(nem, join_round)
    if graphed:
        from consul_tpu_torch.gossip import program
        return program.run_rounds(state, base_key, fail_round, p, steps,
                                  trace, join_round, flight, hist, sc, nem,
                                  nem_state)
    nem_state = _own_nem(nem_state, dev)
    hist = _own_hist(hist, dev)
    rnd = _host_int(state.round)
    rows, cur, R = None, 0, 1
    if flight is not None:
        rows = flight.rows.clone()
        R = rows.shape[0]
        cur = _host_int(flight.cursor)
    table = round_args.to_device(
        round_args.build(p, base_key, rnd, steps, cur, R), dev)
    step = torch.zeros(1, dtype=torch.int64, device=dev)
    bufs = ([torch.zeros((steps, p.slots), dtype=_I32, device=dev)
             for _ in RoundTrace._fields] if trace else None)
    obs_scratch = observe.counts_scratch(p.slots, dev)
    probe_scratch = probe.scratch(p, dev)
    for k in range(steps):
        state, hist, nem_state = _round_once(
            p, table, step, state, round_variant(p, nem, rnd + k),
            fail_round, join_round, hist, nem_state, sc, nem, rows, bufs,
            obs_scratch=obs_scratch, probe_scratch=probe_scratch)
    return _carry(state, flight, rows, steps, hist, nem_state), (
        RoundTrace(*bufs) if trace else None)


def _carry(state, flight, rows, steps, hist, nem_state):
    """``run_rounds``' carry: the state alone, or the tuple with the
    flight ring, the banks and NemState where threaded."""
    out = [state]
    if flight is not None:
        out.append(FlightRing(rows=rows, cursor=flight.cursor + steps))
    if hist is not None:
        out.append(hist)
    if nem_state is not None:
        out.append(nem_state)
    return out[0] if len(out) == 1 else tuple(out)


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
    contiguous column shards, new tensors; every other register is held
    once."""
    _require_unsharded(state)
    dev = resolve_device(device)
    S, N = state.heard.shape
    if ndev < 1 or N % ndev:
        raise ValueError(f"cannot split n={N} observer columns into "
                         f"ndev={ndev} shards")
    L = N // ndev
    st = _on(dev, state)
    return st._replace(heard=tuple(
        st.heard[:, i * L:(i + 1) * L].clone(
            memory_format=torch.contiguous_format) for i in range(ndev)))


def unshard_state(state: SwimState) -> SwimState:
    """The inverse of ``shard_state``: ``heard`` as one [S, N] tensor
    (an unsharded state is returned as it is)."""
    if not _sharded(state.heard):
        return state
    return state._replace(heard=torch.cat(state.heard, dim=1))


def _sharded_setup(state, p, ndev, device, own: bool = False):
    """(state on the device with ndev shards, its _ShardCtx, device);
    ``own``: the shards and the registers of ``_IN_PLACE`` are the call's
    own (a new split of an unsharded state, else copies of the caller's
    shards; copies of the registers), which the eager round writes in
    place."""
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
        state = _on(dev, _own_state(state, dev) if own else state)
    else:
        state = shard_state(state, ndev, dev)
        if own:
            state = _own_state(state, dev, heard=False)
    return state, _ShardCtx(ndev, L), dev


def sharded_round_callable(p: SwimParams, ndev: int, has_join: bool = False,
                           has_hist: bool = False,
                           nem: NemesisParams | None = None,
                           has_nem_state: bool = False, device=None):
    """The single round on ``ndev`` column shards of one device, as a
    callable (reference ``sharded_round_callable``; the multi-DC round
    runs each DC's LAN pool through it).  Signature: ``(state, base_key,
    fail_round[, join_round][, hist][, nem_state], rnd=None)`` -> the
    sharded state, packed with whichever of hist and nem_state are
    threaded.  ``state`` may be sharded (``ndev`` shards) or not;
    ``rnd`` is the caller's host mirror of ``state.round`` (None reads
    it).  Constraints: ``_check_shardable``, raised here."""
    _check_shardable(p, ndev)

    def _round(state, base_key, fail_round, *rest, rnd: int | None = None):
        rest = iter(rest)
        join_round = next(rest) if has_join else None
        hist = next(rest) if has_hist else None
        nem_state = next(rest) if has_nem_state else None
        state, sc, dev = _sharded_setup(state, p, ndev, device, own=True)
        return _one_round(state, base_key, fail_round, p, hist, join_round,
                          dev, sc, nem, nem_state, rnd)

    return _round


def swim_round_sharded(state: SwimState, base_key, fail_round,
                       p: SwimParams, join_round=None, ndev: int | None = None,
                       device=None, nem: NemesisParams | None = None,
                       nem_state: NemState | None = None):
    """``swim_round`` on ``ndev`` column shards (reference
    ``swim_round_sharded``): bit-identical to it, returns the sharded
    state (with ``nem_state``, as ``swim_round`` does).  ``ndev=None``
    takes a sharded state's own shard count."""
    _require_nem_state(nem, nem_state)
    state, sc, dev = _sharded_setup(state, p, ndev, device, own=True)
    return _one_round(state, base_key, fail_round, p, None, join_round,
                      dev, sc, nem, nem_state)


def run_rounds_sharded(state: SwimState, base_key, fail_round, p: SwimParams,
                       steps: int, trace: bool = False, join_round=None,
                       flight: FlightRing | None = None,
                       hist: HistBank | None = None,
                       nem: NemesisParams | None = None,
                       nem_state: NemState | None = None,
                       ndev: int | None = None, device=None,
                       graphed: bool | None = None):
    """``run_rounds`` on ``ndev`` column shards (reference
    ``run_rounds_sharded``): same contract and return shape, bit-identical
    results, the carry's state sharded; ``nem_state`` is held once.
    ``state`` may be sharded (with ``ndev`` shards) or not (it is sharded
    here).  Graphed on a card as ``run_rounds`` is.  Constraints:
    ``_check_shardable``."""
    _require_nem_state(nem, nem_state)
    dev = resolve_device(device)
    graphed = _graphed(graphed, dev)
    state, sc, dev = _sharded_setup(state, p, ndev, dev, own=not graphed)
    return _run_rounds_impl(state, base_key, fail_round, p, steps, trace,
                            join_round, flight, hist, dev, sc, nem,
                            nem_state, graphed)
