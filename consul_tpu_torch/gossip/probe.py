"""The round's probe tick: the prober block's lanes, the slot bookkeeping,
the rearmed rows' wipe and the marks, the Hopper kernels and their plain
torch versions.

The reference runs its probe tick (``consul_tpu/gossip/kernel.py:519-822``,
``_probe_tick``: direct probe -> K indirect probes -> suspicion initiation
for the round's prober block, its ``jax.random`` draws included) as one
stretch of its jitted round, which XLA fuses; there is no Pallas source.
The round (``gossip/kernel.py``'s ``_probe_tick``) runs it here in four
steps, in the reference's order, two launches on a card:

- ``lanes``: per prober lane (``B = ceil(N / probe_every)`` lanes, prober
  ``blk + lane``, padding lanes past ``N``), the probes and their draws,
  the belief byte at (the target's slot, the prober's column), Lifeguard's
  LHM and streak in place (when NemState is threaded); into the scratch,
  a flag a lane that initiates, the needy targets' segment minima and the
  statistics' counts;
- ``slots``: the S slot registers in place: initiators join a live
  episode or re-arm a REFUTED / JOIN one, the candidates take the free
  slots, ``slot_of_node`` and ``drops`` follow; returns the rearm flags
  ``[S]`` and ``probe_stats`` ``[4]``, and resets the scratch;
- the rearmed rows' wipe;
- ``marks``: each initiator's own belief byte after the wipe.

On CUDA tensors the lanes and the slot step are one launch of
``csrc/probe.cu`` (entry point ``probe_lanes_slots``: the slot step run
by the last block of the lanes to arrive; dispatcher ``lanes_and_slots``)
and the wipe and the marks another (``probe_rearm_marks``: a byte of a
rearmed row written by the thread that wipes it, the mark included, a
byte of another row by the lane that owns its column; dispatcher
``rearm_and_marks``); the draws are made inline from
``csrc/threefry.cuh``, no launch of ``threefry.cu``.  On CPU tensors each
step is its plain version (``probe_lanes_ref``, ``probe_slots_ref``,
``finish.wipe_rows_ref``, ``probe_marks_ref``: the port's former
expressions of the tick, cut at the steps' boundaries; the draws their
``prng.*_ref`` twins, which ``prng.calls`` does not count), the first two
through the plain steps ``lanes`` and ``slots``.  There is no fallback: a CUDA tensor
launches the kernel or raises.  ``heard`` is one u8 ``[S, N]`` tensor or a
tuple of ``[S, L]`` column shards (one launch serves every shard).  The
round's scalars (the round, the prober block, the probe offsets, the keys)
are read from its row of ``round_args``' table on the device, nothing is
read back to the host, and the scratch is the caller's (``scratch``; one
per round program), so the launches run inside the round program's
captured graphs as they are.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from consul_tpu_torch import _build, prng
from consul_tpu_torch._device import check_tensor, require_cuda
from consul_tpu_torch.gossip import finish
from consul_tpu_torch.gossip.belief import (_AGE_FRESH, _CONF_MASK,
                                            _CONF_SHIFT, _MSG_SHIFT,
                                            MSG_DEAD, MSG_SUSPECT)
from consul_tpu_torch.gossip.slot_ops import (alloc_free_slots, get_points,
                                              put_points, segment_min,
                                              set_drop)

_I32 = torch.int32
MAX_SHARDS = 64    # kMaxShards of csrc/probe.cu
STAGED_SLOTS = 1024  # kMaxSlots: past it the wide kernels
MAX_SLOTS = 1 << 24  # kSlotCeiling
MAX_HELPERS = 64   # kMaxHelpers
COUNTS = 8         # kCounts: the scratch's count words
# Slot phases (kernel.PHASE_*).
_SUSPECT, _REFUTED, _JOIN = 1, 3, 4
# The partition legs: none, the hash groups, the halves (kNoPartition,
# kHash, kHalves).
_PARTS = {"hash": 1, "contig": 2}
_FRESH = (MSG_SUSPECT << _MSG_SHIFT) | _AGE_FRESH

# Kernel launches made by the two entry points (one per launch, nowhere
# else), and by both.
lanes_slots_launches = 0
rearm_marks_launches = 0
launches = 0
# (kernel, B, S, N, L, ndev, variant) of every launch, so a smoke run can
# hold each shape its paths launched at against the plain versions;
# ``variant`` is (partition legs, degraded observers, K, LHM threaded).
launch_shapes: set = set()


class Config(NamedTuple):
    """What the tick takes from the parameters, the round's variant and
    the nemesis schedule (host values; the probabilities are the float32
    values the reference compares its draws with)."""

    N: int
    B: int
    S: int
    K: int          # indirect probe helpers
    part: int       # partition legs in this round: 0, or 1 hash, 2 halves
    degraded: bool  # the prober block meets the degraded observers
    obs_lo: int
    obs_hi: int
    lhm_max: int
    p_dl: float     # direct probe of a live target lost
    p_il: float     # one indirect relay of a live target lost
    p_one: float    # a cross-group round trip dropped
    p_two: float    # two cross-group round trips, either dropped
    p_obs: float    # a degraded observer misses a reply

    @property
    def kk(self) -> int:
        """Candidates a round: segments of the prober block."""
        return min(self.S, self.N, self.B)

    def variant(self, lhm: bool) -> tuple:
        return (self.part, self.degraded, self.K, lhm)


def block_size(p) -> int:
    """Probers a round: each node probes once per ``probe_every`` rounds,
    in contiguous id blocks."""
    return max(1, -(-p.n // p.probe_every))


def config(p, v, nem=None) -> Config:
    """The tick's configuration for the parameters ``p``, the round's
    ``kernel.Variant`` ``v`` and the nemesis schedule ``nem`` (or None):
    the partition legs inside the fault window, the degraded observers
    where the prober block meets them (``v.degraded``)."""
    f32 = prng._f32
    part, degraded, p_one, p_two, p_obs = 0, False, 0.0, 0.0, 0.0
    obs_lo = obs_hi = lhm_max = 0
    if nem is not None:
        lhm_max = nem.lhm_max
        if nem.has_partition and v.in_window:
            part = _PARTS.get(nem.part_kind, 2)
            p1 = nem.p_roundtrip
            p_one = f32(p1)
            p_two = f32(1.0 - (1.0 - p1) * (1.0 - p1))  # float64 on the host
        if v.degraded:
            degraded, obs_lo, obs_hi = True, nem.obs_lo, nem.obs_hi
            p_obs = f32(nem.p_obs_miss)
    return Config(N=p.n, B=block_size(p), S=p.slots,
                  K=p.indirect_k, part=part, degraded=degraded,
                  obs_lo=obs_lo, obs_hi=obs_hi, lhm_max=lhm_max,
                  p_dl=f32(p.p_direct_fail_alive),
                  p_il=f32(p.p_indirect_fail_alive), p_one=p_one,
                  p_two=p_two, p_obs=p_obs)


def scratch_words(S: int, B: int) -> int:
    """The int32 words of the tick's scratch (``probe_scratch_words`` of
    ``csrc/probe.cu``): the minima, the counts (the last the kernel's
    arrival counter) and the lanes' flag bytes; past ``STAGED_SLOTS``
    slots, S words more (the wide slot step's free slots by rank, 0
    between rounds)."""
    return (min(S, B) + COUNTS + -(-B // 4)
            + (S if S > STAGED_SLOTS else 0))


def scratch(p, device) -> torch.Tensor:
    """A scratch for the tick of the parameters ``p`` on ``device``: the
    minima at N, the counts and the arrival counter at 0 (as every round
    leaves them)."""
    B = block_size(p)
    kk = min(p.slots, p.n, B)
    out = torch.zeros(scratch_words(p.slots, B), dtype=_I32, device=device)
    out[:kk] = p.n
    return out


def _views(cfg: Config, sp: torch.Tensor):
    """The scratch's minima, counts and flags."""
    kk = cfg.kk
    flags = sp[kk + COUNTS:].view(torch.uint8)[:cfg.B]
    return sp[:kk], sp[kk:kk + COUNTS], flags


def _shards(heard) -> tuple:
    return heard if isinstance(heard, tuple) else (heard,)


def _below(k, shape, p: float, device) -> torch.Tensor:
    """``uniform(k, shape) < p`` for a float32 ``p``; a certain outcome is
    not drawn."""
    if p <= 0.0 or p >= 1.0:
        return torch.full(shape, p >= 1.0, dtype=torch.bool, device=device)
    return prng.below_ref(k, shape, p, device)


def group(hashed: bool, n: int, device) -> torch.Tensor:
    """Partition group bit per node (``nemesis.group_of``), i32 [n]: the
    top bit of the uint32 product with 2654435761 (carried in int64), or
    ``id >= n // 2``."""
    ids = torch.arange(n, dtype=torch.int64, device=device)
    if hashed:
        return (((ids * 2654435761) & 0xFFFFFFFF) >> 31).to(_I32)
    return (ids >= n // 2).to(_I32)


# -- the plain versions ----------------------------------------------------------

def probe_lanes_ref(cfg: Config, ra, mf: torch.Tensor, heard,
                    slot_of_node: torch.Tensor, nem_state,
                    sp: torch.Tensor) -> None:
    """The plain version of ``probe_lanes_slots``' lanes, on any device:
    the lanes' flags into the scratch ``sp``, their needy targets'
    segment minima (a min with what it holds) and the counts (probes,
    acks missed, indirect escalations, suspicions, needy targets; added);
    NemState's LHM and streak (``nem_state``, or None) written at the
    valid probers."""
    N, S, B, K = cfg.N, cfg.S, cfg.B, cfg.K
    dev = mf.device
    rnd = ra.rnd
    pid = ra.blk + torch.arange(B, dtype=_I32, device=dev)
    pid_c = pid.clamp(max=N - 1)
    pvalid = pid < N

    def at(x, shift=None):
        # x[(pid + shift) mod N]: a window at the prober block.
        i = pid if shift is None else pid + shift
        return x[i.remainder(N).long()]

    offs = ra.probe
    o_t = offs[0]
    tgt = (pid_c + o_t) % N
    prober_ok = pvalid & (at(mf) > rnd)
    mf_t = at(mf, o_t)
    tgt_member = mf_t >= 0
    tgt_alive = mf_t > rnd

    # The nemesis legs, off the probe key's four-way split.
    k_np, k_no, k_nip, k_nio = ra.k_nem
    part = degraded = dir_nem_drop = None
    if cfg.part:
        grp = group(cfg.part == 1, N, dev)
        g_p, g_t = at(grp), at(grp, o_t)
        part = (grp, g_p, g_t)
        dir_nem_drop = (g_p != g_t) & _below(k_np, (B,), cfg.p_one, dev)
    if cfg.degraded:
        degraded = (pid >= cfg.obs_lo) & (pid < cfg.obs_hi)
        miss = degraded & _below(k_no, (B,), cfg.p_obs, dev)
        dir_nem_drop = miss if dir_nem_drop is None else dir_nem_drop | miss

    lost = ~tgt_alive | _below(ra.k_dl, (B,), cfg.p_dl, dev)
    if dir_nem_drop is not None:
        lost = lost | dir_nem_drop
    direct_fail = tgt_member & lost

    if K:
        hu = prng.uniform_ref(ra.k_hl, (B, K), dev)
        helpers = (pid[:, None] + offs[None, 1:]).remainder(N).long()
        helper_alive = mf[helpers] > rnd
        ind_ok = (helper_alive & (tgt_alive & tgt_member)[:, None]
                  & (hu >= cfg.p_il))
        if part is not None:
            # Prober<->helper and helper<->target round trips: one draw a
            # helper at the combined drop probability of its crossings.
            grp, g_p, g_t = part
            g_h = grp[helpers]
            n_cross = ((g_p[:, None] != g_h).to(_I32)
                       + (g_h != g_t[:, None]).to(_I32))
            if cfg.p_one >= 1.0:
                ind_ok = ind_ok & (n_cross == 0)
            elif cfg.p_one > 0.0:
                p_ind = torch.full((B, K), cfg.p_two, dtype=torch.float32,
                                   device=dev).masked_fill(n_cross == 1,
                                                           cfg.p_one)
                ind_ok = ind_ok & ~((n_cross > 0) & (
                    prng.uniform_ref(k_nip, (B, K), dev) < p_ind))
        if degraded is not None:
            ind_ok = ind_ok & ~(degraded[:, None] & _below(
                k_nio, (B, K), cfg.p_obs, dev))
        rescued = ind_ok.any(dim=1)
    else:
        rescued = torch.zeros((B,), dtype=torch.bool, device=dev)
    init = prober_ok & direct_fail & ~rescued

    # Don't re-suspect a target this prober already believes dead.
    s_t = at(slot_of_node, o_t)
    cur = get_points(heard, s_t.clamp(0, S - 1).long(), pid_c.long())
    init = init & ~((s_t >= 0) & ((cur >> _MSG_SHIFT) == MSG_DEAD))

    if nem_state is not None:
        # Lifeguard LHM: suspect only after more consecutive direct misses
        # than the LHM; up on a miss the helpers contradict, down on a
        # clean probe.
        lhm, streak = nem_state
        lhm_b, streak_b = at(lhm), at(streak)
        miss = prober_ok & tgt_member & direct_fail
        streak_new = torch.where(
            miss, (streak_b + 1).clamp(max=cfg.lhm_max + 1), 0)
        init = init & (streak_new > lhm_b)
        lhm_new = (lhm_b + (miss & rescued).to(_I32)
                   - (prober_ok & tgt_member & ~direct_fail).to(_I32)
                   ).clamp(0, cfg.lhm_max)
        # In place at the valid probers; a padding lane rewrites the value
        # at pid mod N (below the block: no valid lane's) as it is.
        idx = pid.remainder(N).long()
        lhm.index_put_((idx,), torch.where(pvalid, lhm_new, lhm[idx]))
        streak.index_put_((idx,), torch.where(pvalid, streak_new,
                                              streak[idx]))

    need_b = init & (s_t < 0) & (mf_t >= 0)
    minima, counts, flags = _views(cfg, sp)
    torch.minimum(minima, segment_min(torch.where(need_b, tgt, N), cfg.kk,
                                       N), out=minima)
    missed = (prober_ok & direct_fail).sum(dtype=_I32)
    counts[:5] += torch.stack([
        prober_ok.sum(dtype=_I32), missed,
        (prober_ok & direct_fail & tgt_member).sum(dtype=_I32),
        init.sum(dtype=_I32), need_b.sum(dtype=_I32)])
    flags.copy_(init.to(torch.uint8))


def probe_slots_ref(cfg: Config, ra, slots: tuple,
                    slot_of_node: torch.Tensor, incarnation: torch.Tensor,
                    drops: torch.Tensor, sp: torch.Tensor):
    """The plain version of ``probe_lanes_slots``' slot step, on any
    device, after ``probe_lanes_ref``: the slot registers ``slots``
    (slot_node, slot_phase, slot_inc, slot_start, slot_nsusp,
    slot_dead_round), ``slot_of_node`` and ``drops`` in place, from the
    lanes' flags, minima and counts in the scratch ``sp``, which goes
    back to N minima and 0 counts.  Returns ``(rearm, stats)``: bool
    ``[S]`` and int32 ``[4]``."""
    N, B = cfg.N, cfg.B
    slot_node, slot_phase, slot_inc, slot_start, slot_nsusp, slot_dead = \
        slots
    rnd = ra.rnd
    minima, counts, flags = _views(cfg, sp)
    init_i = flags.to(_I32)
    node_c = slot_node.clamp(0, N - 1)
    valid = slot_node >= 0

    # Circulant targets are distinct within a round, so a slot's subject
    # has at most one initiator: i = (subject - blk - o) mod N.
    i_s = (node_c - ra.blk - ra.probe[0]) % N
    in_blk = valid & (i_s < B)
    add_here = torch.where(in_blk, init_i[i_s.clamp(max=B - 1).long()], 0)
    want = add_here > 0
    # Existing suspect episodes absorb new initiators; a refuted (or
    # freshly-joined) episode re-arms as a suspicion.
    nsusp = torch.where((slot_phase == _SUSPECT) & want,
                        slot_nsusp + add_here, slot_nsusp)
    rearm = ((slot_phase == _REFUTED) | (slot_phase == _JOIN)) & want
    slot_phase.copy_(torch.where(rearm, _SUSPECT, slot_phase))
    slot_inc.copy_(torch.where(rearm, incarnation[node_c.long()], slot_inc))
    slot_start.copy_(torch.where(rearm, rnd, slot_start))
    slot_nsusp.copy_(torch.where(rearm, add_here, nsusp))
    slot_dead.copy_(torch.where(rearm, -1, slot_dead))

    # Fresh slots for the candidates (the segment minima).
    can, slot_k, sidx = alloc_free_slots(~valid, minima < N)
    cand_c = minima.clamp(0, N - 1)
    for reg, val in ((slot_node, cand_c), (slot_phase, _SUSPECT),
                     (slot_inc, incarnation[cand_c.long()]),
                     (slot_start, rnd), (slot_nsusp, 1), (slot_dead, -1)):
        reg.copy_(set_drop(reg, sidx, val))
    slot_of_node.copy_(set_drop(slot_of_node, torch.where(can, cand_c, N),
                                 slot_k))
    drops.add_(counts[4] - can.sum(dtype=_I32))
    stats = counts[:4].clone()
    minima.fill_(N)
    counts.zero_()
    return rearm, stats


def probe_marks_ref(cfg: Config, ra, heard, slot_of_node: torch.Tensor,
                    sp: torch.Tensor) -> None:
    """The plain version of ``probe_rearm_marks``' marks, on any device,
    after the rearmed rows' wipe: each initiator (a flag of the scratch
    ``sp``) marks its own belief byte at its target's slot, in place,
    where the byte is at most SUSPECT."""
    N, S, B = cfg.N, cfg.S, cfg.B
    init = _views(cfg, sp)[2] != 0
    pid = ra.blk + torch.arange(B, dtype=_I32, device=slot_of_node.device)
    s_t2 = slot_of_node[(pid + ra.probe[0]).remainder(N).long()]
    rows = s_t2.clamp(0, S - 1).long()
    cols = pid.clamp(max=N - 1).long()
    cur = get_points(heard, rows, cols)
    ok = init & (s_t2 >= 0) & ((cur >> _MSG_SHIFT) <= MSG_SUSPECT)
    fresh = _FRESH | (cur & (_CONF_MASK << _CONF_SHIFT))
    # Each shard takes the marks in the columns it owns.
    shards = _shards(heard)
    L = shards[0].shape[1]
    for i, h in enumerate(shards):
        owned = (cols >= i * L) & (cols < (i + 1) * L)
        loc = (cols - i * L).clamp(0, L - 1)
        put_points(h, rows * L + loc, fresh, owned & ok)


# -- the kernels -----------------------------------------------------------------

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# Every entry point's arguments: the shard table, ndev, the pointer table,
# the integers, the probabilities and the stream.
_ARGTYPES = [ctypes.POINTER(_VP), _CI, ctypes.POINTER(_VP),
             ctypes.POINTER(_CI), ctypes.POINTER(ctypes.c_float), _VP]
ENTRY_POINTS = ("probe_lanes_slots", "probe_rearm_marks")


@functools.lru_cache(maxsize=None)
def _lib():
    """The entry points of ``csrc/probe.cu``, built and loaded, and the
    library's error-string function, all typed."""
    lib = _build.load("probe")
    fns = tuple(getattr(lib, name) for name in ENTRY_POINTS)
    for fn in fns:
        fn.argtypes, fn.restype = _ARGTYPES, _CI
    lib.probe_error.argtypes = [_CI]
    lib.probe_error.restype = ctypes.c_char_p
    return fns, lib.probe_error


def lanes_slots_blocks(B: int) -> int:
    """The blocks of a ``probe_lanes_slots`` launch at ``B`` lanes on the
    current CUDA device: one wave at the occupancy the card gives, or one
    block a chunk of 256 lanes where that is fewer."""
    lib = _build.load("probe")
    fn = lib.probe_lanes_slots_blocks
    fn.argtypes, fn.restype = [_CI], _CI
    n = fn(B)
    if n < 0:
        raise RuntimeError(f"probe_lanes_slots_blocks: "
                           f"{_lib()[1](-n).decode()}")
    return n


def rearm_marks_blocks(B: int, S: int, N: int, ndev: int) -> int:
    """The blocks of a ``probe_rearm_marks`` launch on the current CUDA
    device: one wave of at most 4 blocks an SM, or fewer where the flags'
    chunks of 16 and the S rows' spans of 4,096 columns are fewer."""
    lib = _build.load("probe")
    fn = lib.probe_rearm_marks_blocks
    fn.argtypes, fn.restype = [_CI] * 4, _CI
    n = fn(B, S, N, ndev)
    if n < 0:
        raise RuntimeError(f"probe_rearm_marks_blocks: "
                           f"{_lib()[1](-n).decode()}")
    return n


class Tick(NamedTuple):
    """One round's tensors of the tick (the kernels' pointer table)."""

    heard: object              # u8 [S, N] or a tuple of [S, L] shards
    ra: object                 # the round's row (round_args.RoundArgs)
    mf: torch.Tensor           # i32 [N]
    slot_of_node: torch.Tensor  # i32 [N]
    nem_state: object          # NemState (lhm, streak) or None
    slots: tuple               # the six i32 [S] slot registers
    incarnation: torch.Tensor  # i32 [N]
    drops: torch.Tensor        # i32 scalar
    sp: torch.Tensor           # the scratch


def _checked(cfg: Config, t: Tick):
    """The shards after the checks every entry point makes, and their
    device."""
    shards = _shards(t.heard)
    ndev = len(shards)
    if not 1 <= ndev <= MAX_SHARDS:
        raise ValueError(f"the probe tick takes 1 to {MAX_SHARDS} shards, "
                         f"got {ndev}")
    require_cuda("the probe tick", shards[0])
    dev = shards[0].device
    N, S = cfg.N, cfg.S
    if N % ndev or not 1 <= S <= MAX_SLOTS or cfg.K > MAX_HELPERS \
            or N >= 2**30:
        raise ValueError(f"the probe tick takes S <= {MAX_SLOTS}, K <= "
                         f"{MAX_HELPERS}, N below 2**30 and divisible by "
                         f"the shards, got S={S}, K={cfg.K}, N={N}, "
                         f"ndev={ndev}")
    for i, h in enumerate(shards):
        check_tensor(f"shard {i}", h, torch.uint8, (S, N // ndev), dev)
    for name, x, n in (("mf", t.mf, N), ("slot_of_node", t.slot_of_node, N),
                       ("incarnation", t.incarnation, N)):
        check_tensor(name, x, _I32, (n,), dev)
    for i, x in enumerate(t.slots):
        check_tensor(f"slot register {i}", x, _I32, (S,), dev)
    check_tensor("drops", t.drops, _I32, (), dev)
    if t.nem_state is not None:
        for name, x in zip(("lhm", "streak"), t.nem_state):
            check_tensor(name, x, _I32, (N,), dev)
    check_tensor("scratch", t.sp, _I32, (scratch_words(S, cfg.B),), dev)
    ra = t.ra
    for name, x, n in (("rnd", ra.rnd, 1), ("blk", ra.blk, 1),
                       ("probe", ra.probe, 1 + cfg.K), ("k_dl", ra.k_dl, 2),
                       ("k_hl", ra.k_hl, 2), ("k_nem", ra.k_nem, 8)):
        if x.dtype != _I32 or x.numel() != n or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"the row's {name} must be {n} contiguous "
                             f"int32 words on {dev}, got {x.dtype}"
                             f"{list(x.shape)} on {x.device}")
    return shards, dev


def _launch(which: int, cfg: Config, t: Tick, rearm=None,
            stats=None) -> None:
    """One launch of entry point ``ENTRY_POINTS[which]`` on the current
    stream; raises if it was refused."""
    global launches, lanes_slots_launches, rearm_marks_launches
    shards, dev = _checked(cfg, t)
    fns, err = _lib()  # built at the first launch; a failed build raises
    ra = t.ra
    lhm = streak = None
    if t.nem_state is not None:
        lhm, streak = (x.data_ptr() for x in t.nem_state)
    ptrs = (_VP * 21)(
        ra.rnd.data_ptr(), ra.blk.data_ptr(), ra.probe.data_ptr(),
        ra.k_dl.data_ptr(), ra.k_hl.data_ptr(), ra.k_nem.data_ptr(),
        t.mf.data_ptr(), t.slot_of_node.data_ptr(), lhm, streak,
        *(x.data_ptr() for x in t.slots), t.incarnation.data_ptr(),
        t.drops.data_ptr(),
        None if rearm is None else rearm.data_ptr(),
        None if stats is None else stats.data_ptr(), t.sp.data_ptr())
    ints = (_CI * 9)(cfg.N, cfg.B, cfg.S, cfg.K, cfg.part,
                     int(cfg.degraded), cfg.obs_lo, cfg.obs_hi, cfg.lhm_max)
    floats = (ctypes.c_float * 5)(cfg.p_dl, cfg.p_il, cfg.p_one, cfg.p_two,
                                  cfg.p_obs)
    table = (_VP * len(shards))(*(h.data_ptr() for h in shards))
    name = ENTRY_POINTS[which]
    _build.launch(fns[which], err, name, dev, table, len(shards), ptrs,
                  ints, floats)
    launches += 1
    if which == 0:
        lanes_slots_launches += 1
    else:
        rearm_marks_launches += 1
    launch_shapes.add((name, cfg.B, cfg.S, cfg.N, cfg.N // len(shards),
                       len(shards), cfg.variant(t.nem_state is not None)))


def probe_lanes_slots(cfg: Config, t: Tick):
    """Launch ``probe_lanes_slots`` of ``csrc/probe.cu``:
    ``probe_lanes_ref`` then ``probe_slots_ref`` (their arguments,
    gathered in ``t``) in one launch.  Returns new ``(rearm, stats)``,
    bool [S] and int32 [4]."""
    dev = t.mf.device
    rearm = torch.empty((cfg.S,), dtype=torch.bool, device=dev)
    stats = torch.empty((4,), dtype=_I32, device=dev)
    _launch(0, cfg, t, rearm, stats)
    return rearm, stats


def probe_rearm_marks(cfg: Config, t: Tick, rearm: torch.Tensor) -> None:
    """Launch ``probe_rearm_marks``: ``finish.wipe_rows_ref`` of the rows
    ``rearm`` flags (bool [S], ``probe_lanes_slots``' output), then
    ``probe_marks_ref``'s marks, in one launch, in place."""
    check_tensor("rearm", rearm, torch.bool, (cfg.S,), t.mf.device)
    _launch(1, cfg, t, rearm)


# -- the round's dispatchers ------------------------------------------------------

def _on_cpu(t: Tick) -> bool:
    return _shards(t.heard)[0].device.type == "cpu"


def _alone(step: str, t: Tick) -> None:
    if not _on_cpu(t):
        raise ValueError(f"the probe tick's {step} runs alone only on CPU "
                         f"tensors; on a card it is part of the one launch "
                         f"of lanes_and_slots")


def lanes(cfg: Config, t: Tick) -> None:
    """The lanes step of the module docstring on CPU tensors: its plain
    version."""
    _alone("lanes step", t)
    probe_lanes_ref(cfg, t.ra, t.mf, t.heard, t.slot_of_node, t.nem_state,
                    t.sp)


def slots(cfg: Config, t: Tick):
    """The slot step on CPU tensors, after ``lanes``: ``(rearm,
    stats)``."""
    _alone("slot step", t)
    return probe_slots_ref(cfg, t.ra, t.slots, t.slot_of_node,
                           t.incarnation, t.drops, t.sp)


def lanes_and_slots(cfg: Config, t: Tick):
    """The lanes and the slot step: ``(rearm, stats)``.  The kernel on
    CUDA tensors (one launch), ``lanes`` then ``slots`` on CPU
    tensors."""
    if _on_cpu(t):
        lanes(cfg, t)
        return slots(cfg, t)
    return probe_lanes_slots(cfg, t)


def rearm_and_marks(cfg: Config, t: Tick, rearm: torch.Tensor) -> None:
    """The rearmed rows' wipe and the marks step, after the slot step
    (``rearm``: its flags): the kernel on CUDA tensors (one launch), the
    plain wipe then ``probe_marks_ref`` on CPU tensors."""
    if _on_cpu(t):
        finish.wipe_rows_ref(t.heard, rearm)
        probe_marks_ref(cfg, t.ra, t.heard, t.slot_of_node, t.sp)
    else:
        probe_rearm_marks(cfg, t, rearm)
