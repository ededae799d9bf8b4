"""The finish step's slot logic: refutation, the timer mask, verdicts,
detection statistics, the slot GC decision, the hist banks' adds and the
register writes, the Hopper kernels and their plain torch versions.

The reference runs its finish step (``consul_tpu/gossip/kernel.py:1461-1672``,
``_finish_round``) as one stretch of its jitted round, which XLA fuses;
there is no Pallas source.  Its belief-matrix passes are
``gossip/finish.py``'s (the refutation byte and the fire, the GC wipe) and
the spread's count ``gossip/observe.py``'s; the rest works on ``H`` rows of
slot registers, row ``h`` the slot ``idx[h]`` (``idx`` distinct slot ids:
every slot on the full tail, the hot tier's rows padded with free slots),
and runs here in three steps, around those passes in the reference's
order:

- ``decide``: the refutation (a live subject that hears of its own
  suspicion: its incarnation bumped, the slot REFUTED at dead round
  ``rnd``, ``n_refuted`` counted, Lifeguard's LHM bumped) and the fire
  pass's inputs, a 4-bit timer mask a row and the refutation's column and
  byte (``Decided``);
- the fire (``finish.fire``, called by the round), which returns ``fired``;
- ``settle``: the verdicts of the rows that fired, the detection
  statistics, the GC decision; the expired flags, the rows' marks and, with
  the hist banks, the spread's want mask and verdict (``Settled``);
- the spread's count (``observe.count``, with the hist banks);
- ``record``: the hist banks' adds, the dead subjects' member flags
  dropped, the expired slots' registers and ``slot_of_node`` entries reset;
- the GC wipe (``finish.wipe``).

Each step is one launch of ``csrc/finish_slots.cu`` on CUDA tensors (entry
points ``finish_decide``, ``finish_settle`` and ``finish_record``: one block,
a thread a row, or past 1,024 rows 1,024 threads taking several rows
each; the decide launch programmatic, overlapping the kernel
before it, which may write only the belief rows; the settle launch
programmatic behind the fire, which may write only ``fired`` of its
inputs; the record launch programmatic where it is given the holders,
behind the spread's count, which may write only those) and its plain
version on
CPU tensors (``finish_decide_ref``, ``finish_settle_ref``,
``finish_record_ref``: the port's former expressions of the step, cut at
the kernels' boundaries).
There is no fallback: a CUDA tensor launches the kernel or raises.  The
steps write the slot registers, ``slot_of_node``, ``incarnation``,
``member``, the four counters, LHM and the banks in place.  The round is
read from its row of ``round_args``' table on the device, the statics are
launch arguments, nothing is read back to the host and no output needs a
memset, so the launches run inside the round program's captured graphs as
they are.

One choice differs from the reference in form, not in any state a round
reaches: the reference clamps the whole LHM vector at ``lhm_max`` after
the refuters' bumps; here only the bumped entries are clamped.  Every other
writer of LHM (the probe tick) keeps it in ``[0, lhm_max]`` and
``init_nem_state`` starts it at 0, so the two agree on every state the
round reaches (``tests/test_torch_finish_slots.py`` holds the invariant
over whole runs).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from consul_tpu_torch import _build
from consul_tpu_torch._device import check_tensor, require_cuda
from consul_tpu_torch.gossip.belief import (_MSG_SHIFT, MSG_DEAD,
                                            MSG_REFUTE, MSG_SUSPECT)
from consul_tpu_torch.gossip.slot_ops import get_points, set_drop

_I32, _U8 = torch.int32, torch.uint8
MAX_SHARDS = 64    # kMaxShards of csrc/finish_slots.cu
MAX_ROWS = 1 << 24  # kMaxSlots: the slots (and rows) a launch takes; past
                    # kMaxRows (1,024) the wide kernels' threads take
                    # several rows each
MAX_BUCKETS = 256  # kMaxBuckets
# Slot phases (kernel.PHASE_*).
_FREE, _SUSPECT, _DEAD, _REFUTED, _JOIN = range(5)
_REFUTE_BYTE = MSG_REFUTE << _MSG_SHIFT  # REFUTE, conf 0, age 0
# The rows' marks (settle's, for record): a detection, a new verdict, a
# dead subject dropped.
DETECTED, NEW_VERDICT, DROPPED = 1, 2, 4

# Kernel launches made by the three entry points (one per launch, nowhere
# else), and by all three.
decide_launches = 0
settle_launches = 0
record_launches = 0
launches = 0
# (kernel, H, S, N, L, ndev, variant) of every launch, so a smoke run can
# hold each shape its paths launched at against the plain versions;
# ``variant`` is (refutation, LHM threaded, hist banks threaded).
launch_shapes: set = set()


class Config(NamedTuple):
    """What the step takes from the parameters and the nemesis schedule
    (host values no round changes)."""

    N: int
    S: int
    refute: bool
    budget: int      # spread_budget_rounds
    ttl: int         # slot_ttl_rounds
    lhm_max: int
    tbl: tuple       # the timeout table at confirmation counts 0..3

    @property
    def gc_rounds(self) -> int:
        """Rounds a verdict outlives before its slot is recycled."""
        return 2 * self.budget + 8


def config(p, nem=None) -> Config:
    """The step's configuration for the parameters ``p`` and the nemesis
    schedule ``nem`` (its ``lhm_max``; None without one).  The timeout
    table is read at ``min(c, conf_cap)`` with ``conf_cap`` at most
    ``max_confirmations``, so past its last entry it repeats that entry."""
    t = p.timeout_table()
    return Config(N=p.n, S=p.slots, refute=bool(p.refute),
                  budget=p.spread_budget_rounds, ttl=p.slot_ttl_rounds,
                  lhm_max=0 if nem is None else nem.lhm_max,
                  tbl=tuple(int(t[min(c, len(t) - 1)]) for c in range(4)))


class Step(NamedTuple):
    """One round's tensors of the step (the kernels' pointer table)."""

    heard: object               # u8 [H, N] or a tuple of [H, L] shards
    rnd: torch.Tensor           # i32 [1]: the round, from its row
    idx: torch.Tensor           # i32 [H]: distinct slot ids
    slots: tuple                # slot_node, slot_phase, slot_start,
                                #   slot_dead_round: i32 [S] each
    conf_cap: torch.Tensor      # i32 [S], in [0, max_confirmations]
    alive: torch.Tensor         # bool [N]
    member: torch.Tensor        # bool [N]
    fail_round: torch.Tensor    # i32 [N]
    slot_of_node: torch.Tensor  # i32 [N]
    incarnation: torch.Tensor   # i32 [N]
    stats: tuple                # n_detected, sum_detect_rounds,
                                #   n_false_dead, n_refuted: i32 scalars
    lhm: object                 # i32 [N] (NemState.lhm) or None
    hist: object                # kernel.HistBank or None


class Decided(NamedTuple):
    ok_mask: torch.Tensor  # u8 [H]: the fire pass's 4-bit timer masks
    refute: object         # (i32 [H] columns, u8 [H] bytes), or None


class Settled(NamedTuple):
    expired: torch.Tensor  # bool [H]: the GC wipe's rows
    marks: torch.Tensor    # u8 [H]: DETECTED | NEW_VERDICT | DROPPED
    spread: object         # bool [H]: the spread's rows, or None
    verdict: object        # i32 [H]: each row's verdict message, or None


def _shards(heard) -> tuple:
    return heard if isinstance(heard, tuple) else (heard,)


def _hist_add(bank: torch.Tensor, mask: torch.Tensor,
              val: torch.Tensor) -> None:
    """Masked observations into a bank, in place: each value clipped into
    the top (overflow) bucket, an unmasked row adding 0."""
    B = bank.shape[0]
    bank.index_add_(0, val.clamp(0, B - 1).long(), mask.to(_I32))


def _rows(cfg: Config, t: Step):
    """The rows' slot ids as an index, their registers and subjects."""
    il = t.idx.long()
    node = t.slots[0][il]
    node_c = node.clamp(0, cfg.N - 1)
    return il, node, node_c, node_c.long()


# -- the plain versions ----------------------------------------------------------

def finish_decide_ref(cfg: Config, t: Step) -> Decided:
    """The plain version of ``finish_decide``, on any device: the
    refutation in place (``incarnation``, the rows' phase and dead round,
    ``n_refuted``, LHM), and the fire pass's inputs."""
    _, slot_phase, slot_start, slot_dead = t.slots
    il, sl_node, node_c, ncl = _rows(cfg, t)
    H = il.shape[0]
    dev = il.device
    sl_phase = slot_phase[il]
    refute = None
    if cfg.refute:
        # Each subject's own byte, on the shard that owns its column.
        own_msg = get_points(t.heard, torch.arange(H, device=dev),
                             node_c) >> _MSG_SHIFT
        refutable = (sl_phase == _SUSPECT) | (sl_phase == _DEAD)
        refute_now = (refutable & (sl_node >= 0) & t.alive[ncl]
                      & t.member[ncl]
                      & ((own_msg == MSG_SUSPECT) | (own_msg == MSG_DEAD)))
        bump = refute_now.to(_I32)
        # A row that does not refute adds 0 at its subject.
        t.incarnation.index_add_(0, ncl, bump)
        sl_phase = torch.where(refute_now, _REFUTED, sl_phase)
        slot_phase.index_put_((il,), sl_phase)
        slot_dead.index_put_((il,), torch.where(refute_now, t.rnd,
                                                slot_dead[il]))
        refute = (node_c, torch.where(refute_now, _REFUTE_BYTE, 0).to(_U8))
        t.stats[3].add_(bump.sum(dtype=_I32))
        if t.lhm is not None:
            # Lifeguard: the refuter's LHM rises, the bumped entries
            # clamped (the module docstring).
            bumps = torch.zeros_like(t.lhm).index_add_(0, ncl, bump)
            t.lhm.copy_(torch.where(bumps > 0, (t.lhm + bumps).clamp(
                max=cfg.lhm_max), t.lhm))
    # The timer mask: per row, bit c where elapsed >= tbl[min(c, cc)].
    tbl = torch.tensor(cfg.tbl, dtype=_I32, device=dev)
    cs = torch.arange(4, device=dev)
    cc = t.conf_cap[il].clamp(min=0)
    elapsed = t.rnd - slot_start[il]
    ok = elapsed[:, None] >= tbl[torch.minimum(cs[None, :],
                                               cc[:, None].long())]
    ok = ok & (sl_phase == _SUSPECT)[:, None]
    ok_mask = (ok.to(_U8) << cs.to(_U8)).sum(dim=1, dtype=_U8)
    return Decided(ok_mask, refute)


def finish_settle_ref(cfg: Config, t: Step,
                      fired: torch.Tensor) -> Settled:
    """The plain version of ``finish_settle``, on any device: the rows
    that fired take the dead verdict (their phase and dead round in place),
    the detection statistics (the first three counters, added), the GC
    decision."""
    _, slot_phase, slot_start, slot_dead = t.slots
    il, _, _, ncl = _rows(cfg, t)
    rnd = t.rnd
    sl_dead = slot_dead[il]
    new_dead = fired & (sl_dead < 0)
    sl_phase = torch.where(fired, _DEAD, slot_phase[il])
    sl_dead = torch.where(new_dead, rnd, sl_dead)
    slot_phase.index_put_((il,), sl_phase)
    slot_dead.index_put_((il,), sl_dead)

    # Detection stats are recorded at declaration time.
    fail_c = t.fail_round[ncl]
    truly_dead = fail_c <= rnd
    det = new_dead & truly_dead
    n_detected, sum_detect, n_false_dead, _ = t.stats
    n_detected.add_(det.sum(dtype=_I32))
    sum_detect.add_(torch.where(det, rnd - fail_c, 0).sum(dtype=_I32))
    n_false_dead.add_((new_dead & ~truly_dead).sum(dtype=_I32))

    # Episode GC: recycle slots whose verdict has disseminated (or whose
    # TTL ran out).
    verdict_done = ((((sl_phase == _DEAD) | (sl_phase == _REFUTED)
                      | (sl_phase == _JOIN)) & (sl_dead >= 0))
                    & (rnd - sl_dead > cfg.gc_rounds))
    expired = ((sl_phase > _FREE)
               & ((rnd - slot_start[il] > cfg.ttl) | verdict_done))
    dropped = expired & (sl_phase == _DEAD)
    marks = (det.to(_U8) * DETECTED) | (new_dead.to(_U8) * NEW_VERDICT) \
        | (dropped.to(_U8) * DROPPED)
    spread = verdict = None
    if t.hist is not None:
        spread = expired & (sl_dead >= 0)
        verdict = torch.where(sl_phase == _DEAD, MSG_DEAD,
                              MSG_REFUTE).to(_I32)
    return Settled(expired, marks, spread, verdict)


def finish_record_ref(cfg: Config, t: Step, dec: Decided, st: Settled,
                      n_hold: torch.Tensor | None = None) -> None:
    """The plain version of ``finish_record``, on any device, in place:
    the hist banks' adds (``n_hold``: the members holding each row's
    verdict, ``observe.count``'s hold row), the dead subjects' member
    flags, the expired slots' ``slot_of_node`` entries and registers."""
    N = cfg.N
    slot_node, slot_phase, slot_start, slot_dead = t.slots
    il, sl_node, node_c, ncl = _rows(cfg, t)
    rnd = t.rnd
    if t.hist is not None:
        refute_now = (torch.zeros_like(st.expired) if dec.refute is None
                      else dec.refute[1] != 0)
        det = (st.marks & DETECTED) != 0
        new_dead = (st.marks & NEW_VERDICT) != 0
        dwell = rnd - slot_start[il]
        # Integer log2 buckets via bit length.
        blen = ((n_hold[:, None] >> torch.arange(31, dtype=_I32,
                                                 device=il.device)) > 0).sum(
            dim=1, dtype=_I32)
        _hist_add(t.hist.detect, det, rnd - t.fail_round[ncl])
        _hist_add(t.hist.dwell, new_dead | refute_now, dwell)
        _hist_add(t.hist.refute, refute_now, dwell)
        _hist_add(t.hist.spread, st.spread, blen)
    dropped = (st.marks & DROPPED) != 0
    t.member.copy_(set_drop(t.member, torch.where(dropped, node_c, N),
                            False))
    expired = st.expired
    t.slot_of_node.copy_(set_drop(t.slot_of_node,
                                  torch.where(expired, node_c, N), -1))
    slot_node.index_put_((il,), torch.where(expired, -1, sl_node))
    slot_phase.index_put_((il,), torch.where(expired, _FREE, slot_phase[il]))
    slot_dead.index_put_((il,), torch.where(expired, -1, slot_dead[il]))


# -- the kernels -----------------------------------------------------------------

_VP, _CI = ctypes.c_void_p, ctypes.c_int
# Every entry point's arguments: the shard table, ndev, the pointer table,
# the integers and the stream.
_ARGTYPES = [ctypes.POINTER(_VP), _CI, ctypes.POINTER(_VP),
             ctypes.POINTER(_CI), _VP]
ENTRY_POINTS = ("finish_decide", "finish_settle", "finish_record")
_N_PTRS = 30  # kNumPtrs


@functools.lru_cache(maxsize=None)
def _lib():
    """The entry points of ``csrc/finish_slots.cu``, built and loaded, and
    the library's error-string function, all typed."""
    lib = _build.load("finish_slots")
    fns = tuple(getattr(lib, name) for name in ENTRY_POINTS)
    for fn in fns:
        fn.argtypes, fn.restype = _ARGTYPES, _CI
    lib.finish_slots_error.argtypes = [_CI]
    lib.finish_slots_error.restype = ctypes.c_char_p
    return fns, lib.finish_slots_error


def _checked(cfg: Config, t: Step):
    """The shards after the checks every entry point makes, and their
    device."""
    shards = _shards(t.heard)
    ndev = len(shards)
    if not 1 <= ndev <= MAX_SHARDS:
        raise ValueError(f"the finish step takes 1 to {MAX_SHARDS} shards, "
                         f"got {ndev}")
    require_cuda("the finish step", shards[0])
    dev = shards[0].device
    N, S = cfg.N, cfg.S
    H = t.idx.shape[0] if t.idx.dim() == 1 else -1
    if N % ndev or not 1 <= H <= S <= MAX_ROWS:
        raise ValueError(f"the finish step takes 1 <= H <= S <= {MAX_ROWS} "
                         f"and N divisible by the shards, got H={H}, "
                         f"S={S}, N={N}, ndev={ndev}")
    for i, h in enumerate(shards):
        check_tensor(f"shard {i}", h, _U8, (H, N // ndev), dev)
    if t.rnd.dtype != _I32 or t.rnd.numel() != 1 or t.rnd.device != dev:
        raise ValueError(f"rnd must be one int32 word on {dev}, got "
                         f"{t.rnd.dtype}{list(t.rnd.shape)} on "
                         f"{t.rnd.device}")
    check_tensor("idx", t.idx, _I32, (H,), dev)
    for i, x in enumerate(t.slots):
        check_tensor(f"slot register {i}", x, _I32, (S,), dev)
    check_tensor("conf_cap", t.conf_cap, _I32, (S,), dev)
    for name, x, dt in (("alive", t.alive, torch.bool),
                        ("member", t.member, torch.bool),
                        ("fail_round", t.fail_round, _I32),
                        ("slot_of_node", t.slot_of_node, _I32),
                        ("incarnation", t.incarnation, _I32)):
        check_tensor(name, x, dt, (N,), dev)
    for i, x in enumerate(t.stats):
        check_tensor(f"counter {i}", x, _I32, (), dev)
    if t.lhm is not None:
        check_tensor("lhm", t.lhm, _I32, (N,), dev)
    if t.hist is not None:
        for name, x in zip(t.hist._fields, t.hist):
            if x.dtype != _I32 or x.dim() != 1 or x.device != dev \
                    or not 1 <= x.shape[0] <= MAX_BUCKETS \
                    or not x.is_contiguous():
                raise ValueError(f"hist bank {name} must be a contiguous "
                                 f"int32 vector of 1 to {MAX_BUCKETS} "
                                 f"buckets on {dev}")
        if not (t.hist.detect.shape == t.hist.dwell.shape
                == t.hist.refute.shape):
            raise ValueError("the latency banks must have one length")
    return shards, dev, H


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def _launch(which: int, cfg: Config, t: Step, dec: Decided | None = None,
            st: Settled | None = None, fired=None, n_hold=None) -> None:
    """One launch of entry point ``ENTRY_POINTS[which]`` on the current
    stream; raises if it was refused."""
    global launches, decide_launches, settle_launches, record_launches
    shards, dev, H = _checked(cfg, t)
    for name, x, dt in (("fired", fired, torch.bool),
                        ("n_hold", n_hold, _I32)):
        if x is not None:
            check_tensor(name, x, dt, (H,), dev)
    fns, err = _lib()  # built at the first launch; a failed build raises
    refute = None if dec is None else dec.refute
    hist = t.hist
    ptrs = (_VP * _N_PTRS)(
        t.rnd.data_ptr(), t.idx.data_ptr(),
        *(x.data_ptr() for x in t.slots), t.conf_cap.data_ptr(),
        t.alive.data_ptr(), t.member.data_ptr(), t.fail_round.data_ptr(),
        t.slot_of_node.data_ptr(), t.incarnation.data_ptr(), _ptr(t.lhm),
        *(x.data_ptr() for x in t.stats),
        _ptr(None if dec is None else dec.ok_mask),
        *((None, None) if refute is None else (_ptr(refute[0]),
                                               _ptr(refute[1]))),
        _ptr(fired), *((None,) * 4 if st is None else (
            _ptr(st.expired), _ptr(st.marks), _ptr(st.spread),
            _ptr(st.verdict))), _ptr(n_hold),
        *((None,) * 4 if hist is None else (x.data_ptr() for x in hist)))
    lat = 1 if hist is None else hist.detect.shape[0]
    spread = 1 if hist is None else hist.spread.shape[0]
    ints = (_CI * 13)(cfg.N, H, cfg.S, int(cfg.refute), cfg.budget, cfg.ttl,
                      cfg.lhm_max, *cfg.tbl, lat, spread)
    table = (_VP * len(shards))(*(h.data_ptr() for h in shards))
    name = ENTRY_POINTS[which]
    _build.launch(fns[which], err, name, dev, table, len(shards), ptrs, ints)
    launches += 1
    if which == 0:
        decide_launches += 1
    elif which == 1:
        settle_launches += 1
    else:
        record_launches += 1
    launch_shapes.add((name, H, cfg.S, cfg.N, cfg.N // len(shards),
                       len(shards), (cfg.refute, t.lhm is not None,
                                     hist is not None)))


def finish_decide(cfg: Config, t: Step) -> Decided:
    """Launch ``finish_decide`` of ``csrc/finish_slots.cu``:
    ``finish_decide_ref`` in one block, as a programmatic dependent launch:
    it may start while the kernel before it on the stream runs, makes its
    loads but the own bytes, then waits for that kernel.  So that kernel
    must write none of ``t``'s tensors but the belief rows (in the round:
    the tail, or a push/pull round's last take); a caller whose kernel
    before may write them synchronises first.  Returns new outputs."""
    dev, H = t.idx.device, t.idx.shape[0]
    dec = Decided(torch.empty((H,), dtype=_U8, device=dev),
                  (torch.empty((H,), dtype=_I32, device=dev),
                   torch.empty((H,), dtype=_U8, device=dev))
                  if cfg.refute else None)
    _launch(0, cfg, t, dec)
    return dec


def finish_settle(cfg: Config, t: Step, fired: torch.Tensor) -> Settled:
    """Launch ``finish_settle``: ``finish_settle_ref`` in one block, as a
    programmatic dependent launch, as ``finish_decide`` is: it makes its
    loads but ``fired`` before it waits for the kernel before it on the
    stream, so that kernel must write none of ``t``'s tensors (in the
    round: the fire, ``finish.fire``, which writes ``fired`` and the belief
    rows, which settle does not read); a caller whose kernel before may
    write them synchronises first.  Returns new outputs (``torch.empty``:
    no kernel comes between the fire and settle)."""
    dev, H = t.idx.device, t.idx.shape[0]
    hist = t.hist is not None

    def out(dt):
        return torch.empty((H,), dtype=dt, device=dev)

    st = Settled(out(torch.bool), out(_U8), out(torch.bool) if hist
                 else None, out(_I32) if hist else None)
    _launch(1, cfg, t, st=st, fired=fired)
    return st


def finish_record(cfg: Config, t: Step, dec: Decided, st: Settled,
                  n_hold: torch.Tensor | None = None) -> None:
    """Launch ``finish_record``: ``finish_record_ref`` in one block, in
    place.  With ``n_hold`` (the hist banks) a programmatic dependent
    launch, as ``finish_decide`` is: it makes its loads but ``n_hold``
    before it waits for the kernel before it on the stream, so that kernel
    must write none of ``t``'s, ``dec``'s or ``st``'s tensors (in the
    round: the spread's count, ``observe.count``, which writes ``n_hold``);
    a caller whose kernel before may write them synchronises first.
    Without, a plain launch (in the round it follows ``settle``)."""
    if t.hist is not None and n_hold is None:
        raise ValueError("the hist banks' adds need n_hold")
    _launch(2, cfg, t, dec, st, n_hold=n_hold if t.hist is not None
            else None)


# -- the round's dispatchers ------------------------------------------------------

def _on_cpu(t: Step) -> bool:
    return _shards(t.heard)[0].device.type == "cpu"


def decide(cfg: Config, t: Step) -> Decided:
    """The decide step of the module docstring: the kernel on CUDA
    tensors, its plain version on CPU tensors."""
    if _on_cpu(t):
        return finish_decide_ref(cfg, t)
    return finish_decide(cfg, t)


def settle(cfg: Config, t: Step, fired: torch.Tensor) -> Settled:
    """The settle step, after the fire pass."""
    if _on_cpu(t):
        return finish_settle_ref(cfg, t, fired)
    return finish_settle(cfg, t, fired)


def record(cfg: Config, t: Step, dec: Decided, st: Settled,
           n_hold: torch.Tensor | None = None) -> None:
    """The record step, after the spread's count (``n_hold``, with the
    hist banks) and before the GC wipe."""
    if _on_cpu(t):
        finish_record_ref(cfg, t, dec, st, n_hold)
    else:
        finish_record(cfg, t, dec, st, n_hold)
