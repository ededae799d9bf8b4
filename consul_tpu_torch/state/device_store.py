"""Device-resident state store on the card: batched FSM apply and device
watch matching (port of ``consul_tpu/state/device_store.py``).

The host store stays authoritative.  The FSM applies each committed
entry to it first, capturing per-key ops and watch events
(``ApplyCapture``), then hands the whole batch to the bridge
(``DeviceStoreBridge.on_batch``), which

* ships the per-key ops to an open-addressed key-hash table on the card
  in one kernel launch (``kv_apply``, ``csrc/kv_store.cu``), with the
  result of applying them in batch order, and holds the card's per-op
  ``(existed, old_index)`` verdicts against the host's pre-state;
* evaluates the standing watch set against the batch's KV events in one
  kernel launch (``watch_match``), and holds the fired set against the
  host's radix walk;
* fires the union of both matches, host order first.

Any difference counts in ``divergence`` (and
``consul_store_divergence_total``); ``crossval`` drives the contract.
The bridge never catches its own failures: the FSM that holds it
(``consul_tpu/consensus/fsm.py::apply_batch``) degrades to its host
path when ``on_batch`` raises.

Semantics, hashing and layout are the reference's.  Keys and event
paths are hashed on the host in numpy by two independent FNV-1a-style
32-bit streams (the encoders below are the reference's, statement for
statement); a watch at ``w`` fires for a KV mutation at ``path`` iff
``path.startswith(w)``, compared on the card as the hash of ``path``'s
first ``len(w)`` bytes (rolling prefix-hash rows, one per event, columns
0..lmax) against ``w``'s own.  The delete-tree reverse direction, and
watches longer than ``lmax``, stay with the host walk.  Indexes live on
the card folded mod 2**32 and the watch gate compares them unsigned.

On the card every u32 field travels in an int32 tensor holding the same
bits: the table is int32 ``[capacity, 8]`` (state, fp1, fp2, modify,
create, digest, flags, a zero pad word: one 32-byte row per slot) plus
the int32 ``full`` count of sets that found no slot; an op batch is
int32 ``[B, 8]`` (opc, h1, h2, index, digest, flags, two zero words); a
watch set int32 ``[5, W]`` (kind, h1, h2, len, min index); an event
batch int32 ``[5, B]`` (kind, len, index, th1, th2) with its prefix
hashes int32 ``[2, B, lmax + 1]``.

``apply_ref`` and ``match_ref`` are the two device steps in plain torch,
on int64 values masked to 32 bits (torch's uint32 has no arithmetic on
the CPU), on any device: ``apply_ref`` is the reference's scan as a
Python loop over the ops, ``match_ref`` a loop over the events,
vectorised over the watches.  The wrappers ``kv_apply`` and
``watch_match`` launch the kernels on CUDA tensors and raise on anything
else; ``apply_batch`` and ``match`` take the plain versions only for CPU
tensors.
"""

from __future__ import annotations

import ctypes
import functools
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from consul_tpu_torch import _build
from consul_tpu_torch._device import (check_tensor, require_cuda,
                                      resolve_device)
from consul_tpu_torch.state.notify import (
    KIND_KEY, KIND_PREFIX, KIND_TABLE, StoreMutation, WatchPredicate,
    match_batch)

# Two independent FNV-1a-style 32-bit streams (second uses different
# offset basis and prime, gossip/ops/feistel.py keeps the same style of
# fixed odd multipliers).
_FNV1_BASIS = np.uint32(2166136261)
_FNV1_PRIME = np.uint32(16777619)
_FNV2_BASIS = np.uint32(0x811C9DC5 ^ 0x5BD1E995)
_FNV2_PRIME = np.uint32(0x01000193 ^ 0x00010146)  # odd → invertible mod 2^32

# Table slot states.
SLOT_EMPTY = 0
SLOT_LIVE = 1
SLOT_TOMB = 2

# Op codes in the batched-apply stream (pad rows are OP_PAD).
OP_SET = 0
OP_DEL = 1
OP_PAD = -1

# Event kinds in the watch-match stream.
EV_KV = 0
EV_TABLE = 1
EV_PAD = -1


def _pow2(n: int, floor: int = 1) -> int:
    p = floor
    while p < n:
        p <<= 1
    return p


def _encode_keys(keys: Sequence[bytes], lmax: int) -> np.ndarray:
    """[N, lmax] uint32 byte matrix, zero-padded."""
    mat = np.zeros((len(keys), lmax), dtype=np.uint32)
    for i, kb in enumerate(keys):
        kb = kb[:lmax]
        if kb:
            mat[i, : len(kb)] = np.frombuffer(kb, dtype=np.uint8)
    return mat


def _full_hashes(keys: Sequence[bytes], lmax: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(h1, h2, byte_len) of each key's first min(len, lmax) bytes —
    vectorized across keys: O(lmax) numpy passes however many keys."""
    lens = np.array([min(len(k), lmax) for k in keys], dtype=np.int32)
    mat = _encode_keys(keys, lmax)
    h1 = np.full(len(keys), _FNV1_BASIS, dtype=np.uint32)
    h2 = np.full(len(keys), _FNV2_BASIS, dtype=np.uint32)
    for j in range(int(lens.max()) if len(keys) else 0):
        act = j < lens
        h1 = np.where(act, (h1 ^ mat[:, j]) * _FNV1_PRIME, h1)
        h2 = np.where(act, (h2 ^ mat[:, j]) * _FNV2_PRIME, h2)
    return h1, h2, lens


def _prefix_hashes(paths: Sequence[bytes], lmax: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rolling prefix hashes: [N, lmax+1] rows where column ``l`` is the
    hash of the path's first ``l`` bytes (frozen once l exceeds the
    path length — guarded by the length compare at match time)."""
    n = len(paths)
    lens = np.array([min(len(p), lmax) for p in paths], dtype=np.int32)
    mat = _encode_keys(paths, lmax)
    hp1 = np.empty((n, lmax + 1), dtype=np.uint32)
    hp2 = np.empty((n, lmax + 1), dtype=np.uint32)
    h1 = np.full(n, _FNV1_BASIS, dtype=np.uint32)
    h2 = np.full(n, _FNV2_BASIS, dtype=np.uint32)
    hp1[:, 0] = h1
    hp2[:, 0] = h2
    for j in range(lmax):
        act = j < lens
        h1 = np.where(act, (h1 ^ mat[:, j]) * _FNV1_PRIME, h1)
        h2 = np.where(act, (h2 ^ mat[:, j]) * _FNV2_PRIME, h2)
        hp1[:, j + 1] = h1
        hp2[:, j + 1] = h2
    return hp1, hp2, lens


def _digest(value: bytes) -> int:
    """uint32 value digest — crc32 (C-speed, stdlib)."""
    return zlib.crc32(value) & 0xFFFFFFFF



_M32 = 0xFFFFFFFF

# Table and op-row layout on the card (module docstring).
SLOT_COLS = 8
OP_COLS = 8
# Watch-set and event rows.
W_ROWS = 5
EV_ROWS = 5
# The apply kernel's probe window is one warp's lanes.
MAX_PROBE = 32


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits as int64 values in [0, 2**32)."""
    return t.to(torch.int64) & _M32


def _as_i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) back to int32 with the same bits."""
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def _pack_rows(*arrays: np.ndarray) -> np.ndarray:
    """int32/uint32 vectors stacked as int32 rows with the same bits."""
    return np.stack([np.asarray(a).astype(np.uint32, copy=False)
                     .view(np.int32) for a in arrays])


def _pack_ops(opc: np.ndarray, h1: np.ndarray, h2: np.ndarray,
              index: np.ndarray, dig: np.ndarray,
              flg: np.ndarray) -> np.ndarray:
    """The reference's op arrays (opc int32, the rest uint32) as the
    card's int32 ``[B, OP_COLS]`` rows."""
    rows = np.zeros((len(opc), OP_COLS), dtype=np.int32)
    rows[:, :6] = _pack_rows(opc, h1, h2, index, dig, flg).T
    return rows


# -- the plain versions -------------------------------------------------------

def apply_ref(tab: Tuple[torch.Tensor, torch.Tensor], ops: torch.Tensor,
              probe: int):
    """The reference's ``_build_apply`` scan in plain torch, on any device:
    ``tab`` = (int32 ``[C, SLOT_COLS]`` slots, int32 0-dim ``full``),
    ``ops`` int32 ``[B, OP_COLS]``.  Returns ``((slots, full), (existed,
    old_index))``: a new table (the input is not changed), ``existed``
    bool ``[B]`` and ``old_index`` int32 ``[B]`` (u32 bits), pad rows
    included.

    One step per op, in order, as the reference's ``step``: the op's
    fields are host ints (one read of the batch), the table's window and
    every decision from it stay tensors."""
    slots, full = tab
    dev = slots.device
    cap_mask = slots.shape[0] - 1
    t = _u32(slots)
    full = _u32(full)
    probe_off = torch.arange(probe, dtype=torch.int64, device=dev)
    existed_out, old_out = [], []
    for opc, h1, h2, index, dig, flg, _, _ in ops.tolist():
        h1, h2, index, dig, flg = (v & _M32 for v in (h1, h2, index, dig,
                                                      flg))
        idx = (probe_off + h1) & cap_mask
        win = t[idx]
        st = win[:, 0]
        match = (st != SLOT_EMPTY) & (win[:, 1] == h1) & (win[:, 2] == h2)
        any_match = match.any()
        # torch.argmax, like jnp.argmax, takes the first maximum: 0 for an
        # all-false mask.
        first_match = match.to(torch.int32).argmax()
        empty = st == SLOT_EMPTY
        window_ok = any_match | empty.any()
        slot = idx[torch.where(any_match, first_match,
                               empty.to(torch.int32).argmax())]
        existed = any_match & (st[first_match] == SLOT_LIVE)
        existed_out.append(existed)
        old_out.append(torch.where(existed, win[first_match, 3], 0))
        if opc not in (OP_SET, OP_DEL):
            continue  # a pad row writes nothing
        cur = t[slot]
        if opc == OP_SET:
            # A live key keeps its create index; an empty or tombstoned
            # slot is created at this index.
            new = torch.tensor([SLOT_LIVE, h1, h2, index, index, dig, flg, 0],
                               dtype=torch.int64, device=dev)
            new[4] = torch.where(existed, cur[4], index)
            write = window_ok
            full = (full + (~window_ok).to(torch.int64)) & _M32
        else:
            # A delete tombstones a live key: digest 0, create and flags
            # kept.
            new = torch.tensor([SLOT_TOMB, h1, h2, index, 0, 0, 0, 0],
                               dtype=torch.int64, device=dev)
            new[4], new[6] = cur[4], cur[6]
            write = existed
        new[7] = cur[7]
        t[slot] = torch.where(write, new, cur)
    if not existed_out:
        return ((_as_i32(t), _as_i32(full)),
                (torch.zeros(0, dtype=torch.bool, device=dev),
                 torch.zeros(0, dtype=torch.int32, device=dev)))
    return ((_as_i32(t), _as_i32(full)),
            (torch.stack(existed_out), _as_i32(torch.stack(old_out))))


def match_ref(watches: torch.Tensor, events: torch.Tensor, hp: torch.Tensor,
              lmax: int):
    """The reference's ``_build_match`` in plain torch, on any device: a
    loop over the events, vectorised over the watches.  ``watches`` int32
    ``[W_ROWS, W]`` (W a multiple of 32), ``events`` int32 ``[EV_ROWS,
    B]``, ``hp`` int32 ``[2, B, lmax + 1]``.  Returns ``fired`` bool
    ``[W]`` and ``packed`` int32 ``[W // 32]`` (bit i of word k is watch
    32 k + i)."""
    w_kind = watches[0].to(torch.int64)
    w_len = watches[3].to(torch.int64)
    w_h1, w_h2, w_min = (_u32(watches[r]) for r in (1, 2, 4))
    kind = events[0].to(torch.int64)
    e_len = events[1].to(torch.int64)
    e_index, th1, th2 = (_u32(events[r]) for r in (2, 3, 4))
    hp1, hp2 = _u32(hp[0]), _u32(hp[1])
    at = torch.clamp(w_len, 0, lmax)
    fired = torch.zeros(w_kind.shape, dtype=torch.bool, device=w_kind.device)
    for e in range(events.shape[1]):
        kv = kind[e] == EV_KV
        cond_kv = (kv & (w_kind != KIND_TABLE) & (w_len <= e_len[e])
                   & (hp1[e][at] == w_h1) & (hp2[e][at] == w_h2))
        cond_tab = ((kind[e] == EV_TABLE) & (w_kind == KIND_TABLE)
                    & (th1[e] == w_h1) & (th2[e] == w_h2))
        # uint32 index gate (values held unsigned in int64).
        gate = (w_kind >= 0) & (e_index[e] > w_min)
        fired = fired | ((cond_kv | cond_tab) & gate)
    bits = fired.reshape(-1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    packed = (bits << shifts).sum(dim=1)
    return fired, _as_i32(packed)


# -- the kernels ------------------------------------------------------------

# Kernel launches made by ``kv_apply`` and by ``watch_match`` (one per
# launch, nowhere else).
apply_launches = 0
match_launches = 0
# ("kv_apply", capacity, probe, B) and ("watch_match", W, B, lmax) of
# every launch, so a smoke run can hold each shape its paths launched at
# against the plain version (``chip_smoke.py``).
launch_shapes: set = set()

_VP, _CI = ctypes.c_void_p, ctypes.c_int

_ARGTYPES = {  # C entry point -> its argument types (pointers, ints, stream)
    "kv_apply": [_VP, _VP, _VP, _CI, _CI, _CI, _VP, _VP, _VP, _VP],
    "watch_match": [_VP, _CI, _VP, _VP, _CI, _CI, _VP, _VP, _VP, _VP],
}


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The entry point ``<name>`` of ``csrc/kv_store.cu``, built and
    loaded, and the library's error-string function, both typed."""
    lib = _build.load("kv_store")
    fn, err = getattr(lib, name), lib.kv_store_error
    fn.argtypes, fn.restype = _ARGTYPES[name], _CI
    err.argtypes, err.restype = [_CI], ctypes.c_char_p
    return fn, err


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call ``<name>`` on the current stream of ``dev``; raise if the
    launch was refused."""
    _build.launch(*_lib(name), name, dev, *args)


def kv_apply(tab: Tuple[torch.Tensor, torch.Tensor], ops: torch.Tensor,
             probe: int):
    """Launch ``kv_apply`` of ``csrc/kv_store.cu`` on CUDA tensors (the
    arguments of ``apply_ref``; capacity a power of two >= probe, 1 <=
    probe <= 32): applies the batch to ``tab`` in place and returns
    ``(existed, old_index)``.  Launches on the current stream and does not
    synchronise.  Raises on anything the kernel does not take."""
    return _kv_apply(tab, ops, probe, None)


def kv_apply_schedule(tab: Tuple[torch.Tensor, torch.Tensor],
                      ops: torch.Tensor, probe: int):
    """``kv_apply`` (in place) that also reads back how the kernel ran the
    batch: returns ``((existed, old_index), stats)``, ``stats`` with
    ``levels`` (the most levels a block ran: the batch's dependency
    depth), ``walked_ops`` (ops walked in order), ``walked_blocks``,
    ``blocks`` (the blocks that held ops) and the blocks' first-thread
    clock cycles summed by phase: ``bucket_cycles`` (buckets and cuts),
    ``list_cycles`` (the block's ops and run heads), ``level_cycles`` (the
    heads' levels), ``run_cycles`` (the levels, or the walk).
    Synchronises."""
    stats = torch.zeros(8, dtype=torch.int32, device=tab[0].device)
    out = _kv_apply(tab, ops, probe, stats)
    return out, dict(zip(("levels", "walked_ops", "walked_blocks", "blocks",
                          "bucket_cycles", "list_cycles", "level_cycles",
                          "run_cycles"), stats.tolist()))


def _kv_apply(tab, ops, probe, stats):
    global apply_launches
    slots, full = tab
    require_cuda("kv_apply", slots)
    dev = slots.device
    C = slots.shape[0] if slots.dim() == 2 else 0
    check_tensor("slots", slots, torch.int32, (C, SLOT_COLS), dev)
    check_tensor("full", full, torch.int32, (), dev)
    probe = int(probe)
    if not 1 <= probe <= MAX_PROBE:
        raise ValueError(f"probe must be in [1, {MAX_PROBE}], got {probe}")
    if C < probe or C & (C - 1):
        raise ValueError(f"capacity must be a power of two >= probe, "
                         f"got {C}")
    B = ops.shape[0] if ops.dim() == 2 else -1
    check_tensor("ops", ops, torch.int32, (B, OP_COLS), dev)
    existed = torch.empty(B, dtype=torch.bool, device=dev)
    old_index = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return existed, old_index
    _launch("kv_apply", dev, slots.data_ptr(), full.data_ptr(),
            ops.data_ptr(), B, C, probe, existed.data_ptr(),
            old_index.data_ptr(), None if stats is None else stats.data_ptr())
    apply_launches += 1
    launch_shapes.add(("kv_apply", C, probe, B))
    return existed, old_index


def watch_match(watches: torch.Tensor, events: torch.Tensor,
                hp: torch.Tensor, lmax: int):
    """Launch ``watch_match`` of ``csrc/kv_store.cu`` on CUDA tensors (the
    arguments of ``match_ref``; W a power of two >= 32); returns
    ``(fired, packed)``.  Launches on the current stream and does not
    synchronise.  Raises on anything the kernel does not take."""
    return _watch_match(watches, events, hp, lmax, None)


def watch_match_stats(watches: torch.Tensor, events: torch.Tensor,
                      hp: torch.Tensor, lmax: int) -> Dict[str, int]:
    """``watch_match`` (one launch) that also reads back the (watch,
    event) ``pairs`` the kernel evaluated, and the clock cycles the first
    thread of each block spent ``staging`` event chunks into shared memory
    and ``matching`` them, summed over the blocks.  Synchronises."""
    stats = torch.zeros(3, dtype=torch.int64, device=watches.device)
    _watch_match(watches, events, hp, lmax, stats)
    return dict(zip(("pairs", "staging_cycles", "matching_cycles"),
                    stats.tolist()))


def _watch_match(watches, events, hp, lmax, stats):
    global match_launches
    require_cuda("watch_match", watches)
    dev = watches.device
    W = watches.shape[1] if watches.dim() == 2 else 0
    check_tensor("watches", watches, torch.int32, (W_ROWS, W), dev)
    if W < 32 or W & (W - 1):
        raise ValueError(f"the watch count must be a power of two >= 32, "
                         f"got {W}")
    lmax = int(lmax)
    if lmax < 0:
        raise ValueError(f"lmax must be >= 0, got {lmax}")
    B = events.shape[1] if events.dim() == 2 else -1
    check_tensor("events", events, torch.int32, (EV_ROWS, B), dev)
    check_tensor("hp", hp, torch.int32, (2, B, lmax + 1), dev)
    fired = torch.empty(W, dtype=torch.bool, device=dev)
    packed = torch.empty(W // 32, dtype=torch.int32, device=dev)
    _launch("watch_match", dev, watches.data_ptr(), W, events.data_ptr(),
            hp.data_ptr(), B, lmax, fired.data_ptr(), packed.data_ptr(),
            None if stats is None else stats.data_ptr())
    match_launches += 1
    launch_shapes.add(("watch_match", W, B, lmax))
    return fired, packed


def apply_batch(tab, ops: torch.Tensor, probe: int):
    """One op batch on the table: the kernel (in place) on CUDA tensors,
    the plain version on CPU tensors.  Returns ``(tab, (existed,
    old_index))``, ``tab`` the table to keep."""
    if tab[0].device.type == "cpu":
        return apply_ref(tab, ops, probe)
    return tab, kv_apply(tab, ops, probe)


def match(watches: torch.Tensor, events: torch.Tensor, hp: torch.Tensor,
          lmax: int):
    """The watch matcher: the kernel on CUDA tensors, the plain version on
    CPU tensors.  Returns ``(fired, packed)``."""
    if watches.device.type == "cpu":
        return match_ref(watches, events, hp, lmax)
    return watch_match(watches, events, hp, lmax)


# -- the table ----------------------------------------------------------------

class DeviceKVTable:
    """Fixed-capacity open-addressed hash table in device memory (the
    reference's ``DeviceKVTable``): per slot its state (empty / live /
    tombstone), two u32 key fingerprints, modify / create indexes (mod
    2**32), crc32 value digest and flags, in one int32 ``[capacity,
    SLOT_COLS]`` tensor, plus the count of sets that found no slot.  A
    static ``probe``-slot linear window per op; a tombstone keeps its
    fingerprints so a re-set of the key reuses its slot."""

    def __init__(self, capacity: int = 1 << 16, probe: int = 16,
                 device=None) -> None:
        self.device = resolve_device(device)
        self.capacity = _pow2(max(int(capacity), probe))
        self.probe = int(probe)
        self.reset()

    def reset(self) -> None:
        self.tab = (torch.zeros((self.capacity, SLOT_COLS), dtype=torch.int32,
                                device=self.device),
                    torch.zeros((), dtype=torch.int32, device=self.device))

    def apply(self, ops: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Apply one padded op batch (int32 ``[B, OP_COLS]`` on the
        table's device); returns host ``existed`` (bool) and ``old_index``
        (uint32) arrays, pad rows included (callers slice)."""
        self.tab, (existed, old_index) = apply_batch(self.tab, ops,
                                                     self.probe)
        return (existed.cpu().numpy(),
                old_index.cpu().numpy().view(np.uint32))

    def occupancy(self) -> Tuple[int, int, int]:
        """(live, tombstone, degraded sets), in one read from the
        device."""
        st, full = self.tab[0][:, 0], self.tab[1]
        live, tomb, full = torch.stack(
            [(st == SLOT_LIVE).sum(), (st == SLOT_TOMB).sum(),
             _u32(full)]).tolist()
        return int(live), int(tomb), int(full)


# Auto-gate floor for the device watch matcher on the CPU, where it runs
# the plain version (a loop of torch ops over the events): the host radix
# walk, which runs anyway as the authoritative side, is taken below it.
# On the card the matcher is taken unconditionally.  A verdict of the
# port's tuner (obs/tuner.py "watch_device_min") replaces this fallback.
WATCH_DEVICE_MIN_CPU = 1 << 16

# Knobs this module resolves through the autotune verdict.
TUNED_FIELDS = ("watch_device_min",)


class DeviceStoreBridge:
    """Glue between the host store / FSM and the card's twin (the
    reference's ``DeviceStoreBridge``, with ``device=``).

    ``on_batch(cap, store)`` is called by the FSM once per committed
    batch with the store's ``ApplyCapture``: it ships the per-key ops as
    one ``kv_apply`` launch per ``max_batch`` chunk, runs the watch
    matcher over the batch's events, holds both against the host's
    verdicts, fires the NotifyGroups (host and device union) and feeds
    ``render_hook``.  The host store is taken duck-typed, as the FSM
    hands it over: ``cap.kv_ops``, ``cap.notifies``, ``store._kv_watch``
    (a ``KVWatchSet``), ``store._watch`` (table name -> group) and
    ``store._kv.items(prefix)``.  Nothing of the host store is imported.

    Latency is bracketed as in the reference (wall time around the
    launch including the read of its verdicts) and recorded per dispatch
    class in ``obs/storestats.py``.
    """

    def __init__(self, capacity: int = 1 << 16, probe: int = 16,
                 lmax: int = 64, max_batch: int = 4096,
                 stats: Optional[object] = None,
                 match_backend: str = "auto", device=None) -> None:
        if match_backend not in ("auto", "device", "host"):
            raise ValueError(
                f"match_backend must be auto|device|host, got "
                f"{match_backend!r}")
        self.table = DeviceKVTable(capacity, probe, device=device)
        self.device = self.table.device
        self.capacity = self.table.capacity
        self.lmax = int(lmax)
        self.max_batch = int(max_batch)
        self.match_backend = match_backend
        self._platform = self.device.type
        # CPU break-even for the "auto" matcher: a verdict of the port's
        # tuner when one exists, else the constant above.  Off the CPU the
        # matcher is taken unconditionally and there is nothing to resolve.
        self._min_cpu = None
        if self._platform == "cpu":
            from consul_tpu_torch.obs import tuner
            self._min_cpu = int(tuner.resolved_value(
                "watch_device_min", default=WATCH_DEVICE_MIN_CPU,
                platform="cpu", device_count=1))
        if stats is None:
            from consul_tpu_torch.obs import storestats
            stats = storestats.StoreStats() if storestats.enabled() else None
        self.stats = stats
        # Rebuilt lazily from KVWatchSet when its version moves.
        self._w_version = -1
        self._w_arrays: Optional[torch.Tensor] = None
        self._w_groups: List[Tuple[str, object]] = []
        self._w_fallback: List[Tuple[str, object]] = []  # len > lmax
        self.divergence = 0
        self.render_hook = None  # set by the server: fired keys -> cache

    def _match(self, watches: torch.Tensor, events: Tuple[torch.Tensor,
                                                          torch.Tensor]):
        return match(watches, *events, self.lmax)

    def _to_device(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(rows).to(self.device)

    # -- watch-set encoding -------------------------------------------

    def _encode_watches(self, watchset) -> None:
        reg = watchset.registered()
        self._w_groups = [(p, g) for p, g in reg
                          if len(p.encode("utf-8")) <= self.lmax]
        self._w_fallback = [(p, g) for p, g in reg
                            if len(p.encode("utf-8")) > self.lmax]
        w = len(self._w_groups)
        wp = _pow2(max(w, 1), floor=32)
        kind = np.full(wp, -1, dtype=np.int32)
        kind[:w] = KIND_PREFIX
        keys = [p.encode("utf-8") for p, _ in self._w_groups]
        h1 = np.zeros(wp, dtype=np.uint32)
        h2 = np.zeros(wp, dtype=np.uint32)
        ln = np.zeros(wp, dtype=np.int32)
        if w:
            h1[:w], h2[:w], ln[:w] = _full_hashes(keys, self.lmax)
        wmin = np.zeros(wp, dtype=np.uint32)  # plumbing registers min=0
        self._w_arrays = self._to_device(_pack_rows(kind, h1, h2, ln, wmin))
        self._w_version = watchset.version
        if self.stats is not None:
            self.stats.watch_registered = len(reg)

    def encode_predicates(self, preds: Sequence[WatchPredicate]
                          ) -> torch.Tensor:
        """Encode explicit predicates (crossval / smoke path: KIND_TABLE
        and min_index, which the NotifyGroup plumbing never sets) as the
        int32 ``[W_ROWS, W]`` watch set."""
        w = len(preds)
        wp = _pow2(max(w, 1), floor=32)
        kind = np.full(wp, -1, dtype=np.int32)
        h1 = np.zeros(wp, dtype=np.uint32)
        h2 = np.zeros(wp, dtype=np.uint32)
        ln = np.zeros(wp, dtype=np.int32)
        wmin = np.zeros(wp, dtype=np.uint32)
        if w:
            keys = [p.value.encode("utf-8") for p in preds]
            h1[:w], h2[:w], ln[:w] = _full_hashes(keys, self.lmax)
            kind[:w] = [p.kind for p in preds]
            wmin[:w] = [p.min_index & 0xFFFFFFFF for p in preds]
            ln[:w] = np.where(np.array([p.kind for p in preds]) == KIND_TABLE,
                              0, ln[:w])
        return self._to_device(_pack_rows(kind, h1, h2, ln, wmin))

    def _encode_events(self, notifies: Sequence[tuple]
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pack capture notify events into padded device rows: int32
        ``[EV_ROWS, B]`` and the prefix hashes ``[2, B, lmax + 1]``."""
        b = len(notifies)
        bp = _pow2(max(b, 1))
        kind = np.full(bp, EV_PAD, dtype=np.int32)
        e_len = np.zeros(bp, dtype=np.int32)
        e_index = np.zeros(bp, dtype=np.uint32)
        th1 = np.zeros(bp, dtype=np.uint32)
        th2 = np.zeros(bp, dtype=np.uint32)
        kv_paths: List[bytes] = []
        for i, ev in enumerate(notifies):
            if ev[0] == "kv":
                kind[i] = EV_KV
                kv_paths.append(ev[1].encode("utf-8"))
                e_index[i] = ev[3] & 0xFFFFFFFF
            else:
                kind[i] = EV_TABLE
                kv_paths.append(b"")
                e_index[i] = ev[2] & 0xFFFFFFFF
        hp1, hp2, lens = _prefix_hashes(kv_paths, self.lmax)
        hp = np.zeros((2, bp, self.lmax + 1), dtype=np.uint32)
        hp[0, :b], hp[1, :b] = hp1, hp2
        for i, ev in enumerate(notifies):
            if ev[0] == "kv":
                # True byte length (uncapped) so w_len <= e_len is exact
                # for long paths; hashes only cover the first lmax bytes.
                e_len[i] = len(ev[1].encode("utf-8"))
            else:
                t1, t2, _ = _full_hashes([ev[1].encode("utf-8")], self.lmax)
                th1[i], th2[i] = t1[0], t2[0]
        return (self._to_device(_pack_rows(kind, e_len, e_index, th1, th2)),
                self._to_device(hp.view(np.int32)))

    # -- op-stream encoding -------------------------------------------

    def _encode_ops(self, kv_ops: Sequence[tuple]) -> Tuple[torch.Tensor,
                                                            int]:
        b = len(kv_ops)
        bp = _pow2(max(b, 1))  # callers chunk to max_batch first
        opc = np.full(bp, OP_PAD, dtype=np.int32)
        index = np.zeros(bp, dtype=np.uint32)
        dig = np.zeros(bp, dtype=np.uint32)
        flg = np.zeros(bp, dtype=np.uint32)
        keys = []
        for i, op in enumerate(kv_ops):
            keys.append(op[1].encode("utf-8"))
            index[i] = op[2] & 0xFFFFFFFF
            if op[0] == "set":
                opc[i] = OP_SET
                dig[i] = _digest(op[6])
                flg[i] = op[5] & 0xFFFFFFFF
            else:
                opc[i] = OP_DEL
        h1 = np.zeros(bp, dtype=np.uint32)
        h2 = np.zeros(bp, dtype=np.uint32)
        if b:
            # Full-key hashing beyond lmax for table fingerprints: hash
            # the whole key (table identity must distinguish keys that
            # share their first lmax bytes).
            h1[:b], h2[:b], _ = _full_hashes(keys, max(
                self.lmax, max(len(k) for k in keys)))
        return self._to_device(_pack_ops(opc, h1, h2, index, dig, flg)), b

    # -- the per-batch entry point ------------------------------------

    def on_batch(self, cap, store) -> None:
        """One committed batch: card apply + card watch match, host
        cross-check, union-fire, cache render."""
        t0 = time.monotonic()
        n_ops = len(cap.kv_ops)
        if n_ops:
            chunks = [cap.kv_ops[i:i + self.max_batch]
                      for i in range(0, n_ops, self.max_batch)]
            for chunk in chunks:
                ops, _b = self._encode_ops(chunk)
                existed, old_index = self.table.apply(ops)
                for i, op in enumerate(chunk):
                    # set: ("set", key, index, old_index, existed, ...);
                    # del: ("del", key, index, old_index) — only ever
                    # recorded for keys that existed (store pops first).
                    h_existed = op[4] if op[0] == "set" else True
                    h_old = (op[3] & 0xFFFFFFFF) if h_existed else 0
                    if (bool(existed[i]) != bool(h_existed)
                            or int(old_index[i]) != h_old):
                        self.divergence += 1
            if self.stats is not None:
                ms = (time.monotonic() - t0) * 1e3
                self.stats.note_apply(ms, n_ops)

        self._fire_watches(cap, store)
        if self.render_hook is not None:
            keys = [op[1] for op in cap.kv_ops]
            if keys:
                self.render_hook(keys)
        cap.consumed = True

    def _use_device_match(self) -> bool:
        """The watch-matching backend decision (``match_backend``).

        "auto" takes the device matcher off the CPU, and on the CPU once
        the standing-watch population reaches the ``watch_device_min``
        floor (a tuner verdict, else WATCH_DEVICE_MIN_CPU).  Below it the
        host radix walk, which runs anyway as the authoritative side, is
        cheaper and the device leg is skipped."""
        if self.match_backend != "auto":
            return self.match_backend == "device"
        if self._platform != "cpu":
            return True
        return len(self._w_groups) >= self._min_cpu

    def _fire_watches(self, cap, store) -> None:
        """Device bitmask ∪ host walk → NotifyGroup firing + prune."""
        watchset = store._kv_watch
        if watchset.version != self._w_version:
            self._encode_watches(watchset)
        use_device = self._use_device_match()
        if self.stats is not None:
            self.stats.match_backend_device = use_device

        # Host-authoritative match set (ordered as the sequential path
        # would have fired), incl. the delete-tree reverse direction and
        # any over-lmax fallback watches the device can't encode.
        host_fired: List[Tuple[str, object]] = []
        seen: Set[int] = set()
        for ev in cap.notifies:
            if ev[0] != "kv":
                continue
            for p, g in watchset.matched(ev[1], ev[2]):
                if id(g) not in seen:
                    seen.add(id(g))
                    host_fired.append((p, g))

        kv_events = [ev for ev in cap.notifies if ev[0] == "kv"]
        device_fired: List[Tuple[str, object]] = []
        host_keys = {id(g) for p, g in host_fired}
        if kv_events and self._w_groups and use_device:
            t0 = time.monotonic()
            events = self._encode_events(kv_events)
            fired, _packed = self._match(self._w_arrays, events)
            fired = fired[: len(self._w_groups)].cpu().numpy()
            device_fired = [self._w_groups[i]
                            for i in np.nonzero(fired)[0]]
            if self.stats is not None:
                ms = (time.monotonic() - t0) * 1e3
                self.stats.note_match(ms, len(kv_events),
                                      int(fired.sum()))

            # The device must agree with the host walk on every watch it
            # encodes, except the delete-tree reverse direction, which is
            # host-only by design (module docstring).
            dev_keys = {id(g) for p, g in device_fired}
            encoded = {id(g) for _, g in self._w_groups}
            expect_dev = set()
            for p, g in host_fired:
                if id(g) not in encoded:
                    continue  # over-lmax fallback watch, host-only
                if any(ev[1].startswith(p) for ev in kv_events):
                    # The forward (path startswith watch) direction is
                    # the device's; reverse-only tree matches are
                    # host-only.
                    expect_dev.add(id(g))
            missing = {k for k in expect_dev if k not in dev_keys}
            spurious = dev_keys - host_keys
            if missing or spurious:
                self.divergence += len(missing) + len(spurious)
        if self.stats is not None:
            self.stats.divergence = self.divergence

        # Fire the union: host order first (authoritative), then any
        # device-only extras (spurious-wake-safe).
        union = host_fired + [(p, g) for p, g in device_fired
                              if id(g) not in host_keys]
        watchset.notify_groups(union)  # prune bumps version → re-encode

        # Table notify events stay host-fired (one standing group per
        # table, never pruned — nothing for the device to win there).
        for ev in cap.notifies:
            if ev[0] == "table":
                store._watch[ev[1]].notify()

    # -- lifecycle ----------------------------------------------------

    def rebuild_from_store(self, store) -> None:
        """Reset + re-apply every live host row (snapshot restore path —
        the FSM's restore builds a fresh store, the device twin follows)."""
        self.table.reset()
        rows: List[tuple] = []
        for _, ent in store._kv.items(""):
            if ent.create_index != ent.modify_index:
                # Two-step so the device's create_index lands on the
                # host's: first set creates at create_index, second set
                # (existed) keeps it and moves modify_index.
                rows.append(("set", ent.key, ent.create_index, 0, False,
                             ent.flags, b""))
                rows.append(("set", ent.key, ent.modify_index,
                             ent.create_index, True, ent.flags, ent.value))
            else:
                rows.append(("set", ent.key, ent.modify_index, 0, False,
                             ent.flags, ent.value))
        for i in range(0, len(rows), self.max_batch):
            ops, _ = self._encode_ops(rows[i:i + self.max_batch])
            self.table.apply(ops)
        self._w_version = -1

    def occupancy(self) -> Tuple[int, int, int]:
        return self.table.occupancy()


# ---------------------------------------------------------------------
# Crossval oracle (the contract): randomized apply/watch workloads
# through device AND host, asserting identical verdicts and fired sets.
# ---------------------------------------------------------------------

def _random_key(rng, prefixes: Sequence[str], long_tail: bool) -> str:
    p = prefixes[rng.randrange(len(prefixes))]
    leaf = f"{rng.randrange(64):x}"
    if long_tail and rng.random() < 0.05:
        leaf += "x" * 80  # push past lmax to exercise the fallback list
    return f"{p}{leaf}"


def crossval(n_batches: int = 20, batch: int = 32, n_watches: int = 200,
             capacity: int = 1 << 12, seed: int = 0, lmax: int = 64, *,
             store_factory: Callable[[], Any],
             entry_factory: Callable[..., Any],
             device=None) -> Dict[str, Any]:
    """Drive randomized batches through a host store and the bridge (the
    reference's ``crossval``, statement for statement).

    The host store and its entries come from the caller
    (``store_factory()`` a store with ``capture_apply``, ``watch_kv``,
    ``kvs_set`` / ``kvs_check_and_set`` / ``kvs_delete`` /
    ``kvs_delete_tree``; ``entry_factory(key=, value=, flags=,
    modify_index=)`` a KV entry): the port imports no host store.
    Asserts (1) zero verdict/fired divergence via the bridge's own
    continuous cross-check, (2) the device fired set equals the pure
    ``match_batch`` oracle on explicit predicates (exact/prefix/table
    kinds incl. min_index gates), (3) blocking-style waiters wake
    identically.  Returns the reference's summary dict.
    """
    import random

    rng = random.Random(seed)
    store = store_factory()
    # match_backend forced: the lockstep oracle exists to exercise the
    # device matcher, so the CPU auto-gate must not silently skip it.
    bridge = DeviceStoreBridge(capacity=capacity, lmax=lmax, stats=None,
                               match_backend="device", device=device)
    prefixes = ["web/", "web/a/", "db/", "db/shard/", "cfg/", ""]

    class Flag:
        def __init__(self) -> None:
            self.sets = 0

        def set(self) -> None:
            self.sets += 1

    # Standing watch population with churn.
    flags: Dict[str, Flag] = {}
    for i in range(n_watches):
        w = _random_key(rng, prefixes, long_tail=True)
        flags[w] = Flag()
        store.watch_kv(w, flags[w])

    index = 0
    fired_total = 0
    for bi in range(n_batches):
        before = {w: f.sets for w, f in flags.items()}
        with store.capture_apply() as cap:
            for _ in range(batch):
                index += 1
                r = rng.random()
                key = _random_key(rng, prefixes, long_tail=True)
                if r < 0.55:
                    store.kvs_set(index, entry_factory(
                        key=key, value=rng.randbytes(8),
                        flags=rng.randrange(1 << 16)))
                elif r < 0.7:
                    store.kvs_check_and_set(index, entry_factory(
                        key=key, value=b"cas",
                        modify_index=rng.choice([0, index - 1])))
                elif r < 0.85:
                    store.kvs_delete(index, key)
                else:
                    store.kvs_delete_tree(
                        index, prefixes[rng.randrange(len(prefixes) - 1)])
            bridge.on_batch(cap, store)

        # Host-semantics oracle for wakeups: re-walk the events against
        # the *pre-batch* watch registry via the pure evaluator.
        muts = [StoreMutation(path=ev[1], index=ev[3], kv=True,
                              prefix=ev[2])
                for ev in cap.notifies if ev[0] == "kv"]
        preds = [WatchPredicate(KIND_PREFIX, w) for w in before]
        oracle = match_batch(preds, muts)
        for i, w in enumerate(before):
            woke = flags[w].sets > before[w]
            if woke != (i in oracle):
                raise AssertionError(
                    f"wakeup divergence batch {bi}: watch {w!r} "
                    f"woke={woke} oracle={i in oracle}")
            if woke:
                fired_total += 1
                # Exactly-once + re-register (NotifyGroup contract).
                if flags[w].sets != before[w] + 1:
                    raise AssertionError(
                        f"watch {w!r} woke {flags[w].sets - before[w]} "
                        f"times in batch {bi}")
                store.watch_kv(w, flags[w])

        if bridge.divergence:
            raise AssertionError(
                f"device/host divergence after batch {bi}: "
                f"{bridge.divergence}")

    # Verify the device table mirrors the host live set.
    live, tomb, degraded = bridge.occupancy()
    host_live = sum(1 for _ in store._kv.items(""))
    if degraded == 0 and live != host_live:
        raise AssertionError(f"occupancy mismatch: device {live} "
                             f"host {host_live}")

    # Explicit predicate-kind sweep (KIND_KEY/TABLE + min_index) through
    # the low-level matcher against the pure evaluator.
    preds = ([WatchPredicate(KIND_KEY, _random_key(rng, prefixes, False))
              for _ in range(32)]
             + [WatchPredicate(KIND_PREFIX, p) for p in prefixes[:-1]]
             + [WatchPredicate(KIND_TABLE, "nodes"),
                WatchPredicate(KIND_TABLE, "sessions"),
                WatchPredicate(KIND_KEY, "web/", min_index=index + 10)])
    muts = ([StoreMutation(path=_random_key(rng, prefixes, False),
                           index=index + 1 + i) for i in range(16)]
            + [StoreMutation(path="nodes", index=index + 1, kv=False)])
    arrays = bridge.encode_predicates(preds)
    events = bridge._encode_events(
        [("kv", m.path, m.prefix, m.index) if m.kv
         else ("table", m.path, m.index) for m in muts])
    fired, packed = bridge._match(arrays, events)
    fired = set(np.nonzero(fired[:len(preds)].cpu().numpy())[0].tolist())
    want = match_batch(preds, muts)
    if fired != want:
        raise AssertionError(f"predicate sweep divergence: "
                             f"device {sorted(fired)} oracle {sorted(want)}")
    # Bitmask packing is exact.
    words = packed.cpu().numpy().view(np.uint32)
    unpacked = {i for i in range(len(preds))
                if (int(words[i // 32]) >> (i % 32)) & 1}
    if unpacked != fired:
        raise AssertionError(f"packed words disagree with fired: "
                             f"{sorted(unpacked ^ fired)}")

    return {"batches": n_batches, "batch": batch, "ops": index,
            "watches": n_watches, "fired_wakeups": fired_total,
            "device_live": live, "device_tombstones": tomb,
            "degraded": degraded, "divergence": bridge.divergence,
            "predicate_sweep": {"fired": len(fired), "total": len(preds)}}
