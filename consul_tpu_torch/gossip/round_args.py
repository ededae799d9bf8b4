"""The round's scalars as one int32 table, row ``k`` for round ``rnd0 + k``.

The reference derives every per-round scalar inside its jitted scan from
the traced round counter (``consul_tpu/gossip/kernel.py``: ``fold_in(key,
rnd)`` and the sub-keys, the probe tick's target and helper offsets, the
gossip shifts, the push/pull partner, the prober block).  On a card the
round programs' tables come from a kernel (``round_table.py``,
``csrc/round_table.cu``) that writes them straight into the programs'
buffers; ``build``, ``build_events`` and ``build_pools`` here are its
plain version, the eager round's table and the CPU's: the same values on
the host, for all of a call's rounds at once, with the host twin of
``jax.random`` (``prng._threefry2x32`` over numpy arrays: one vectorised
pass per key derivation, every round in a lane).  The round reads its row
with a device index, so no argument of any operation or launch depends on
the round number, and one captured round serves every round
(``gossip/program.py``).

Row layout (``Layout``; widths from ``fanout`` F and ``indirect_k`` K):

- ``RND`` (0): the round number; ``GOSSIP`` (1 .. F): the gossip shifts
  (``kernel.gossip_offsets``).  Together ``[rnd, o_0 .. o_F-1]``, the
  argument buffer of the dissemination tail's kernels;
- ``blk``: the prober block's first id, ``(rnd % probe_every) * B``;
- ``flight``: the flight-ring slot ``(cursor + k) % R`` of the round's row;
- ``probe``: the probe tick's ``1 + K`` offsets (target, helpers);
- ``pp``: the push/pull partner shift and its negation, ``(o, -o)``;
- keys, two words each (a uint32 bit pattern in int32): ``k_dl`` and
  ``k_hl`` (the direct and indirect probes' losses), the four nemesis
  probe legs' ``split(k_h, 4)``, the F dissemination drop legs
  ``fold_in(fold_in(key, 4), f)`` and the two push/pull drop legs
  ``fold_in(fold_in(key, 5), j)``.

The values of every column are the scalar twin's (``prng.fold_in``,
``split``, ``randint``) bit for bit (``tests/test_torch_round_program.py``
holds each column against them and against ``jax.random``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch.prng import _M32, _randint_span, _threefry2x32


class Layout(NamedTuple):
    """Column offsets of one parameter set's table."""

    F: int       # gossip fanout
    K: int       # indirect probe helpers
    blk: int
    flight: int
    probe: int   # 1 + K columns
    pp: int      # 2 columns: o, -o
    k_dl: int    # every key: 2 columns
    k_hl: int
    k_nem: int   # 4 keys
    k_legs: int  # F keys
    k_pp: int    # 2 keys
    width: int


RND, GOSSIP = 0, 1


@functools.lru_cache(maxsize=64)
def layout(fanout: int, indirect_k: int) -> Layout:
    F, K = fanout, indirect_k
    blk = 1 + F
    probe = blk + 2
    pp = probe + 1 + K
    k_dl = pp + 2
    k_nem = k_dl + 4
    k_legs = k_nem + 8
    k_pp = k_legs + 2 * F
    return Layout(F, K, blk, blk + 1, probe, pp, k_dl, k_dl + 2, k_nem,
                  k_legs, k_pp, k_pp + 4)


# -- the host twin, one lane per round ---------------------------------------
#
# A lane value is a Python int (a one-row build: the scalar path, about
# five times quicker than numpy on length-1 arrays) or an int64 numpy
# array with one entry per lane (every round of a call, of every pool of a
# multi-pool call).  The same code computes both, bit for bit.

def _hash(k, x):
    """threefry2x32 of the counter (0, x) under the keys ``k`` (a pair of
    lane values): the two output words."""
    return _threefry2x32(k[0], k[1], 0, x)


def _fold_in(k, data: int):
    return _hash(k, data)


def _split(k, num: int):
    return [_hash(k, i) for i in range(num)]


def _i32(v):
    """uint32 bit patterns (lane values in [0, 2**32)) as int32 values."""
    return v - ((v >> 31) << 32)


def _randint(k, count: int, minval: int, maxval: int) -> list:
    """``randint(k, (count,), minval, maxval)`` per lane: ``count`` lane
    values (int32 values)."""
    span, mult = _randint_span(minval, maxval)
    k_hi, k_lo = _split(k, 2)
    out = []
    for i in range(count):
        a, b = _hash(k_hi, i)
        c, d = _hash(k_lo, i)
        hi, lo = a ^ b, c ^ d
        off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
        out.append(_i32((minval + off % span) & _M32))
    return out


def _put_key(tbl: np.ndarray, at: int, k) -> None:
    """A key per lane as two int32 columns (the uint32 bit patterns)."""
    tbl[:, at] = _i32(k[0])
    tbl[:, at + 1] = _i32(k[1])


def _check_rounds(rnd0: int, steps: int) -> None:
    if steps and rnd0 + steps - 1 >= 2**31:
        raise OverflowError("the round counter passes int32")


def _fill(tbl: np.ndarray, p, lay: Layout, base, rnd, flight) -> None:
    """The round columns of every lane: ``base`` the pool's key, ``rnd``
    the round and ``flight`` the flight-ring slot, each a lane value."""
    N, F, K = p.n, p.fanout, p.indirect_k
    key = _hash(base, rnd & _M32)
    k_t, k_dl, k_h, k_hl = _split(_fold_in(key, 1), 4)
    B = max(1, -(-N // p.probe_every))
    tbl[:, RND] = rnd
    for f, o in enumerate(_randint(_fold_in(key, 2), F, 1, N)):
        tbl[:, GOSSIP + f] = o
    tbl[:, lay.blk] = (rnd % p.probe_every) * B
    tbl[:, lay.flight] = flight
    for j, o in enumerate(_randint(k_t, 1 + K, 1, N)):
        tbl[:, lay.probe + j] = o
    o = _randint(_fold_in(key, 3), 1, 1, N)[0]
    tbl[:, lay.pp], tbl[:, lay.pp + 1] = o, -o
    _put_key(tbl, lay.k_dl, k_dl)
    _put_key(tbl, lay.k_hl, k_hl)
    for j, sub in enumerate(_split(k_h, 4)):
        _put_key(tbl, lay.k_nem + 2 * j, sub)
    k_nem = _fold_in(key, 4)
    for f in range(F):
        _put_key(tbl, lay.k_legs + 2 * f, _fold_in(k_nem, f))
    k_pp = _fold_in(key, 5)
    for j in range(2):
        _put_key(tbl, lay.k_pp + 2 * j, _fold_in(k_pp, j))


def _base_words(base_key) -> tuple:
    return tuple(int(w) for w in np.asarray(base_key).astype(np.int64))


def build(p, base_key, rnd0: int, steps: int, cursor: int = 0,
          ring: int = 1) -> np.ndarray:
    """The int32 table ``[steps, width]`` of rounds ``rnd0 ..
    rnd0 + steps - 1`` under ``base_key`` (``prng`` key, uint32[2]) for
    the parameters ``p``; ``cursor`` and ``ring`` place each round's
    flight row (ignored without a ring).  One row (an eager round) takes
    the scalar path on Python ints, more rows one vectorised pass."""
    lay = layout(p.fanout, p.indirect_k)
    tbl = np.zeros((steps, lay.width), np.int32)
    _check_rounds(rnd0, steps)
    if steps == 1:
        _fill(tbl, p, lay, _base_words(base_key), int(rnd0),
              int(cursor) % ring)
    elif steps:
        _fill(tbl, p, lay, _base_words(base_key),
              np.arange(rnd0, rnd0 + steps, dtype=np.int64),
              (cursor + np.arange(steps)) % ring)
    return tbl


# -- the event round's row ------------------------------------------------------
#
# The user-event flood (``gossip/events.py``) draws, per round, under
# ``key = fold_in(fold_in(pool_key, 7), rnd)``: its F gossip shifts
# ``randint(key, (F,), 1, N)`` (``kernel.gossip_offsets`` of ``key`` itself)
# and its push/pull partner ``randint(fold_in(key, 9), (), 1, N)``.  Row
# ``[rnd, o_0 .. o_F-1, pp_o, -pp_o]``: the first F + 1 words are the flood
# kernel's argument buffer, as ``[rnd, o ..]`` is the tail's; a push/pull
# round's kernel also reads the two partner shifts after them.


class EventLayout(NamedTuple):
    F: int       # gossip fanout
    pp: int      # 2 columns: pp_o, -pp_o
    width: int


def event_layout(fanout: int) -> EventLayout:
    return EventLayout(fanout, 1 + fanout, 3 + fanout)


def _fill_events(tbl: np.ndarray, p, base, rnd) -> None:
    N, F = p.n, p.fanout
    key = _hash(_fold_in(base, 7), rnd & _M32)
    tbl[:, RND] = rnd
    for f, o in enumerate(_randint(key, F, 1, N)):
        tbl[:, GOSSIP + f] = o
    o = _randint(_fold_in(key, 9), 1, 1, N)[0]
    tbl[:, 1 + F], tbl[:, 2 + F] = o, -o


def build_events(p, base_key, rnd0: int, steps: int) -> np.ndarray:
    """The event rounds' int32 table ``[steps, F + 3]`` of rounds ``rnd0
    ..`` under the pool's ``base_key``; one row on the scalar path."""
    tbl = np.zeros((steps, event_layout(p.fanout).width), np.int32)
    _check_rounds(rnd0, steps)
    if steps == 1:
        _fill_events(tbl, p, _base_words(base_key), int(rnd0))
    elif steps:
        _fill_events(tbl, p, _base_words(base_key),
                     np.arange(rnd0, rnd0 + steps, dtype=np.int64))
    return tbl


def build_pools(p, keys, rnd0s, steps: int, events: bool = False
                ) -> np.ndarray:
    """The tables ``[P, steps, width]`` of P pools of the parameters
    ``p``: pool ``j`` under ``keys[j]`` (uint32[P, 2]) from round
    ``rnd0s[j]``, its round rows (no flight ring) or with ``events`` its
    event rows; every pool's rounds in one vectorised pass."""
    keys = np.asarray(keys).reshape(-1, 2).astype(np.int64)
    P = keys.shape[0]
    r0 = np.asarray(rnd0s, np.int64).reshape(P)
    for r in r0:
        _check_rounds(int(r), steps)
    width = (event_layout(p.fanout).width if events
             else layout(p.fanout, p.indirect_k).width)
    tbl = np.zeros((P * steps, width), np.int32)
    if tbl.shape[0]:
        base = (np.repeat(keys[:, 0], steps), np.repeat(keys[:, 1], steps))
        rnd = (r0[:, None] + np.arange(steps)).reshape(-1)
        if events:
            _fill_events(tbl, p, base, rnd)
        else:
            _fill(tbl, p, layout(p.fanout, p.indirect_k), base, rnd, 0)
    return tbl.reshape(P, steps, width)


def to_device(tbl: np.ndarray, device) -> torch.Tensor:
    """The table on ``device``: on a card one asynchronous copy from
    pinned memory on the current stream (the pinned buffer is held by
    PyTorch's host allocator until the copy is done), so nothing waits."""
    t = torch.from_numpy(tbl)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)


class RoundArgs(NamedTuple):
    """One round's row as device views (every field a tensor)."""

    rnd: torch.Tensor      # i32 scalar
    gossip: torch.Tensor   # i32 [F], right after rnd in the row
    blk: torch.Tensor      # i32 scalar
    flight: torch.Tensor   # i32 scalar
    probe: torch.Tensor    # i32 [1 + K]
    pp: torch.Tensor       # i32 [2]: o, -o
    k_dl: torch.Tensor     # i32 [2]
    k_hl: torch.Tensor     # i32 [2]
    k_nem: torch.Tensor    # i32 [4, 2]: k_np, k_no, k_nip, k_nio
    k_legs: torch.Tensor   # i32 [F, 2]
    k_pp: torch.Tensor     # i32 [2, 2]


def row_args(lay: Layout, row: torch.Tensor) -> RoundArgs:
    """Views of one table row (``row``: i32 [width], contiguous)."""
    F, K = lay.F, lay.K

    def keys(at, n):
        return row[at:at + 2 * n].view(n, 2)

    return RoundArgs(
        rnd=row[RND], gossip=row[GOSSIP:GOSSIP + F],
        blk=row[lay.blk], flight=row[lay.flight],
        probe=row[lay.probe:lay.probe + 1 + K], pp=row[lay.pp:lay.pp + 2],
        k_dl=row[lay.k_dl:lay.k_dl + 2], k_hl=row[lay.k_hl:lay.k_hl + 2],
        k_nem=keys(lay.k_nem, 4), k_legs=keys(lay.k_legs, F),
        k_pp=keys(lay.k_pp, 2))


def custom(p, rnd: int, device="cpu", **cols) -> RoundArgs:
    """A row holding the round ``rnd`` and the named ``RoundArgs`` columns
    given (``gossip=[...]``, ``probe=[...]``, ``blk=b``, ``k_legs=[key,
    ...]``, ...; keys as uint32 pairs), zero elsewhere: for running one
    phase of the round alone, at shifts and keys the caller chose."""
    lay = layout(p.fanout, p.indirect_k)
    start = {"gossip": GOSSIP, "blk": lay.blk, "flight": lay.flight,
             "probe": lay.probe, "pp": lay.pp, "k_dl": lay.k_dl,
             "k_hl": lay.k_hl, "k_nem": lay.k_nem, "k_legs": lay.k_legs,
             "k_pp": lay.k_pp}
    row = np.zeros(lay.width, np.int32)
    row[RND] = rnd
    for name, val in cols.items():
        words = np.asarray(val, np.int64).reshape(-1).astype(np.uint32)
        row[start[name]:start[name] + words.size] = words.view(np.int32)
    return row_args(lay, torch.from_numpy(row).to(device))


class EventArgs(NamedTuple):
    """One event round's row as device views."""

    rnd: torch.Tensor     # i32 scalar
    gossip: torch.Tensor  # i32 [F]
    pp: torch.Tensor      # i32 [2]: pp_o, -pp_o
    row: torch.Tensor     # i32 [F + 3], the whole row (the kernel's buffer)


def event_args(fanout: int, row: torch.Tensor) -> EventArgs:
    """Views of one event table row (``row``: i32 [F + 3], contiguous)."""
    F = fanout
    return EventArgs(rnd=row[RND], gossip=row[GOSSIP:GOSSIP + F],
                     pp=row[1 + F:3 + F], row=row)
