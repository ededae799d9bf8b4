"""The round's scalars as one int32 table, row ``k`` for round ``rnd0 + k``.

The reference derives every per-round scalar inside its jitted scan from
the traced round counter (``consul_tpu/gossip/kernel.py``: ``fold_in(key,
rnd)`` and the sub-keys, the probe tick's target and helper offsets, the
gossip shifts, the push/pull partner, the prober block).  The port builds
the same values on the host, for all of a call's rounds at once, with the
host twin of ``jax.random`` (``prng._threefry2x32`` over numpy arrays: one
vectorised pass per key derivation, every round in a lane), and moves them
to the device in one copy.  The round then reads its row with a device
index, so no argument of any operation or launch depends on the round
number, and one captured round serves every round (``gossip/program.py``).

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

def _hash(k, x):
    """threefry2x32 of the counter (0, x) under the keys ``k`` (a pair of
    int64 arrays), one lane per round: the two output words."""
    return _threefry2x32(k[0], k[1], 0, x)


def _fold_in(k, data: int):
    return _hash(k, data)


def _split(k, num: int):
    return [_hash(k, i) for i in range(num)]


def _randint(k, count: int, minval: int, maxval: int) -> np.ndarray:
    """``randint(k, (count,), minval, maxval)`` per lane: int64
    ``[lanes, count]`` with the int32 values."""
    span, mult = _randint_span(minval, maxval)
    k_hi, k_lo = _split(k, 2)
    out = []
    for i in range(count):
        hi = np.bitwise_xor(*_hash(k_hi, i))
        lo = np.bitwise_xor(*_hash(k_lo, i))
        off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
        v = (minval + off % span) & _M32
        out.append(np.where(v >= 2**31, v - 2**32, v))
    return np.stack(out, axis=1)


def _words(k) -> np.ndarray:
    """A key per lane as two int32 columns (the uint32 bit patterns)."""
    return np.stack(k, axis=1).astype(np.uint32).view(np.int32)


def build(p, base_key, rnd0: int, steps: int, cursor: int = 0,
          ring: int = 1) -> np.ndarray:
    """The int32 table ``[steps, width]`` of rounds ``rnd0 ..
    rnd0 + steps - 1`` under ``base_key`` (``prng`` key, uint32[2]) for
    the parameters ``p``; ``cursor`` and ``ring`` place each round's
    flight row (ignored without a ring)."""
    lay = layout(p.fanout, p.indirect_k)
    N, F, K = p.n, p.fanout, p.indirect_k
    tbl = np.zeros((steps, lay.width), np.int32)
    if steps == 0:
        return tbl
    rnd = np.arange(rnd0, rnd0 + steps, dtype=np.int64)
    if rnd[-1] >= 2**31:
        raise OverflowError("the round counter passes int32")
    base = np.asarray(base_key).astype(np.int64)
    key = _hash((np.full(steps, base[0]), np.full(steps, base[1])), rnd)
    k_t, k_dl, k_h, k_hl = _split(_fold_in(key, 1), 4)
    B = max(1, -(-N // p.probe_every))
    tbl[:, RND] = rnd
    tbl[:, GOSSIP:GOSSIP + F] = _randint(_fold_in(key, 2), F, 1, N)
    tbl[:, lay.blk] = (rnd % p.probe_every) * B
    tbl[:, lay.flight] = (cursor + np.arange(steps)) % ring
    tbl[:, lay.probe:lay.probe + 1 + K] = _randint(k_t, 1 + K, 1, N)
    o = _randint(_fold_in(key, 3), 1, 1, N)[:, 0]
    tbl[:, lay.pp], tbl[:, lay.pp + 1] = o, -o
    tbl[:, lay.k_dl:lay.k_dl + 2] = _words(k_dl)
    tbl[:, lay.k_hl:lay.k_hl + 2] = _words(k_hl)
    for j, sub in enumerate(_split(k_h, 4)):
        tbl[:, lay.k_nem + 2 * j:lay.k_nem + 2 * j + 2] = _words(sub)
    k_nem = _fold_in(key, 4)
    for f in range(F):
        tbl[:, lay.k_legs + 2 * f:lay.k_legs + 2 * f + 2] = _words(
            _fold_in(k_nem, f))
    k_pp = _fold_in(key, 5)
    for j in range(2):
        tbl[:, lay.k_pp + 2 * j:lay.k_pp + 2 * j + 2] = _words(
            _fold_in(k_pp, j))
    return tbl


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
