"""The round program's argument table on the card: ``csrc/round_table.cu``.

A round program's call (``gossip/program.py``) needs, for each chunk of up
to ``TABLE_ROWS`` rounds, the table of every per-round scalar
(``round_args.py``'s layout) and each round's variant code
(``kernel.Variant``, as ``kernel.variant_code`` packs it).  ``fill`` writes
them straight into the programs' buffers: on CUDA tensors one launch of
``table_kernel`` for up to ``MAX_JOBS`` tables (a multi-DC call's pools and
event pools together), which also resets each program's loop counters (the
chunk's rounds left, the row counter); on CPU tensors its plain version,
``fill_ref``: ``round_args.build`` / ``build_events`` (the host twin of
``jax.random``) and ``kernel.variant_codes`` per job.  ``launches`` counts
the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from consul_tpu_torch import _build, prng
from consul_tpu_torch.gossip import kernel, probe, round_args

MAX_JOBS = 16  # kMaxJobs: tables a launch fills
launches = 0
_VP, _CI, _U32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


class _Rule(ctypes.Structure):
    _fields_ = [("pushpull_every", _CI), ("nem", _CI), ("start", _CI),
                ("stop", _CI), ("degraded", _CI), ("obs_lo", _CI),
                ("obs_hi", _CI), ("flap", _CI), ("flap_period", _CI),
                ("flap_up", _CI)]


class _Job(ctypes.Structure):
    """``round_table::Job``."""
    _fields_ = [("table", _VP), ("variant", _VP), ("left", _VP),
                ("step", _VP), ("key", _U32 * 2), ("rnd0", _CI),
                ("events", _CI), ("fanout", _CI), ("helpers", _CI),
                ("width", _CI), ("probe_every", _CI), ("block", _CI),
                ("span", _U32), ("mult", _U32), ("cursor", ctypes.c_longlong),
                ("ring", _CI), ("rule", _Rule)]


class _Args(ctypes.Structure):
    _fields_ = [("job", _Job * MAX_JOBS), ("jobs", _CI), ("rows", _CI)]


class Job(NamedTuple):
    """One table ``fill`` writes: rows ``0 .. rows - 1`` of ``table`` (int32
    ``[>= rows, width]``, contiguous) for the rounds ``rnd0 ..`` of the
    parameters ``p`` under the pool's ``key`` (``prng`` key), in the
    round's layout or with ``events`` the event round's; the flight-ring
    slots from ``cursor`` in a ring of ``ring`` rows.  Where given:
    ``variant`` (int32 ``[>= rows]``) gets each round's variant code under
    the schedule ``nem``, ``left`` (int32 [1]) the rows, ``step`` (int64
    [1]) 0."""

    p: object
    key: object
    rnd0: int
    table: torch.Tensor
    events: bool = False
    variant: torch.Tensor | None = None
    nem: object = None
    left: torch.Tensor | None = None
    step: torch.Tensor | None = None
    cursor: int = 0
    ring: int = 1


@functools.lru_cache(maxsize=None)
def _lib():
    """``round_table_fill`` of ``csrc/round_table.cu``, built and loaded,
    and the library's error-string function, both typed."""
    lib = _build.load("round_table")
    fn, err = lib.round_table_fill, lib.round_table_error
    fn.argtypes, fn.restype = [ctypes.POINTER(_Args), _VP], _CI
    err.argtypes, err.restype = [_CI], ctypes.c_char_p
    return fn, err


def _width(j: Job) -> int:
    p = j.p
    return (round_args.event_layout(p.fanout).width if j.events
            else round_args.layout(p.fanout, p.indirect_k).width)


def _check(j: Job, rows: int, dev) -> None:
    """``j``'s buffers as the kernel takes them, on ``dev``."""
    want = [("table", j.table, torch.int32, None),
            ("variant", j.variant, torch.int32, None),
            ("left", j.left, torch.int32, 1), ("step", j.step, torch.int64, 1)]
    for name, t, dtype, numel in want:
        if t is None:
            continue
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"a table's {name} must be a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype}{list(t.shape)} "
                             f"on {t.device}")
        if numel is not None and t.numel() != numel:
            raise ValueError(f"a table's {name} holds one word")
    if j.table.dim() != 2 or j.table.shape[1] != _width(j) \
            or j.table.shape[0] < rows:
        raise ValueError(f"a table of {rows} rows of {_width(j)} words, got "
                         f"{list(j.table.shape)}")
    if j.variant is not None and j.variant.numel() < rows:
        raise ValueError(f"a variant column of {rows} rows, got "
                         f"{j.variant.numel()}")
    round_args._check_rounds(j.rnd0, rows)


def _rule(j: Job) -> _Rule:
    p, nem = j.p, j.nem
    if nem is None:
        return _Rule(p.pushpull_every)
    return _Rule(p.pushpull_every, 1, nem.start, nem.stop,
                 int(nem.has_degraded), nem.obs_lo, nem.obs_hi,
                 int(nem.has_flap), nem.flap_period, nem.flap_up)


def _job(j: Job) -> _Job:
    p = j.p
    span, mult = prng._randint_span(1, p.n)

    def ptr(t):
        return None if t is None else t.data_ptr()

    return _Job(j.table.data_ptr(), ptr(j.variant), ptr(j.left), ptr(j.step),
                (_U32 * 2)(*prng._key_words(j.key)), int(j.rnd0),
                int(j.events), p.fanout, p.indirect_k, _width(j),
                p.probe_every, probe.block_size(p), span, mult,
                int(j.cursor), int(j.ring), _rule(j))


def fill_ref(jobs, rows: int) -> None:
    """The plain version of ``fill``: each job's rows from the host twin
    (``round_args.build`` / ``build_events``), its variant column from
    ``kernel.variant_codes``, its counters set; one host-to-device copy a
    buffer."""
    for j in jobs:
        _check(j, rows, j.table.device)
        if j.events:
            tbl = round_args.build_events(j.p, j.key, j.rnd0, rows)
        else:
            tbl = round_args.build(j.p, j.key, j.rnd0, rows, j.cursor, j.ring)
        j.table[:rows].copy_(torch.from_numpy(tbl))
        if j.variant is not None:
            j.variant[:rows].copy_(torch.from_numpy(
                kernel.variant_codes(j.p, j.nem, j.rnd0, rows)))
        if j.left is not None:
            j.left.fill_(rows)
        if j.step is not None:
            j.step.zero_()


def fill(jobs, rows: int) -> None:
    """Rows ``0 .. rows - 1`` of every job's table (``Job``), its variant
    column and counters where given: on CUDA tensors one launch of
    ``table_kernel`` a ``MAX_JOBS`` jobs on the current stream (raising if
    refused), on CPU tensors ``fill_ref``."""
    jobs = list(jobs)
    dev = jobs[0].table.device
    if any(j.table.device != dev for j in jobs):
        raise ValueError("a fill's tables lie on one device")
    if dev.type == "cpu":
        fill_ref(jobs, rows)
        return
    if dev.type != "cuda":
        raise ValueError(f"table_kernel runs on a CUDA card, not {dev}")
    _launch(jobs, rows)


def _launch(jobs, rows: int) -> None:
    """``table_kernel``'s launches for ``jobs``, their buffers checked and
    packed as ``round_table::Args``, a ``MAX_JOBS`` jobs a launch."""
    global launches
    fn, err = _lib()
    dev = jobs[0].table.device
    for at in range(0, len(jobs), MAX_JOBS):
        part = jobs[at:at + MAX_JOBS]
        for j in part:
            _check(j, rows, dev)
        args = _Args((_Job * MAX_JOBS)(*map(_job, part)), len(part), rows)
        _build.launch(fn, err, "round_table_fill", dev, ctypes.byref(args))
        launches += 1

