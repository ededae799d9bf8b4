"""The round's observers: masked per-row counts over the belief matrix,
the Hopper kernel and its plain torch version.

The reference's jitted round reads its ``[S, N]`` matrix three more times
for what the round reports (XLA reductions, no Pallas source;
``consul_tpu/gossip/kernel.py``): the flight row's dissemination bytes
(``:1088-1094``, the live rumors of the round's final matrix), the hist
banks' spread (``:1606-1625``, members still holding the verdict of a
slot being recycled, on its pre-GC row) and the trace's holders
(``:1762-1771``, members holding DEAD and REFUTE after the round).  Here
all of them are rows of one function, ``heard_counts``: on a CUDA tensor
one launch of ``csrc/observe.cu`` (entry point ``heard_counts``), which
reads the matrix once, every column shard in the same launch; on a CPU
tensor the plain version ``heard_counts_ref``.  ``count`` is what the
round calls.  There is no fallback.

The counts, int32 ``[4, R]`` for ``R`` rows (``COUNTS`` names them); a
launch makes those of its form and 0 in the others:

- without a ``verdict`` (the final matrix's form: the trace's holders and
  the flight row's rumors):

  - ``dead``: columns whose message is DEAD and whose node is a member;
  - ``refute``: the same for REFUTE (alive@inc);
  - ``live``: columns with a message whose age is below the spread budget
    (no member mask): the rumors the round pushes;

- with a ``verdict`` (the spread's form), ``hold``: members whose message
  equals the row's ``verdict`` (0 for a verdict outside 0..3).

``want`` (bool ``[R]``, or None for every row) masks the rows read: a row
that is not wanted is not read and has 0 in every count, so a launch
whose ``want`` is all false costs the launch alone.  ``heard`` is one u8
``[R, N]`` tensor or a tuple of ``[R, L]`` column shards; ``member`` is
the global bool ``[N]`` vector either way.  Nothing here reads a value
back to the host, and the kernel zeroes its own outputs, so a launch runs
inside the round program's captured graphs as it is.  Its scratch
(``counts_scratch``) is the caller's, as the event flood's is: a zero
buffer that every launch leaves zero, which the launches of one caller
use one at a time (the round program and the eager round loop own one
each); without one, a launch makes its own.  The spread's form lets a
programmatic dependent launch behind it start early (the round's
``finish_slots.record``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from consul_tpu_torch import _build
from consul_tpu_torch._device import check_tensor, require_cuda
from consul_tpu_torch.gossip.belief import (_AGE_MASK, _MSG_SHIFT, MSG_DEAD,
                                            MSG_REFUTE)

COUNTS = ("dead", "refute", "live", "hold")
DEAD, REFUTE, LIVE, HOLD = range(len(COUNTS))
_I32 = torch.int32
MAX_SHARDS = 64        # kMaxShards of csrc/observe.cu
BLOCK_ROWS = 1024      # kMaxRows: rows a block lists at once; past it the
                       # wide kernel takes them in chunks
MAX_ROWS = 1 << 24     # kMaxSlots: the rows a launch takes
# Kernel launches made by ``heard_counts`` (one per launch, nowhere else).
launches = 0
# (R, L, ndev, budget, verdict given, want given) of every launch, so a
# smoke run can hold each shape its paths launched at against the plain
# version.
launch_shapes: set = set()
_VP, _CI = ctypes.c_void_p, ctypes.c_int
# The C entry point's argument types: the shard table, ndev, member,
# verdict, want, out, scratch, R, L, the budget and the stream.
_ARGTYPES = [ctypes.POINTER(_VP), _CI] + [_VP] * 5 + [_CI] * 3 + [_VP]


def _shards(heard) -> tuple:
    return heard if isinstance(heard, tuple) else (heard,)


def _counts_one(h: torch.Tensor, mem: torch.Tensor, budget: int,
                verdict) -> torch.Tensor:
    msg = h >> _MSG_SHIFT
    mem = mem[None, :]
    zero = torch.zeros(h.shape[0], dtype=_I32, device=h.device)
    if verdict is not None:
        return torch.stack([zero, zero, zero,
                            ((msg == verdict[:, None]) & mem).sum(
                                dim=1, dtype=_I32)])
    return torch.stack([
        ((msg == MSG_DEAD) & mem).sum(dim=1, dtype=_I32),
        ((msg == MSG_REFUTE) & mem).sum(dim=1, dtype=_I32),
        ((msg > 0) & ((h & _AGE_MASK) < budget)).sum(dim=1, dtype=_I32),
        zero])


def heard_counts_ref(heard, member: torch.Tensor, budget: int,
                     verdict: torch.Tensor | None = None,
                     want: torch.Tensor | None = None) -> torch.Tensor:
    """The plain torch version of the kernel, on any device: the counts
    of the module docstring in the form ``verdict`` selects, int32
    [4, R], each shard's columns against its slice of ``member``, summed.
    The budget is clamped into [0, 16] first, as the kernel clamps it: an
    age (0..15) is below it exactly when it is below the clamped budget,
    and a u8 compare would wrap a negative one."""
    budget = min(max(int(budget), 0), 16)
    shards = _shards(heard)
    L = shards[0].shape[1]
    out = sum(_counts_one(h, member[i * L:(i + 1) * L], budget, verdict)
              for i, h in enumerate(shards))
    if want is not None:
        out = torch.where(want[None, :], out, 0)
    return out


def scratch_words(R: int) -> int:
    """The int32 words of the kernel's scratch at ``R`` rows
    (``heard_counts_scratch_words`` of ``csrc/observe.cu``): four counts a
    row and the grid's arrival counter."""
    return len(COUNTS) * R + 1


def counts_scratch(R: int, device) -> torch.Tensor:
    """A zero scratch for ``heard_counts`` launches of up to ``R`` rows:
    every launch leaves it zero, so one serves a caller's launches one
    after another (on one stream), in and out of captured graphs."""
    return torch.zeros(scratch_words(R), dtype=_I32, device=device)


@functools.lru_cache(maxsize=None)
def _lib():
    """``heard_counts`` of ``csrc/observe.cu``, built and loaded, and the
    library's error-string function, both typed."""
    lib = _build.load("observe")
    fn, err = lib.heard_counts, lib.observe_error
    fn.argtypes, fn.restype = _ARGTYPES, _CI
    err.argtypes, err.restype = [_CI], ctypes.c_char_p
    return fn, err


@functools.lru_cache(maxsize=None)
def _array(n: int):
    return _VP * n


def heard_counts(heard, member: torch.Tensor, budget: int,
                 verdict: torch.Tensor | None = None,
                 want: torch.Tensor | None = None,
                 scratch: torch.Tensor | None = None) -> torch.Tensor:
    """Launch ``heard_counts`` of ``csrc/observe.cu`` on CUDA tensors (the
    arguments of ``heard_counts_ref``: ``heard`` u8 [R, N] or 1 to
    ``MAX_SHARDS`` shards [R, L]; ``member`` bool [N]; ``verdict`` int32
    [R] (the spread's form) or None (the final matrix's); ``want`` bool
    [R] or None): one launch for every shard.
    ``scratch``: a ``counts_scratch`` of at least ``R`` rows that no
    other launch uses meanwhile, or None for a new one (refused during a
    capture, which would record its memset).  Returns a new int32 [4, R]
    tensor.  Launches on the current stream and does not synchronise.
    Raises on anything the kernel does not take."""
    global launches
    shards = _shards(heard)
    ndev = len(shards)
    if not 1 <= ndev <= MAX_SHARDS:
        raise ValueError(f"heard_counts takes 1 to {MAX_SHARDS} shards, "
                         f"got {ndev}")
    require_cuda("heard_counts", shards[0])
    if shards[0].dim() != 2:
        raise ValueError(f"heard must be [R, N] or shards [R, L], got "
                         f"{list(shards[0].shape)}")
    R, L = shards[0].shape
    dev = shards[0].device
    N = ndev * L
    for i, h in enumerate(shards):
        check_tensor(f"shard {i}", h, torch.uint8, (R, L), dev)
    check_tensor("member", member, torch.bool, (N,), dev)
    if verdict is not None:
        check_tensor("verdict", verdict, _I32, (R,), dev)
    if want is not None:
        check_tensor("want", want, torch.bool, (R,), dev)
    if R > MAX_ROWS or N >= 2**31 - 16:
        raise ValueError(f"heard_counts takes R <= {MAX_ROWS} and N below "
                         f"2**31 - 16, got R={R}, N={N}")
    if R == 0 or N == 0:
        return torch.zeros((len(COUNTS), R), dtype=_I32, device=dev)
    if scratch is not None and (
            scratch.dtype != _I32 or scratch.dim() != 1
            or scratch.device != dev or not scratch.is_contiguous()
            or scratch.numel() < scratch_words(R)):
        raise ValueError(f"scratch must be a contiguous int32 vector of at "
                         f"least {scratch_words(R)} words on {dev}, got "
                         f"{scratch.dtype}{list(scratch.shape)} on "
                         f"{scratch.device}")
    fn = _lib()  # built at the first launch; a failed build raises here
    if scratch is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("heard_counts: pass a scratch under a "
                               "capture")
        scratch = counts_scratch(R, dev)
    out = torch.empty((len(COUNTS), R), dtype=_I32, device=dev)
    table = _array(ndev)(*(h.data_ptr() for h in shards))
    _build.launch(*fn, "heard_counts", dev, table, ndev,
                  member.data_ptr(),
                  None if verdict is None else verdict.data_ptr(),
                  None if want is None else want.data_ptr(),
                  out.data_ptr(), scratch.data_ptr(), R, L, int(budget))
    launches += 1
    launch_shapes.add((R, L, ndev, int(budget), verdict is not None,
                       want is not None))
    return out


def count(heard, member: torch.Tensor, budget: int,
          verdict: torch.Tensor | None = None,
          want: torch.Tensor | None = None,
          scratch: torch.Tensor | None = None) -> torch.Tensor:
    """The counts of the module docstring: the kernel on CUDA tensors
    (``scratch`` as ``heard_counts`` takes it), its plain version on CPU
    tensors (which needs none)."""
    if _shards(heard)[0].device.type == "cpu":
        return heard_counts_ref(heard, member, budget, verdict, want)
    return heard_counts(heard, member, budget, verdict, want, scratch)
