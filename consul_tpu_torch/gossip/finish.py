"""The round's belief-matrix passes outside the dissemination tail: the
suspicion timers' fire pass and the row wipes, in place, the Hopper
kernels and their plain torch versions.

The reference's jitted round rewrites its ``[S, N]`` matrix in four XLA
steps besides the tail (no Pallas source; ``consul_tpu/gossip/kernel.py``):
the finish step's refutation write and timer fire (``:1529``,
``:1548-1565``), its slot GC wipe (``:1629``), the probe tick's rearm wipe
(``:734``) and the join tick's stale wipe (``:478``).  Here they are two
functions that write the matrix in place and touch only the rows that need
it:

- ``fire``: per row a 4-bit ``ok_mask`` (bit ``c`` set where the row's
  timer has run out at confirmation count ``c``; 0 unless the slot is
  SUSPECT) and, optionally, the refutation (``refute``: a global column
  and a byte a row, applied as a max before the fire test); a SUSPECT
  byte whose column takes messages (``rx_ok``) and whose conf has its bit
  set becomes DEAD.  Returns ``fired``, bool ``[R]``: the OR of each row
  over every column and shard.
- ``wipe``: zero the rows ``flags`` selects.

``heard`` is one u8 ``[R, N]`` tensor or a tuple of ``[R, L]`` column
shards; ``rx_ok`` is the global bool ``[N]`` vector either way.  On a
CUDA tensor each call is one launch of ``csrc/finish.cu`` for every
shard (entry points ``fire_timers`` and ``wipe_rows``); on a CPU tensor
the plain versions ``fire_timers_ref`` and ``wipe_rows_ref``.  There is
no fallback.  Nothing here reads a value back to the host and neither
kernel needs a memset, so both run inside the round program's captured
graphs as they are.  ``fire``'s scratch is the caller's, as the
observers' kernel's is (``observe.counts_scratch`` serves both: a zero
buffer every launch leaves zero).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from consul_tpu_torch import _build
from consul_tpu_torch._device import check_tensor, require_cuda
from consul_tpu_torch.gossip.belief import (_CONF_MASK, _CONF_SHIFT,
                                            _MSG_SHIFT, MSG_DEAD,
                                            MSG_SUSPECT)

_I32 = torch.int32
_U8 = torch.uint8
MAX_SHARDS = 64    # kMaxShards of csrc/finish.cu
BLOCK_ROWS = 2048  # kMaxRows: rows a block lists at once in shared memory;
                   # past it the wide kernels take them in chunks
MAX_ROWS = 1 << 24  # kMaxSlots: the rows a launch takes
_DEAD = MSG_DEAD << _MSG_SHIFT  # DEAD, conf 0, age 0
# Kernel launches made by ``fire_timers`` and ``wipe_rows`` (one per
# launch, nowhere else), and by both.
fire_launches = 0
wipe_launches = 0
launches = 0
# (kernel, R, L, ndev, refutation given) of every launch, so a smoke run
# can hold each shape its paths launched at against the plain version.
launch_shapes: set = set()
_VP, _CI = ctypes.c_void_p, ctypes.c_int
# The C entry points' argument types: the shard table, ndev, then
# fire_timers' rx, ok, col, rb, fired, scratch or wipe_rows' flags, then
# R, L and the stream.
_FIRE_ARGTYPES = [ctypes.POINTER(_VP), _CI] + [_VP] * 6 + [_CI] * 2 + [_VP]
_WIPE_ARGTYPES = [ctypes.POINTER(_VP), _CI, _VP, _CI, _CI, _VP]


def _shards(heard) -> tuple:
    return heard if isinstance(heard, tuple) else (heard,)


def fire_timers_ref(heard, rx_ok: torch.Tensor, ok_mask: torch.Tensor,
                    refute=None) -> torch.Tensor:
    """The plain torch version of ``fire_timers``, on any device, in
    place: the refutation's max on the shard that owns each row's column,
    then the fire; returns ``fired``, bool [R]."""
    shards = _shards(heard)
    R, L = shards[0].shape
    dev = shards[0].device
    if refute is not None:
        col, rb = refute
        rows = torch.arange(R, device=dev)
        for i, h in enumerate(shards):
            owned = (col >= i * L) & (col < (i + 1) * L)
            loc = (col - i * L).clamp(0, L - 1).long()
            byte = h[rows, loc]
            h[rows, loc] = torch.where(owned, torch.maximum(byte, rb), byte)
    fired = torch.zeros((R,), dtype=torch.bool, device=dev)
    for i, h in enumerate(shards):
        conf = (h >> _CONF_SHIFT) & _CONF_MASK
        fire = (((h >> _MSG_SHIFT) == MSG_SUSPECT)
                & rx_ok[i * L:(i + 1) * L][None, :]
                & (((ok_mask[:, None] >> conf) & 1) == 1))
        h.masked_fill_(fire, _DEAD)
        fired |= fire.any(dim=1)
    return fired


def wipe_rows_ref(heard, flags: torch.Tensor) -> None:
    """The plain torch version of ``wipe_rows``, on any device: the
    flagged rows of every shard zeroed in place."""
    for h in _shards(heard):
        h.masked_fill_(flags[:, None], 0)


def scratch_words(R: int) -> int:
    """The int32 words of ``fire_timers``' scratch at ``R`` rows
    (``fire_timers_scratch_words`` of ``csrc/finish.cu``): a mark a row
    and the grid's arrival counter."""
    return R + 1


@functools.lru_cache(maxsize=None)
def _lib():
    """``fire_timers`` and ``wipe_rows`` of ``csrc/finish.cu``, built and
    loaded, and the library's error-string function, all typed."""
    lib = _build.load("finish")
    fire, wipe, err = lib.fire_timers, lib.wipe_rows, lib.finish_error
    fire.argtypes, fire.restype = _FIRE_ARGTYPES, _CI
    wipe.argtypes, wipe.restype = _WIPE_ARGTYPES, _CI
    err.argtypes, err.restype = [_CI], ctypes.c_char_p
    return fire, wipe, err


@functools.lru_cache(maxsize=None)
def _array(n: int):
    return _VP * n


def _checked(name: str, heard, rows_arg: torch.Tensor, rows_dtype):
    """The shards of ``heard`` after the checks both kernels share, their
    R, L, N and device."""
    shards = _shards(heard)
    ndev = len(shards)
    if not 1 <= ndev <= MAX_SHARDS:
        raise ValueError(f"{name} takes 1 to {MAX_SHARDS} shards, got {ndev}")
    require_cuda(name, shards[0])
    if shards[0].dim() != 2:
        raise ValueError(f"heard must be [R, N] or shards [R, L], got "
                         f"{list(shards[0].shape)}")
    R, L = shards[0].shape
    dev = shards[0].device
    for i, h in enumerate(shards):
        check_tensor(f"shard {i}", h, _U8, (R, L), dev)
    check_tensor("row argument", rows_arg, rows_dtype, (R,), dev)
    N = ndev * L
    if R > MAX_ROWS or N >= 2**31 - 16:
        raise ValueError(f"{name} takes R <= {MAX_ROWS} and N below "
                         f"2**31 - 16, got R={R}, N={N}")
    return shards, R, L, N, dev


def fire_timers(heard, rx_ok: torch.Tensor, ok_mask: torch.Tensor,
                refute=None, scratch: torch.Tensor | None = None
                ) -> torch.Tensor:
    """Launch ``fire_timers`` of ``csrc/finish.cu`` on CUDA tensors (the
    arguments of ``fire_timers_ref``: ``heard`` u8 [R, N] or 1 to
    ``MAX_SHARDS`` shards [R, L], written in place; ``rx_ok`` bool [N];
    ``ok_mask`` u8 [R]; ``refute`` None or (int32 [R] global columns in
    [0, N), u8 [R] bytes)): one launch for every shard.  ``scratch``: an
    int32 vector of at least ``scratch_words(R)`` zero words that no other
    launch uses meanwhile (``observe.counts_scratch`` of at least R rows
    serves), or None for a new one (refused during a capture, which would
    record its memset).  Returns a new bool [R] ``fired``.  Launches on
    the current stream and does not synchronise.  Raises on anything the
    kernel does not take."""
    global launches, fire_launches
    shards, R, L, N, dev = _checked("fire_timers", heard, ok_mask, _U8)
    check_tensor("rx_ok", rx_ok, torch.bool, (N,), dev)
    if refute is not None:
        check_tensor("refute column", refute[0], _I32, (R,), dev)
        check_tensor("refute byte", refute[1], _U8, (R,), dev)
    if scratch is not None and (
            scratch.dtype != _I32 or scratch.dim() != 1
            or scratch.device != dev or not scratch.is_contiguous()
            or scratch.numel() < scratch_words(R)):
        raise ValueError(f"scratch must be a contiguous int32 vector of at "
                         f"least {scratch_words(R)} words on {dev}, got "
                         f"{scratch.dtype}{list(scratch.shape)} on "
                         f"{scratch.device}")
    fn, _, err = _lib()  # built at the first launch; a failed build raises
    if R == 0:
        return torch.zeros((0,), dtype=torch.bool, device=dev)
    if scratch is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("fire_timers: pass a scratch under a capture")
        scratch = torch.zeros(scratch_words(R), dtype=_I32, device=dev)
    fired = torch.empty((R,), dtype=torch.bool, device=dev)
    table = _array(len(shards))(*(h.data_ptr() for h in shards))
    col, rb = (None, None) if refute is None else (refute[0].data_ptr(),
                                                   refute[1].data_ptr())
    _build.launch(fn, err, "fire_timers", dev, table, len(shards),
                  rx_ok.data_ptr(), ok_mask.data_ptr(), col, rb,
                  fired.data_ptr(), scratch.data_ptr(), R, L)
    launches += 1
    fire_launches += 1
    launch_shapes.add(("fire_timers", R, L, len(shards), refute is not None))
    return fired


def wipe_rows(heard, flags: torch.Tensor) -> None:
    """Launch ``wipe_rows`` of ``csrc/finish.cu`` on CUDA tensors: the rows
    of ``heard`` (u8 [R, N] or shards [R, L]) where ``flags`` (bool [R])
    is set become zero, in place, one launch for every shard.  Launches on
    the current stream and does not synchronise.  Raises on anything the
    kernel does not take."""
    global launches, wipe_launches
    shards, R, L, N, dev = _checked("wipe_rows", heard, flags, torch.bool)
    _, fn, err = _lib()
    if R == 0 or N == 0:
        return
    table = _array(len(shards))(*(h.data_ptr() for h in shards))
    _build.launch(fn, err, "wipe_rows", dev, table, len(shards),
                  flags.data_ptr(), R, L)
    launches += 1
    wipe_launches += 1
    launch_shapes.add(("wipe_rows", R, L, len(shards), False))


def fire(heard, rx_ok: torch.Tensor, ok_mask: torch.Tensor, refute=None,
         scratch: torch.Tensor | None = None) -> torch.Tensor:
    """The fire pass of the module docstring, in place: the kernel on CUDA
    tensors (``scratch`` as ``fire_timers`` takes it), its plain version on
    CPU tensors (which needs none).  Returns ``fired``."""
    if _shards(heard)[0].device.type == "cpu":
        return fire_timers_ref(heard, rx_ok, ok_mask, refute)
    return fire_timers(heard, rx_ok, ok_mask, refute, scratch)


def wipe(heard, flags: torch.Tensor):
    """The flagged rows of ``heard`` zeroed in place: the kernel on CUDA
    tensors, its plain version on CPU tensors.  Returns ``heard``."""
    if _shards(heard)[0].device.type == "cpu":
        wipe_rows_ref(heard, flags)
    else:
        wipe_rows(heard, flags)
    return heard
