"""A bit-exact twin of the ``jax.random`` calls the SWIM round makes.

The reference draws every random number of a round from ``jax.random``
under this configuration: the ``threefry2x32`` implementation,
``jax_threefry_partitionable=True`` and 64-bit mode off.  This module
reproduces those draws bit for bit, so the port's round under the same
key takes the same decisions as the reference's:

- ``key``/``PRNGKey``: ``threefry_seed`` — ``[seed >> 32, seed & 0xFFFFFFFF]``
  of an int32 seed, i.e. ``[0, seed]`` for a non-negative one;
- ``fold_in``: ``threefry_2x32(key, [0, data])``;
- ``split``: the partitionable fold-like split, counters from the
  flattened iota of the output shape (hi word 0, lo word the index);
- ``random_bits`` (32-bit): the same counters, result ``bits1 ^ bits2``;
- ``uniform`` (float32 in [0, 1)): the top 23 bits as the mantissa of a
  float in [1, 2), minus 1;
- ``randint`` (int32): two 32-bit draws from ``split(key)``, reduced by
  the span/multiplier rule of ``jax.random.randint``.

A key is a host ``numpy.uint32[2]`` (``jax.random.key_data(key)`` of the
reference).  Key derivation and the small draws (gossip offsets, probe
offsets) run on the host in Python integers: they are a handful of
scalars per round and the round needs them as host integers anyway (they
are roll shifts and slice starts), so no device→host read is spent on
them.

The large draws (one uniform per prober, the nemesis drop masks, the
Feistel targets) are device draws — the reference computes them in XLA,
outside any Pallas kernel.  Each public device draw (``random_bits_tensor``,
``uniform_tensor``, ``uniform_rows``, ``randint_tensor``, ``below``,
``edge_drops``) takes its plain torch version (``random_bits_ref``,
``uniform_ref``, ``uniform_rows_ref``, ``randint_ref``, ``below_ref``,
``edge_drops_ref``) on the CPU, and on a CUDA device launches one kernel
of ``csrc/threefry.cu`` or raises: there is no fallback.  A key is a host
key, which travels by value in the launch's parameters (a draw copies
nothing to the device and never synchronises), or a device key: an int32
tensor of the two words (the uint32 bit patterns), ``[2]`` or ``[rows,
2]``, which the kernel reads from device memory when it runs.  The round
takes its keys, and the edge drops their shifts, from its row of
``gossip/round_args.py``'s table that way, so one captured launch serves
every round (``gossip/program.py``); the plain versions take the same
tensors.  The plain versions carry all 32-bit
unsigned arithmetic in signed 64-bit values masked to 32 bits: torch's
``uint32`` does not support add, shifts or compares on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (jax ``_threefry2x32_lowering``).

    Operands are non-negative values below 2**32 carried in any type
    with 64-bit integer ``+ ^ << >> &``: Python ints on the host, int64
    tensors on a device.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _M32
    x1 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _key_words(key) -> tuple:
    """A key's two words: host ints, or for a device key (int32 tensor
    ``[..., 2]``) int64 tensors in [0, 2**32) (the plain versions' form)."""
    if isinstance(key, torch.Tensor):
        w = key.to(torch.int64) & _M32
        return w[..., 0], w[..., 1]
    k = np.asarray(key)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"a key is uint32[2], got {k.dtype}{list(k.shape)}")
    return int(k[0]), int(k[1])


def _as_key(k1: int, k2: int) -> np.ndarray:
    return np.asarray([k1, k2], dtype=np.uint32)


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` for an int32 seed."""
    seed = int(seed)
    if not -2**31 <= seed < 2**31:
        raise OverflowError(f"seed {seed} does not fit int32")
    # threefry_seed of an int32: the logical shift by 32 is 0, the low
    # word is the seed's bit pattern.
    return _as_key(0, seed & _M32)


PRNGKey = key


def fold_in(k, data: int) -> np.ndarray:
    """``jax.random.fold_in(k, data)``: hash the pair ``[0, data]``."""
    k1, k2 = _key_words(k)
    return _as_key(*_threefry2x32(k1, k2, 0, int(data) & _M32))


def split(k, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)`` as ``uint32[num, 2]``."""
    k1, k2 = _key_words(k)
    out = [_threefry2x32(k1, k2, 0, i) for i in range(num)]
    return np.asarray(out, dtype=np.uint32).reshape(num, 2)


def _bits_host(k, shape) -> list[int]:
    k1, k2 = _key_words(k)
    return [a ^ b for a, b in
            (_threefry2x32(k1, k2, 0, i) for i in range(math.prod(shape)))]


def random_bits(k, shape=()) -> np.ndarray:
    """``jax.random.bits(k, shape, uint32)`` on the host."""
    shape = tuple(shape)
    return np.asarray(_bits_host(k, shape), dtype=np.uint32).reshape(shape)


def _to_unit_float(bits: np.ndarray) -> np.ndarray:
    mant = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).astype(np.uint32)
    return mant.view(np.float32) - np.float32(1.0)


def uniform(k, shape=()) -> np.ndarray:
    """``jax.random.uniform(k, shape)`` (float32, [0, 1)) on the host."""
    return _to_unit_float(random_bits(k, shape))


def _randint_span(minval: int, maxval: int) -> tuple[int, int]:
    """jax.random.randint's span and multiplier for int32 bounds."""
    for v in (minval, maxval):
        if not -2**31 <= v < 2**31:
            raise OverflowError(f"randint bound {v} does not fit int32")
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    # jax's multiplier (2**16 % span)**2 % span, with the square taken
    # in uint32 — it wraps, as it does there.
    mult = (2**16) % span
    return span, ((mult * mult) & _M32) % span


def randint(k, shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(k, shape, minval, maxval, int32)`` on the host."""
    shape = tuple(shape)
    minval, maxval = int(minval), int(maxval)
    span, mult = _randint_span(minval, maxval)
    k_hi, k_lo = split(k, 2)
    higher, lower = _bits_host(k_hi, shape), _bits_host(k_lo, shape)
    out = []
    for hi, lo in zip(higher, lower):
        off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
        v = (minval + off % span) & _M32
        out.append(v - 2**32 if v >= 2**31 else v)
    return np.asarray(out, dtype=np.int32).reshape(shape)


# -- device draws --------------------------------------------------------------

# Kernel launches made by the device draws (one per launch of a
# ``csrc/threefry.cu`` entry point, nowhere else), and the device draws
# asked of the public functions on any device: on a card every draw is one
# launch, so there the two move together.
launches = 0
calls = 0
# (entry point, shape, and what else sets the launch) of every launch, so a
# smoke run can hold each shape its paths launched at against the plain
# version (``chip_smoke.py``); an edge-drops launch names its group vector
# by ``id``, and ``launch_groups`` holds that vector (the round's come from
# a cache, so there are a few).
launch_shapes: set = set()
launch_groups: dict = {}
# A list while a caller records the draws (None otherwise): per draw asked
# for, its kind, shape and what the kernel takes by value.  A device key or
# shift is logged as "dev": a replayed graph reads it when it runs.
launch_log: list | None = None


def _log(*entry) -> None:
    if launch_log is not None:
        launch_log.append(entry)


def _by_value(x):
    """How a key or shift list reaches the kernel, for ``launch_log``."""
    if isinstance(x, torch.Tensor):
        return "dev"
    return tuple(int(v) for v in np.asarray(x).reshape(-1))


MAX_ROWS = 16          # kMaxRows of csrc/threefry.cu: keys of one launch
MAX_COUNTERS = 2**32   # counters 0 .. 2**32 - 1: the high word stays 0


def random_bits_ref(k, shape, device) -> torch.Tensor:
    """The plain version of ``random_bits_tensor``: int64 values in
    [0, 2**32), on any device."""
    k1, k2 = _key_words(k)
    shape = tuple(shape)
    lo = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(k1, k2, 0, lo)
    return (b1 ^ b2).reshape(shape)


def mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """The low 32 bits of ``a * b`` for int64 ``a`` in [0, 2**32) and a
    host ``b`` in [0, 2**32): the uint32 product, computed in two halves
    so that no int64 product overflows."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def randint_ref(k, shape, minval: int, maxval: int,
                device) -> torch.Tensor:
    """The plain version of ``randint_tensor`` (int32), on any device."""
    shape = tuple(shape)
    minval, maxval = int(minval), int(maxval)
    span, mult = _randint_span(minval, maxval)
    k_hi, k_lo = split(k, 2)
    higher = random_bits_ref(k_hi, shape, device)
    lower = random_bits_ref(k_lo, shape, device)
    off = (mul32(higher % span, mult) + lower % span) & _M32
    v = (minval + off % span) & _M32
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def _unit_float(bits: torch.Tensor) -> torch.Tensor:
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def uniform_ref(k, shape, device) -> torch.Tensor:
    """The plain version of ``uniform_tensor`` (float32), on any device."""
    return _unit_float(random_bits_ref(k, shape, device))


def uniform_rows_ref(keys, n: int, device) -> torch.Tensor:
    """The plain version of ``uniform_rows``, on any device, in one pass
    of the threefry ops (the keys ride a broadcast dimension)."""
    lo = torch.arange(n, dtype=torch.int64, device=device)
    if isinstance(keys, torch.Tensor):
        k1, k2 = (w[:, None] for w in _key_words(keys.view(-1, 2)))
    else:
        words = [_key_words(k) for k in keys]
        # Fills on the device, not a host->device copy (which would
        # synchronise the stream).
        k1, k2 = (torch.cat([lo.new_full((1, 1), w[i]) for w in words])
                  for i in (0, 1))
    b1, b2 = _threefry2x32(k1, k2, 0, lo)
    return _unit_float(b1 ^ b2)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as jax rounds a weakly typed constant
    compared with a float32 draw."""
    return float(np.float32(x))


def below_ref(k, shape, p: float, device) -> torch.Tensor:
    """The plain version of ``below``, on any device."""
    return uniform_ref(k, shape, device) < _f32(p)


def edge_drops_ref(keys, grp: torch.Tensor, shifts, p_ab: float,
                   p_ba: float) -> torch.Tensor:
    """The plain version of ``edge_drops``, on ``grp``'s device: the
    rolled group stack, and one ``uniform_rows_ref`` pass where an edge's
    outcome is not certain."""
    n = grp.shape[0]
    if isinstance(shifts, torch.Tensor):
        # Device shifts: the rolls as one gather, sender d - o (mod n).
        src = torch.arange(n, device=grp.device)[None, :] - shifts[:, None]
        g_src = grp[src.remainder(n)]
    else:
        g_src = torch.stack([torch.roll(grp, o) for o in shifts])
    cross = g_src != grp
    p_ab, p_ba = _f32(p_ab), _f32(p_ba)
    if all(q <= 0.0 or q >= 1.0 for q in (p_ab, p_ba)):
        # Certain: every cross edge of a direction drops, or none does.
        if (p_ab >= 1.0) == (p_ba >= 1.0):
            return cross if p_ab >= 1.0 else torch.zeros_like(cross)
        return cross & ((g_src == 0) == (p_ab >= 1.0))
    p_edge = torch.where(g_src == 0, p_ab, p_ba)
    return cross & (uniform_rows_ref(keys, n, grp.device) < p_edge)


_U32, _U64, _CI, _VP = (ctypes.c_uint32, ctypes.c_uint64, ctypes.c_int,
                        ctypes.c_void_p)
_ARGTYPES = {  # C entry point -> its argument types (..., out, stream)
    "threefry_bits": [_U32, _U32, _U64, _VP, _VP],
    "threefry_uniform": [ctypes.POINTER(_U32), _CI, _U64, _VP, _VP],
    "threefry_below": [_U32, _U32, _U64, ctypes.c_float, _VP, _VP],
    "threefry_randint": [_U32] * 4 + [_U64, ctypes.c_int32, _U32, _U32, _VP,
                                      _VP],
    "threefry_edge_drops": [ctypes.POINTER(_U32),
                            ctypes.POINTER(ctypes.c_int64), _CI, _U64, _VP,
                            ctypes.c_float, ctypes.c_float, _VP, _VP],
    "threefry_uniform_dev": [_VP, _CI, _U64, _VP, _VP],
    "threefry_below_dev": [_VP, _U64, ctypes.c_float, _VP, _VP],
    "threefry_edge_drops_dev": [_VP, _VP, _CI, _U64, _VP, ctypes.c_float,
                                ctypes.c_float, _VP, _VP],
}


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The entry point ``<name>`` of ``csrc/threefry.cu``, built and
    loaded, and the library's error-string function, both typed."""
    from consul_tpu_torch import _build
    lib = _build.load("threefry")
    fn, err = getattr(lib, name), lib.threefry_error
    fn.argtypes, fn.restype = _ARGTYPES[name], _CI
    err.argtypes, err.restype = [_CI], ctypes.c_char_p
    return fn, err


def _launch(name: str, out: torch.Tensor, *args) -> None:
    """Launch ``<name>`` writing ``out`` on the current stream of its
    device; raise if the launch was refused."""
    global launches
    from consul_tpu_torch import _build
    _build.launch(*_lib(name), name, out.device, *args, out.data_ptr())
    launches += 1


def _device_words(name: str, t: torch.Tensor, rows: int, width: int,
                  device) -> int:
    """The address of a device argument: a contiguous int32 tensor of
    ``rows * width`` words on ``device``."""
    if t.dtype != torch.int32 or t.numel() != rows * width \
            or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 tensor of "
                         f"{rows * width} words on {device}, got {t.dtype}"
                         f"{list(t.shape)} on {t.device}")
    return t.data_ptr()


def _key_array(keys):
    """Row keys as the kernel's ``uint32[2 * rows]`` host array."""
    if not 1 <= len(keys) <= MAX_ROWS:
        raise ValueError(f"a draw takes 1 to {MAX_ROWS} row keys, "
                         f"got {len(keys)}")
    words = [w for k in keys for w in _key_words(k)]
    return (_U32 * len(words))(*words)


def _bits_into(out: torch.Tensor, k) -> None:
    """``out``: int64, any shape."""
    _launch("threefry_bits", out, *_key_words(k), out.numel())
    launch_shapes.add(("bits", tuple(out.shape)))


def _uniform_into(out: torch.Tensor, keys) -> None:
    """``out``: float32 [rows, n] (or any shape, one key)."""
    if isinstance(keys, torch.Tensor):
        rows = keys.numel() // 2
        if not 1 <= rows <= MAX_ROWS:
            raise ValueError(f"a draw takes 1 to {MAX_ROWS} row keys, "
                             f"got {rows}")
        _launch("threefry_uniform_dev", out,
                _device_words("keys", keys, rows, 2, out.device), rows,
                out.numel() // rows)
    else:
        rows = len(keys)
        _launch("threefry_uniform", out, _key_array(keys), rows,
                out.numel() // rows)
    launch_shapes.add(("uniform", tuple(out.shape), rows))


def _below_into(out: torch.Tensor, k, p: float) -> None:
    if isinstance(k, torch.Tensor):
        _launch("threefry_below_dev", out,
                _device_words("key", k, 1, 2, out.device), out.numel(),
                _f32(p))
    else:
        _launch("threefry_below", out, *_key_words(k), out.numel(), _f32(p))
    launch_shapes.add(("below", tuple(out.shape), _f32(p)))


def _randint_into(out: torch.Tensor, k, minval: int, maxval: int) -> None:
    span, mult = _randint_span(minval, maxval)
    (hi0, hi1), (lo0, lo1) = (_key_words(sub) for sub in split(k, 2))
    _launch("threefry_randint", out, hi0, hi1, lo0, lo1, out.numel(), minval,
            span, mult)
    launch_shapes.add(("randint", tuple(out.shape), minval, maxval))


def _edge_drops_into(out: torch.Tensor, keys, grp: torch.Tensor, shifts,
                     p_ab: float, p_ba: float) -> None:
    rows, n = out.shape
    if isinstance(keys, torch.Tensor):
        if rows > MAX_ROWS:
            raise ValueError(f"a draw takes 1 to {MAX_ROWS} row keys, "
                             f"got {rows}")
        _launch("threefry_edge_drops_dev", out,
                _device_words("keys", keys, rows, 2, out.device),
                _device_words("shifts", shifts, rows, 1, out.device), rows,
                n, grp.data_ptr(), _f32(p_ab), _f32(p_ba))
    else:
        c_shifts = (ctypes.c_int64 * rows)(*(int(o) % n for o in shifts))
        _launch("threefry_edge_drops", out, _key_array(keys), c_shifts,
                rows, n, grp.data_ptr(), _f32(p_ab), _f32(p_ba))
    launch_groups[id(grp)] = grp
    launch_shapes.add(("edge_drops", (rows, n), _f32(p_ab), _f32(p_ba),
                       id(grp)))


def _draw_device(device, numel: int) -> torch.device:
    """The device of a draw of ``numel`` elements; counts the draw.  The
    CPU takes the plain version; a CUDA device takes the kernel, so it
    must be there: a missing card raises here, never falls back."""
    global calls
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the draws run on the CPU or a CUDA card, "
                         f"got {dev}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"a draw on {dev} needs a CUDA card: the "
                           f"threefry kernel has no CPU fallback")
    if numel > MAX_COUNTERS:
        raise ValueError(f"a draw of {numel} elements needs counters above "
                         f"2**32")
    calls += numel > 0
    return dev


def random_bits_tensor(k, shape, device) -> torch.Tensor:
    """``random_bits`` computed on ``device``: int64 values in [0, 2**32)."""
    shape = tuple(shape)
    dev = _draw_device(device, math.prod(shape))
    if dev.type == "cpu":
        return random_bits_ref(k, shape, dev)
    out = torch.empty(shape, dtype=torch.int64, device=dev)
    if out.numel():
        _bits_into(out, k)
    return out


def randint_tensor(k, shape, minval: int, maxval: int,
                   device) -> torch.Tensor:
    """``randint`` computed on ``device`` (int32, bit-identical)."""
    shape = tuple(shape)
    minval, maxval = int(minval), int(maxval)
    dev = _draw_device(device, math.prod(shape))
    if dev.type == "cpu":
        return randint_ref(k, shape, minval, maxval, dev)
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    if out.numel():
        _randint_into(out, k, minval, maxval)
    return out


def uniform_tensor(k, shape, device) -> torch.Tensor:
    """``uniform`` computed on ``device`` (float32, bit-identical); ``k``
    a host key or a device key ``[2]``."""
    shape = tuple(shape)
    dev = _draw_device(device, math.prod(shape))
    _log("uniform", shape, _by_value(k))
    if dev.type == "cpu":
        return uniform_ref(k, shape, dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel():
        _uniform_into(out, k.view(1, 2) if isinstance(k, torch.Tensor)
                      else [k])
    return out


def uniform_rows(keys, n: int, device) -> torch.Tensor:
    """``[uniform(k, (n,)) for k in keys]`` stacked into one float32
    ``[len(keys), n]`` tensor, bit-identical: on a card one launch for all
    the keys (at most ``MAX_ROWS``)."""
    dev = _draw_device(device, n)
    if dev.type == "cpu":
        return uniform_rows_ref(keys, n, dev)
    out = torch.empty((len(keys), n), dtype=torch.float32, device=dev)
    if out.numel():
        _uniform_into(out, keys)
    return out


def below(k, shape, p: float, device) -> torch.Tensor:
    """``uniform(k, shape) < p`` as a bool mask, ``p`` rounded to float32
    first (as jax rounds the constant); on a card the compare happens in
    the kernel, so the uniforms are never stored."""
    shape = tuple(shape)
    dev = _draw_device(device, math.prod(shape))
    _log("below", shape, _f32(p), _by_value(k))
    if dev.type == "cpu":
        return below_ref(k, shape, p, dev)
    out = torch.empty(shape, dtype=torch.bool, device=dev)
    if out.numel():
        _below_into(out, k, p)
    return out


def edge_drops(keys, grp: torch.Tensor, shifts, p_ab: float,
               p_ba: float) -> torch.Tensor:
    """A nemesis partition's drop mask, bool ``[len(shifts), n]`` on
    ``grp``'s device: a message into destination ``d`` along shift
    ``shifts[f]`` (sender ``d - shifts[f]``, mod n) is dropped where the
    sender's group (``grp``, int32 [n]) differs from ``d``'s and
    ``uniform(keys[f], (n,))[d]`` is below the sender's direction's
    probability (``p_ab`` from group 0, ``p_ba`` from the other).  On a
    card one launch for all legs, with no rolled group stack.  ``keys``
    and ``shifts`` are host values, or device tensors (int32 ``[legs, 2]``
    and ``[legs]``) that the kernel reads when it runs."""
    n = grp.shape[0]
    if len(keys) != len(shifts):
        raise ValueError(f"{len(keys)} keys for {len(shifts)} legs")
    dev = _draw_device(grp.device, n)
    _log("edge_drops", len(shifts), n, _f32(p_ab), _f32(p_ba),
         _by_value(keys), _by_value(shifts))
    if dev.type == "cpu":
        return edge_drops_ref(keys, grp, shifts, p_ab, p_ba)
    if grp.dtype != torch.int32 or grp.dim() != 1 \
            or not grp.is_contiguous():
        raise ValueError(f"grp must be a contiguous int32 [n], got "
                         f"{grp.dtype}{list(grp.shape)}")
    out = torch.empty((len(shifts), n), dtype=torch.bool, device=dev)
    if out.numel():
        _edge_drops_into(out, keys, grp, shifts, p_ab, p_ba)
    return out
