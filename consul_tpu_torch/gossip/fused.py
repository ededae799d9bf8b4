"""The round's dense dissemination tail: the Hopper kernels and their
plain torch versions.

The reference runs this tail as one Pallas pass over the belief matrix
(``consul_tpu/gossip/fused.py::_fused_single``): age, ``fanout``
circulant pin deliveries, priority-max merge and Lifeguard confirmation
counting, all in one read and one write of ``heard [S, N]``.  Its port
is the hand-written CUDA kernel of ``csrc/dissem_tail.cu``, entry point
``fused_dissem``, wrapped here by ``fused_dissem``.

Sharded (``sc`` set, the reference's ``_fused_sharded`` after its halo
hop): ``heard`` is a tuple of ``[S, L]`` column shards and a pin crosses
shard boundaries.  The entry point ``fused_merge`` (wrapper
``fused_merge``) merges every shard in one launch, reading each pin
straight from the shard that holds it.  Both entry points run one kernel
body (a table of column shards; the single-device round is the table of
one) and one rule (``csrc/belief_merge.cuh``, four belief bytes to a
32-bit word); the sources state what they compute, their bound and
their design.

``disseminate_ref``, ``merge_ref`` and ``merge_shards_ref`` are the same
functions in plain torch, per byte on int32 lanes, exactly as the
reference's ``_age_u8``/``_merge`` spell them; ``merge_shards_ref`` is
the sharded tail as the reference composes it (``_roll_sharded`` into
pins, the rolled sender masks, ``merge_ref`` per shard).
``disseminate`` — what the round calls — takes the plain versions only
for CPU tensors; for CUDA tensors it launches the kernels or raises.
There is no fallback.

Under a partitioned nemesis scenario every function here takes a drop
operand: ``drop``, u8 or bool ``[F, N]`` by global destination column,
where a set byte kills leg ``f``'s delivery into that column (the
reference folds it into the sender masks, ``fused._src_masks``).
``None`` means no partition.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from consul_tpu_torch.gossip.kernel import (_AGE_FRESH, _AGE_MASK,
                                            _CONF_MASK, _CONF_SHIFT,
                                            _MSG_SHIFT, MSG_SUSPECT,
                                            _roll_sharded, _sloc,
                                            _sloc_roll)
from consul_tpu_torch.gossip.params import SwimParams
from consul_tpu_torch.ops.divisibility import require_divisible

MAX_FANOUT = 8   # kMaxFanout of csrc/dissem_tail.cu
MAX_SHARDS = 64  # kMaxShards: the shard table in the kernel's parameters
# The word rule's budget test is exact for these budgets only
# (csrc/belief_merge.cuh); SwimParams.spread_budget_rounds stays inside.
BUDGET_RANGE = (1, 14)

# Kernel launches made by ``fused_dissem`` (one per launch, nowhere else).
launches = 0
# Kernel launches made by ``fused_merge`` (one per launch, nowhere else).
merge_launches = 0
# Of those, the launches given a drop operand (``fused_dissem``,
# ``fused_merge``).
drop_launches = 0
merge_drop_launches = 0
# (kernel, S, L, ndev, F, budget) of every launch of either kernel, so a
# smoke run can hold each shape its paths launched at against the plain
# version (``chip_smoke.py``).
launch_shapes: set = set()


def _age_u8(x: torch.Tensor) -> torch.Tensor:
    """``_age_tick`` semantics on int32 lanes each holding one belief
    byte: fresh marks become age 0, real ages saturate at 14,
    message-free bytes are untouched."""
    age = x & _AGE_MASK
    new_age = torch.where(age == _AGE_FRESH, 0,
                          torch.clamp(age + 1, max=_AGE_MASK - 1))
    return torch.where((x >> _MSG_SHIFT) > 0, (x & ~_AGE_MASK) | new_age, x)


def _merge(p: SwimParams, cur, pins, srcs, rx, cap) -> torch.Tensor:
    """Priority-max merge + Lifeguard confirmation counting on int32
    lanes (the reference's ``fused._merge``).  ``cur``/``pins`` are
    already aged; ``srcs``/``rx`` are bool masks over columns; ``cap``
    broadcasts per slot row."""
    budget = p.spread_budget_rounds
    in_msg = torch.zeros_like(cur)
    n_sus = torch.zeros_like(cur)
    for pin, src in zip(pins, srcs):
        live = ((pin & _AGE_MASK) < budget) & src
        m = torch.where(live, pin >> _MSG_SHIFT, 0)
        in_msg = torch.maximum(in_msg, m)
        n_sus = n_sus + (m == MSG_SUSPECT).to(torch.int32)
    cur_msg = cur >> _MSG_SHIFT
    age_c = cur & _AGE_MASK
    conf = (cur >> _CONF_SHIFT) & _CONF_MASK
    upgraded = (in_msg > cur_msg) & rx
    bump = (cur_msg == MSG_SUSPECT) & (in_msg == MSG_SUSPECT) & rx
    conf_new = torch.where(bump, torch.minimum(conf + n_sus, cap), conf)
    # A rising confirmation count refreshes the spread window (memberlist
    # re-enqueues a suspicion heard at a higher count).
    conf_rose = conf_new > conf
    out_msg = torch.where(upgraded, in_msg, cur_msg)
    out_age = torch.where(upgraded | conf_rose, 0, age_c)
    out_conf = torch.where(upgraded, 0, conf_new)
    return (out_msg << _MSG_SHIFT) | (out_conf << _CONF_SHIFT) | out_age


def _live(live: torch.Tensor, drop, f: int) -> torch.Tensor:
    """Leg ``f``'s sender mask less its dropped columns."""
    return live if drop is None else live & (drop[f] == 0)


def disseminate_ref(p: SwimParams, rnd: int, offs, heard: torch.Tensor,
                    mf: torch.Tensor, rx_ok: torch.Tensor,
                    conf_cap: torch.Tensor, drop=None) -> torch.Tensor:
    """The plain torch version of the kernel, on any device.

    ``offs``: the round's ``fanout`` gossip shifts (host ints); the
    sender into column ``c`` on leg ``f`` is ``c - offs[f]``.  ``drop``:
    the partition's drop operand (module docstring) or None."""
    h = heard.to(torch.int32)
    pins = [_age_u8(torch.roll(h, o, dims=1)) for o in offs]
    srcs = [_live(torch.roll(mf, o) > rnd, drop, f)[None, :]
            for f, o in enumerate(offs)]
    out = _merge(p, _age_u8(h), pins, srcs, rx_ok[None, :],
                 conf_cap.to(torch.int32)[:, None])
    return out.to(torch.uint8)


def merge_ref(p: SwimParams, cur: torch.Tensor, pins: torch.Tensor,
              src: torch.Tensor, rx: torch.Tensor,
              cap: torch.Tensor, drop=None) -> torch.Tensor:
    """The reference's ``_fused_sharded`` body on one shard, in plain
    torch, on any device.  ``cur`` u8 [S, L]; ``pins`` u8 [F, S, L],
    aligned with ``cur``; ``src`` bool [F, L], the live senders of each
    leg; ``rx`` bool [L]; ``cap`` i32 [S]; ``drop`` None or [F, L], this
    shard's columns of the drop operand."""
    out = _merge(p, _age_u8(cur.to(torch.int32)),
                 [_age_u8(pin.to(torch.int32)) for pin in pins],
                 [_live(s, drop, f)[None, :] for f, s in enumerate(src)],
                 rx[None, :],
                 cap.to(torch.int32)[:, None])
    return out.to(torch.uint8)


def merge_shards_ref(p: SwimParams, rnd: int, offs, heard, mf: torch.Tensor,
                     rx_ok: torch.Tensor, conf_cap: torch.Tensor, sc,
                     drop=None):
    """The plain torch version of ``fused_merge``, on any device: the
    reference's sharded tail.  The halo hop rolls each leg's pins into a
    [F, S, L] buffer per shard, the rolled ``mf > rnd`` gives each leg's
    live senders, and ``merge_ref`` merges each shard; ``drop`` is the
    global [F, N] operand, each shard taking its own columns."""
    S, L = heard[0].shape
    pins = [h.new_empty((len(offs), S, L)) for h in heard]
    for f, o in enumerate(offs):
        _roll_sharded(sc, heard, o, out=[pin[f] for pin in pins])
    return tuple(
        merge_ref(p, h, pins[i],
                  torch.stack([_sloc_roll(sc, mf, o, i) > rnd for o in offs]),
                  _sloc(sc, rx_ok, i), conf_cap,
                  None if drop is None else drop[:, i * L:(i + 1) * L])
        for i, h in enumerate(heard))


_VP, _CI = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _array(ctype, n: int):
    """The ctypes array type of ``n`` ``ctype``s (built once)."""
    return ctype * n


_ARGTYPES = {  # C entry point -> its argument types (pointers, ints, stream)
    "fused_dissem": [_VP] * 6 + [_CI] * 3 + [ctypes.POINTER(_CI)]
                    + [_CI] * 2 + [_VP],
    "fused_merge": [ctypes.POINTER(_VP), _CI] + [_VP] * 5 + [_CI] * 3
                   + [ctypes.POINTER(_CI)] + [_CI] * 4 + [_VP],
}


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The entry point ``<name>`` of ``csrc/dissem_tail.cu``, built and
    loaded, and the library's error-string function, both typed."""
    from consul_tpu_torch import _build
    lib = _build.load("dissem_tail")
    fn, err = getattr(lib, name), lib.dissem_tail_error
    fn.argtypes, fn.restype = _ARGTYPES[name], _CI
    err.argtypes, err.restype = [_CI], ctypes.c_char_p
    return fn, err


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call ``<name>`` on the current stream of ``dev`` (its raw handle,
    without building a ``torch.cuda.Stream``); raise if the launch was
    refused.  Switches the current device only when ``dev`` is not
    already current."""
    fn, err = _lib(name)
    raw_stream = torch._C._cuda_getCurrentRawStream
    if torch.cuda.current_device() == dev.index:
        rc = fn(*args, raw_stream(dev.index))
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, raw_stream(dev.index))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: {err(rc).decode()}")


def _require_cuda(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} launches on a CUDA tensor, got {t.device}")


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {dtype}{list(shape)} on {device}, "
                         f"got {t.dtype}{list(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_legs(offs, budget: int) -> None:
    if not 1 <= len(offs) <= MAX_FANOUT:
        raise ValueError(f"fanout must be in [1, {MAX_FANOUT}], "
                         f"got {len(offs)}")
    lo, hi = BUDGET_RANGE
    if not lo <= budget <= hi:
        raise ValueError(f"budget must be in [{lo}, {hi}], got {budget}")


def _drop_ptr(drop, F: int, N: int, device) -> int | None:
    """The drop operand's address for the kernel (None for no operand):
    a contiguous u8 or bool [F, N] tensor on ``device``."""
    if drop is None:
        return None
    if drop.dtype == torch.bool:
        drop = drop.view(torch.uint8)
    _check("drop", drop, torch.uint8, (F, N), device)
    return drop.data_ptr()


def fused_dissem(heard: torch.Tensor, offs, mf: torch.Tensor,
                 rx_ok: torch.Tensor, conf_cap: torch.Tensor, rnd: int,
                 budget: int, drop=None) -> torch.Tensor:
    """Launch ``fused_dissem`` of ``csrc/dissem_tail.cu`` on CUDA
    tensors (the arguments of ``disseminate_ref``; caps >= 0; ``drop``
    None or u8/bool [F, N]); returns a new ``[S, N]`` u8 tensor.  Launches
    on the current stream and does not synchronise.  Raises on anything
    the kernel does not take."""
    global launches, drop_launches
    _require_cuda("fused_dissem", heard)
    if heard.dim() != 2 or heard.dtype != torch.uint8:
        raise ValueError(f"heard must be u8 [S, N], got {heard.dtype}"
                         f"{list(heard.shape)}")
    S, N = heard.shape
    dev = heard.device
    _check("heard", heard, torch.uint8, (S, N), dev)
    _check("mf", mf, torch.int32, (N,), dev)
    _check("rx_ok", rx_ok, torch.bool, (N,), dev)
    _check("conf_cap", conf_cap, torch.int32, (S,), dev)
    budget = int(budget)
    _check_legs(offs, budget)
    drop_p = _drop_ptr(drop, len(offs), N, dev)
    out = torch.empty_like(heard)
    if heard.numel() == 0:
        return out
    c_offs = _array(_CI, len(offs))(*(int(o) % N for o in offs))
    _launch("fused_dissem", dev, heard.data_ptr(), out.data_ptr(),
            mf.data_ptr(), rx_ok.data_ptr(), conf_cap.data_ptr(), drop_p, S,
            N, len(offs), c_offs, int(rnd), budget)
    launches += 1
    drop_launches += drop_p is not None
    launch_shapes.add(("fused_dissem", S, N, 1, len(offs), budget))
    return out


def fused_merge(heard, offs, mf: torch.Tensor, rx_ok: torch.Tensor,
                conf_cap: torch.Tensor, rnd: int, budget: int, drop=None):
    """Launch ``fused_merge`` of ``csrc/dissem_tail.cu`` on a tuple of
    CUDA shards (the arguments of ``merge_shards_ref`` but ``p`` and
    ``sc``: ``heard`` is ``ndev`` u8 [S, L] shards, ``mf``/``rx_ok`` the
    global [N] vectors, caps >= 0, ``drop`` None or the global u8/bool
    [F, N] operand): every shard in one launch.  Returns the tuple of the
    merged shards, views ``out[i]`` of one new [ndev, S, L] buffer.
    Launches on the current stream and does not synchronise.  Raises on
    anything the kernel does not take."""
    global merge_launches, merge_drop_launches
    ndev = len(heard)
    if not 1 <= ndev <= MAX_SHARDS:
        raise ValueError(f"fused_merge takes 1 to {MAX_SHARDS} shards, "
                         f"got {ndev}")
    _require_cuda("fused_merge", heard[0])
    if heard[0].dim() != 2:
        raise ValueError(f"each shard must be [S, L], got "
                         f"{list(heard[0].shape)}")
    S, L = heard[0].shape
    N = ndev * L
    dev = heard[0].device
    if N >= 2**31 - 16:
        raise ValueError(f"ndev * L must be below 2**31 - 16, got {N}")
    for i, h in enumerate(heard):
        _check(f"shard {i}", h, torch.uint8, (S, L), dev)
    _check("mf", mf, torch.int32, (N,), dev)
    _check("rx_ok", rx_ok, torch.bool, (N,), dev)
    _check("conf_cap", conf_cap, torch.int32, (S,), dev)
    budget = int(budget)
    _check_legs(offs, budget)
    drop_p = _drop_ptr(drop, len(offs), N, dev)
    out = torch.empty((ndev, S, L), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out.unbind(0)
    table = _array(_VP, ndev)(*(h.data_ptr() for h in heard))
    c_offs = _array(_CI, len(offs))(*(int(o) % N for o in offs))
    _launch("fused_merge", dev, table, ndev, out.data_ptr(), mf.data_ptr(),
            rx_ok.data_ptr(), conf_cap.data_ptr(), drop_p, S, L, len(offs),
            c_offs, int(rnd), budget, 0, ndev)
    merge_launches += 1
    merge_drop_launches += drop_p is not None
    launch_shapes.add(("fused_merge", S, L, ndev, len(offs), budget))
    return out.unbind(0)


def _disseminate_sharded(p: SwimParams, rnd: int, offs, heard, mf, rx_ok,
                         conf_cap, sc, drop):
    """The reference's ``_fused_sharded`` with its halo hop: one launch
    for all shards on CUDA tensors, the plain composition on CPU
    tensors."""
    if heard[0].device.type == "cpu":
        return merge_shards_ref(p, rnd, offs, heard, mf, rx_ok, conf_cap, sc,
                                drop)
    return fused_merge(heard, offs, mf, rx_ok, conf_cap, rnd,
                       p.spread_budget_rounds, drop)


def disseminate(p: SwimParams, rnd: int, offs, heard, mf: torch.Tensor,
                rx_ok: torch.Tensor, conf_cap: torch.Tensor, sc=None,
                drop=None):
    """The round's dense tail (reference ``fused_disseminate``): the
    kernels on CUDA tensors, the plain versions on CPU tensors.
    Sharded (``sc``), ``heard`` is the tuple of shards and so is the
    result.  ``drop``: the partition's drop operand, or None."""
    if sc is not None:
        # No fused_nb check: the reference makes it only in
        # _fused_single, so the sharded round takes any fused_nb.
        return _disseminate_sharded(p, rnd, offs, heard, mf, rx_ok,
                                    conf_cap, sc, drop)
    if p.dissem == "fused":
        # The reference's grid contract (fused.py:146); the kernel here
        # tiles on its own, but the same configurations are refused.
        require_divisible(heard.shape[1], p.fused_nb, what="n",
                          by="fused_nb")
    if heard.device.type == "cpu":
        return disseminate_ref(p, rnd, offs, heard, mf, rx_ok, conf_cap,
                               drop)
    return fused_dissem(heard, offs, mf, rx_ok, conf_cap, rnd,
                        p.spread_budget_rounds, drop)
