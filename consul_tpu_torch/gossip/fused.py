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

The round number ``rnd`` and the shifts ``offs`` are device tensors:
``rnd`` an int32 scalar and ``offs`` int32 ``[F]``, lying back to back as
``[rnd, o_0 .. o_F-1]`` (the round's ``RoundArgs.rnd`` and ``.gossip``,
``gossip/round_args.py``; ``tail_args`` makes such a pair).  The kernels
read them from device memory when they run, so one captured launch serves
every round of a replayed CUDA graph; the plain versions take the same
tensors (their rolls are gathers).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from consul_tpu_torch import _build
from consul_tpu_torch._device import check_tensor, require_cuda
from consul_tpu_torch.gossip.kernel import (_AGE_FRESH, _AGE_MASK,
                                            _CONF_MASK, _CONF_SHIFT,
                                            _MSG_SHIFT, MSG_SUSPECT, _roll,
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
# A list while a caller records the tails (None otherwise): per tail asked
# for, the kernel, its shape and its by-value arguments, whether it has a
# drop operand (the round and the shifts are read from device memory).
launch_log: list | None = None


def _log(name: str, S: int, L: int, ndev: int, offs, budget: int,
         drop) -> None:
    if launch_log is not None:
        launch_log.append((name, S, L, ndev, len(offs), budget,
                           drop is None))


def tail_args(rnd: int, offs, device) -> tuple:
    """``(rnd, offs)`` as the tail takes them: views of one new int32
    buffer ``[rnd, o_0 .. o_F-1]`` on ``device``, for a caller outside the
    round (the round passes its table row)."""
    buf = torch.tensor([int(rnd), *(int(o) for o in offs)],
                       dtype=torch.int32, device=device)
    return buf[0], buf[1:]


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


def disseminate_ref(p: SwimParams, rnd, offs, heard: torch.Tensor,
                    mf: torch.Tensor, rx_ok: torch.Tensor,
                    conf_cap: torch.Tensor, drop=None) -> torch.Tensor:
    """The plain torch version of the kernel, on any device.

    ``rnd``, ``offs``: the round and its ``fanout`` gossip shifts (device
    tensors, module docstring); the sender into column ``c`` on leg
    ``f`` is ``c - offs[f]``.  ``drop``: the partition's drop operand
    (module docstring) or None."""
    h = heard.to(torch.int32)
    pins = [_age_u8(_roll(h, o, 1)) for o in offs]
    srcs = [_live(_roll(mf, o, 0) > rnd, drop, f)[None, :]
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


def merge_shards_ref(p: SwimParams, rnd, offs, heard, mf: torch.Tensor,
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
    "fused_dissem": [_VP] * 6 + [_CI] * 3 + [_VP, _CI, _VP],
    "fused_merge": [ctypes.POINTER(_VP), _CI] + [_VP] * 5 + [_CI] * 3
                   + [_VP] + [_CI] * 3 + [_VP],
}


@functools.lru_cache(maxsize=None)
def _lib(name: str):
    """The entry point ``<name>`` of ``csrc/dissem_tail.cu``, built and
    loaded, and the library's error-string function, both typed."""
    lib = _build.load("dissem_tail")
    fn, err = getattr(lib, name), lib.dissem_tail_error
    fn.argtypes, fn.restype = _ARGTYPES[name], _CI
    err.argtypes, err.restype = [_CI], ctypes.c_char_p
    return fn, err


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call ``<name>`` on the current stream of ``dev``; raise if the
    launch was refused."""
    _build.launch(*_lib(name), name, dev, *args)


def _check_legs(offs, budget: int) -> None:
    if not 1 <= len(offs) <= MAX_FANOUT:
        raise ValueError(f"fanout must be in [1, {MAX_FANOUT}], "
                         f"got {len(offs)}")
    lo, hi = BUDGET_RANGE
    if not lo <= budget <= hi:
        raise ValueError(f"budget must be in [{lo}, {hi}], got {budget}")


def _device_args(rnd, offs, device) -> int:
    """The address of ``[rnd, o_0 .. o_F-1]``: a device ``rnd`` and
    ``offs`` lying back to back."""
    if not isinstance(rnd, torch.Tensor) \
            or not isinstance(offs, torch.Tensor) or rnd.dtype != torch.int32 \
            or offs.dtype != torch.int32 or rnd.numel() != 1 \
            or offs.dim() != 1 or not offs.is_contiguous() \
            or rnd.device != device or offs.device != device \
            or offs.data_ptr() != rnd.data_ptr() + 4:
        raise ValueError("device rnd and offs must be int32 [rnd, o_0 .. "
                         f"o_F-1] back to back on {device}")
    return rnd.data_ptr()


def _drop_ptr(drop, F: int, N: int, device) -> int | None:
    """The drop operand's address for the kernel (None for no operand):
    a contiguous u8 or bool [F, N] tensor on ``device``."""
    if drop is None:
        return None
    if drop.dtype == torch.bool:
        drop = drop.view(torch.uint8)
    check_tensor("drop", drop, torch.uint8, (F, N), device)
    return drop.data_ptr()


def fused_dissem(heard: torch.Tensor, offs, mf: torch.Tensor,
                 rx_ok: torch.Tensor, conf_cap: torch.Tensor, rnd,
                 budget: int, drop=None) -> torch.Tensor:
    """Launch ``fused_dissem`` of ``csrc/dissem_tail.cu`` on CUDA
    tensors (the arguments of ``disseminate_ref``; caps >= 0; ``drop``
    None or u8/bool [F, N]; ``rnd`` and ``offs`` back to back in device
    memory); returns a new ``[S, N]`` u8
    tensor.  Launches on the current stream and does not synchronise.
    Raises on anything the kernel does not take."""
    global launches, drop_launches
    require_cuda("fused_dissem", heard)
    if heard.dim() != 2 or heard.dtype != torch.uint8:
        raise ValueError(f"heard must be u8 [S, N], got {heard.dtype}"
                         f"{list(heard.shape)}")
    S, N = heard.shape
    dev = heard.device
    check_tensor("heard", heard, torch.uint8, (S, N), dev)
    check_tensor("mf", mf, torch.int32, (N,), dev)
    check_tensor("rx_ok", rx_ok, torch.bool, (N,), dev)
    check_tensor("conf_cap", conf_cap, torch.int32, (S,), dev)
    budget = int(budget)
    _check_legs(offs, budget)
    drop_p = _drop_ptr(drop, len(offs), N, dev)
    args_p = _device_args(rnd, offs, dev)
    out = torch.empty_like(heard)
    if heard.numel() == 0:
        return out
    head = (heard.data_ptr(), out.data_ptr(), mf.data_ptr(),
            rx_ok.data_ptr(), conf_cap.data_ptr(), drop_p, S, N, len(offs))
    _launch("fused_dissem", dev, *head, args_p, budget)
    launches += 1
    drop_launches += drop_p is not None
    launch_shapes.add(("fused_dissem", S, N, 1, len(offs), budget))
    return out


def fused_merge(heard, offs, mf: torch.Tensor, rx_ok: torch.Tensor,
                conf_cap: torch.Tensor, rnd, budget: int, drop=None):
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
    require_cuda("fused_merge", heard[0])
    if heard[0].dim() != 2:
        raise ValueError(f"each shard must be [S, L], got "
                         f"{list(heard[0].shape)}")
    S, L = heard[0].shape
    N = ndev * L
    dev = heard[0].device
    if N >= 2**31 - 16:
        raise ValueError(f"ndev * L must be below 2**31 - 16, got {N}")
    for i, h in enumerate(heard):
        check_tensor(f"shard {i}", h, torch.uint8, (S, L), dev)
    check_tensor("mf", mf, torch.int32, (N,), dev)
    check_tensor("rx_ok", rx_ok, torch.bool, (N,), dev)
    check_tensor("conf_cap", conf_cap, torch.int32, (S,), dev)
    budget = int(budget)
    _check_legs(offs, budget)
    drop_p = _drop_ptr(drop, len(offs), N, dev)
    args_p = _device_args(rnd, offs, dev)
    out = torch.empty((ndev, S, L), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out.unbind(0)
    table = _array(_VP, ndev)(*(h.data_ptr() for h in heard))
    head = (table, ndev, out.data_ptr(), mf.data_ptr(), rx_ok.data_ptr(),
            conf_cap.data_ptr(), drop_p, S, L, len(offs))
    _launch("fused_merge", dev, *head, args_p, budget, 0, ndev)
    merge_launches += 1
    merge_drop_launches += drop_p is not None
    launch_shapes.add(("fused_merge", S, L, ndev, len(offs), budget))
    return out.unbind(0)


def _disseminate_sharded(p: SwimParams, rnd, offs, heard, mf, rx_ok,
                         conf_cap, sc, drop):
    """The reference's ``_fused_sharded`` with its halo hop: one launch
    for all shards on CUDA tensors, the plain composition on CPU
    tensors."""
    _log("fused_merge", heard[0].shape[0], sc.L, sc.ndev, offs,
         p.spread_budget_rounds, drop)
    if heard[0].device.type == "cpu":
        return merge_shards_ref(p, rnd, offs, heard, mf, rx_ok, conf_cap, sc,
                                drop)
    return fused_merge(heard, offs, mf, rx_ok, conf_cap, rnd,
                       p.spread_budget_rounds, drop)


def disseminate(p: SwimParams, rnd, offs, heard, mf: torch.Tensor,
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
    _log("fused_dissem", *heard.shape, 1, offs, p.spread_budget_rounds,
         drop)
    if heard.device.type == "cpu":
        return disseminate_ref(p, rnd, offs, heard, mf, rx_ok, conf_cap,
                               drop)
    return fused_dissem(heard, offs, mf, rx_ok, conf_cap, rnd,
                        p.spread_budget_rounds, drop)
