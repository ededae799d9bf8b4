"""The round's dense dissemination tail: the Hopper kernel and its plain
torch version.

The reference runs this tail as one Pallas pass over the belief matrix
(``consul_tpu/gossip/fused.py::_fused_single``): age, ``fanout``
circulant pin deliveries, priority-max merge and Lifeguard confirmation
counting, all in one read and one write of ``heard [S, N]``.  Its port
is the hand-written CUDA kernel ``csrc/fused_dissem.cu`` (its header
states what it computes, its bound and its design), wrapped here by
``fused_dissem``.

``disseminate_ref`` is the same function in plain torch, per byte on
int32 lanes with ``torch.roll`` for the pins, exactly as the reference's
``_age_u8``/``_merge`` spell it.  ``disseminate`` — what the round calls
— takes the plain version only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from consul_tpu_torch.gossip.kernel import (_AGE_FRESH, _AGE_MASK,
                                            _CONF_MASK, _CONF_SHIFT,
                                            _MSG_SHIFT, MSG_SUSPECT)
from consul_tpu_torch.gossip.params import SwimParams
from consul_tpu_torch.ops.divisibility import require_divisible

MAX_FANOUT = 8  # csrc/fused_dissem.cu kMaxFanout

# Kernel launches made by ``fused_dissem`` (one per launch, nowhere else).
launches = 0


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


def disseminate_ref(p: SwimParams, rnd: int, offs, heard: torch.Tensor,
                    mf: torch.Tensor, rx_ok: torch.Tensor,
                    conf_cap: torch.Tensor) -> torch.Tensor:
    """The plain torch version of the kernel, on any device.

    ``offs``: the round's ``fanout`` gossip shifts (host ints); the
    sender into column ``c`` on leg ``f`` is ``c - offs[f]``."""
    h = heard.to(torch.int32)
    pins = [_age_u8(torch.roll(h, o, dims=1)) for o in offs]
    srcs = [(torch.roll(mf, o) > rnd)[None, :] for o in offs]
    out = _merge(p, _age_u8(h), pins, srcs, rx_ok[None, :],
                 conf_cap.to(torch.int32)[:, None])
    return out.to(torch.uint8)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from consul_tpu_torch import _build
    lib = _build.load("fused_dissem")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.fused_dissem.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci,
                                 ctypes.POINTER(ci), ci, ci, vp]
    lib.fused_dissem.restype = ci
    lib.fused_dissem_error.argtypes = [ci]
    lib.fused_dissem_error.restype = ctypes.c_char_p
    return lib


def fused_dissem(heard: torch.Tensor, offs, mf: torch.Tensor,
                 rx_ok: torch.Tensor, conf_cap: torch.Tensor, rnd: int,
                 budget: int) -> torch.Tensor:
    """Launch ``csrc/fused_dissem.cu`` on CUDA tensors; returns a new
    ``[S, N]`` u8 tensor.  Launches on the current stream and does not
    synchronise.  Raises on anything the kernel does not take."""
    global launches
    if heard.device.type != "cuda":
        raise ValueError(f"fused_dissem launches on a CUDA tensor, got "
                         f"{heard.device}")
    if heard.dim() != 2 or heard.dtype != torch.uint8:
        raise ValueError(f"heard must be u8 [S, N], got {heard.dtype}"
                         f"{list(heard.shape)}")
    S, N = heard.shape
    for name, t, dtype, shape in (("mf", mf, torch.int32, (N,)),
                                  ("rx_ok", rx_ok, torch.bool, (N,)),
                                  ("conf_cap", conf_cap, torch.int32, (S,))):
        if t.device != heard.device or t.dtype != dtype or \
                tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype}{list(shape)} on "
                             f"{heard.device}, got {t.dtype}"
                             f"{list(t.shape)} on {t.device}")
    for name, t in (("heard", heard), ("mf", mf), ("rx_ok", rx_ok),
                    ("conf_cap", conf_cap)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= len(offs) <= MAX_FANOUT:
        raise ValueError(f"fanout must be in [1, {MAX_FANOUT}], "
                         f"got {len(offs)}")
    out = torch.empty_like(heard)
    if heard.numel() == 0:
        return out
    lib = _lib()
    c_offs = (ctypes.c_int * len(offs))(*(int(o) % N for o in offs))
    with torch.cuda.device(heard.device):
        stream = torch.cuda.current_stream(heard.device).cuda_stream
        rc = lib.fused_dissem(heard.data_ptr(), out.data_ptr(),
                              mf.data_ptr(), rx_ok.data_ptr(),
                              conf_cap.data_ptr(), S, N, len(offs), c_offs,
                              int(rnd), int(budget), stream)
    if rc != 0:
        raise RuntimeError(f"fused_dissem launch failed: "
                           f"{lib.fused_dissem_error(rc).decode()}")
    launches += 1
    return out


def disseminate(p: SwimParams, rnd: int, offs, heard: torch.Tensor,
                mf: torch.Tensor, rx_ok: torch.Tensor,
                conf_cap: torch.Tensor) -> torch.Tensor:
    """The round's dense tail (reference ``fused_disseminate``): the
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if p.dissem == "fused":
        # The reference's grid contract (fused.py:146); the kernel here
        # tiles on its own, but the same configurations are refused.
        require_divisible(heard.shape[1], p.fused_nb, what="n",
                          by="fused_nb")
    if heard.device.type == "cpu":
        return disseminate_ref(p, rnd, offs, heard, mf, rx_ok, conf_cap)
    return fused_dissem(heard, offs, mf, rx_ok, conf_cap, rnd,
                        p.spread_budget_rounds)
