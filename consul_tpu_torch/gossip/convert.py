"""Carry state and keys across from the reference as numpy arrays.

This system has no weights: its state (``SwimState``, ``FlightRing``,
``HistBank``, the Lifeguard registers ``NemState``, the event flood's
``EventState``) and its PRNG key play that role.  A test, or a caller
migrating a live pool, exports the reference's NamedTuples field by
field as numpy (``{f: np.asarray(getattr(st, f)) for f in st._fields}``)
and the key as ``jax.random.key_data(key)``; these functions take them
onto a torch device and back.  The multi-DC state travels as the
reference's stacked arrays (``multidc_from_numpy`` /
``multidc_to_numpy``, and ``hist_banks_from_numpy`` /
``hist_banks_to_numpy`` for its per-DC hist banks).
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch._device import resolve_device
from consul_tpu_torch.gossip.events import EventState
from consul_tpu_torch.gossip.kernel import (FlightRing, HistBank, NemState,
                                            SwimState, shard_state,
                                            unshard_state)
from consul_tpu_torch.gossip.multidc import MultiDCState

_TYPES = (SwimState, FlightRing, HistBank, NemState, EventState)


def state_from_numpy(arrays: dict, device=None):
    """A ``SwimState``, ``FlightRing``, ``HistBank``, ``NemState`` or
    ``EventState`` —
    whichever has exactly the dict's field names — with each array on
    ``device``."""
    for cls in _TYPES:
        if set(arrays) == set(cls._fields):
            dev = resolve_device(device)
            return cls(*(torch.from_numpy(np.array(arrays[f])).to(dev)
                         for f in cls._fields))
    raise ValueError(f"fields {sorted(arrays)} match none of "
                     f"{[c.__name__ for c in _TYPES]}")


def state_to_numpy(state) -> dict:
    """The inverse of ``state_from_numpy``: field name -> numpy array.
    A sharded ``SwimState`` is unsharded first (``heard`` as [S, N])."""
    if isinstance(state, SwimState):
        state = unshard_state(state)
    return {f: getattr(state, f).cpu().numpy() for f in state._fields}


def key_from_numpy(data) -> np.ndarray:
    """A port key from ``jax.random.key_data(key)`` (``uint32[2]``)."""
    k = np.array(data)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"key data must be uint32[2], got "
                         f"{k.dtype}{list(k.shape)}")
    return k


_POOLS = ("lan", "lan_events", "wan", "wan_events")


def _per_dc(stacked: dict, dev) -> tuple:
    """D NamedTuples from the reference's stacked ``{f: [D, ...]}``."""
    D = len(next(iter(stacked.values())))
    return tuple(state_from_numpy({f: a[d] for f, a in stacked.items()}, dev)
                 for d in range(D))


def _stacked(items) -> dict:
    """The inverse of ``_per_dc``: field name -> [D, ...] numpy array."""
    per = [state_to_numpy(t) for t in items]
    return {f: np.stack([x[f] for x in per]) for f in per[0]}


def multidc_from_numpy(arrays: dict, device=None,
                       lan_devices: int = 0) -> MultiDCState:
    """A ``MultiDCState`` from the reference's, exported as ``{"lan": {f:
    [D, ...]}, "lan_events": {f: [D, ...]}, "wan": {f: ...},
    "wan_events": {f: ...}}``.  ``lan_devices > 1`` splits each DC's
    ``heard`` into that many column shards."""
    dev = resolve_device(device)
    if set(arrays) != set(_POOLS):
        raise ValueError(f"keys {sorted(arrays)} are not {_POOLS}")
    lan = _per_dc(arrays["lan"], dev)
    if lan_devices > 1:
        lan = tuple(shard_state(st, lan_devices, dev) for st in lan)
    return MultiDCState(
        lan=lan,
        lan_events=_per_dc(arrays["lan_events"], dev),
        wan=state_from_numpy(arrays["wan"], dev),
        wan_events=state_from_numpy(arrays["wan_events"], dev))


def multidc_to_numpy(state: MultiDCState) -> dict:
    """The inverse of ``multidc_from_numpy`` (sharded LAN pools
    unsharded)."""
    return {"lan": _stacked(state.lan),
            "lan_events": _stacked(state.lan_events),
            "wan": state_to_numpy(state.wan),
            "wan_events": state_to_numpy(state.wan_events)}


def hist_banks_from_numpy(arrays: dict, device=None) -> tuple:
    """The per-DC ``HistBank``s of ``init_multidc_hist`` from the
    reference's stacked ``HistBank`` ``{f: [D, ...]}``."""
    if set(arrays) != set(HistBank._fields):
        raise ValueError(f"keys {sorted(arrays)} are not the fields of "
                         f"HistBank")
    return _per_dc(arrays, resolve_device(device))


def hist_banks_to_numpy(banks: tuple) -> dict:
    """The inverse of ``hist_banks_from_numpy``."""
    return _stacked(banks)
