"""Carry state and keys across from the reference as numpy arrays.

This system has no weights: its state (``SwimState``, ``FlightRing``,
``HistBank``) and its PRNG key play that role.  A test, or a caller
migrating a live pool, exports the reference's NamedTuples field by
field as numpy (``{f: np.asarray(getattr(st, f)) for f in st._fields}``)
and the key as ``jax.random.key_data(key)``; these functions take them
onto a torch device and back.
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch._device import resolve_device
from consul_tpu_torch.gossip.kernel import (FlightRing, HistBank, SwimState,
                                            unshard_state)

_TYPES = (SwimState, FlightRing, HistBank)


def state_from_numpy(arrays: dict, device=None):
    """A ``SwimState``, ``FlightRing`` or ``HistBank`` — whichever has
    exactly the dict's field names — with each array on ``device``."""
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
