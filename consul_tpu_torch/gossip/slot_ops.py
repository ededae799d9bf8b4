"""The slot registers' scatter and allocation helpers, shared by the
round's ticks (``gossip/kernel.py``), the plain versions of the probe
tick's and the finish step's kernels (``gossip/probe.py``,
``gossip/finish_slots.py``) and the event round (``gossip/events.py``).

- ``set_drop``: the reference's ``.at[idx].set(val, mode="drop")`` on a
  1-D register, the dropped indices equal to its length;
- ``put_points``: point writes into a matrix in place, only the kept
  lanes' values landing;
- ``get_points``: point reads of a matrix or of its column shards;
- ``segment_min``: the minima of contiguous segments of a vector, as the
  ticks pick their candidates;
- ``alloc_free_slots``: candidates ranked onto the free slots in
  ascending slot order.
"""

from __future__ import annotations

import torch

_I32 = torch.int32


def set_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``x.at[idx].set(val, mode="drop")`` for a 1-D ``x`` whose dropped
    indices equal ``len(x)``: write into a padded sink element, slice it
    off.  The kept indices are distinct at every call site."""
    n = x.shape[0]
    out = torch.cat([x, x.new_zeros(1)])
    if not isinstance(val, torch.Tensor):
        # A fill on the device, not a host->device copy (which would
        # synchronise the stream).
        val = out.new_full(idx.shape, val)
    out[idx.long()] = val
    return out[:n]


def get_points(heard, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``heard[rows[k], cols[k]]`` (global columns) of the matrix or of a
    tuple of its column shards: each shard gathers the points whose
    column it owns."""
    shards = heard if isinstance(heard, tuple) else (heard,)
    L = shards[0].shape[1]
    out = torch.zeros(rows.shape, dtype=torch.uint8, device=rows.device)
    for i, h in enumerate(shards):
        owned = (cols >= i * L) & (cols < (i + 1) * L)
        loc = (cols - i * L).clamp(0, L - 1)
        out = torch.where(owned, h[rows, loc], out)
    return out


def put_points(h: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
               keep: torch.Tensor) -> None:
    """``h.view(-1)[idx[k]] = val[k]`` in place where ``keep[k]`` (the
    kept indices distinct, every index inside ``h``): a lane not kept
    writes the first kept lane's pair again, or, when no lane is kept, the
    byte already at its own index, so that every element written receives
    one value and no sink element (no copy of ``h``) is needed."""
    flat = h.view(-1)
    # The first kept lane, a device index (an int would be a host read).
    first = torch.argmax(keep.to(_I32)).view(1)
    some = keep.any()
    flat.index_put_(
        (torch.where(keep, idx, torch.where(some, idx.index_select(0, first),
                                            idx)),),
        torch.where(keep, val, torch.where(some, val.index_select(0, first),
                                           flat[idx])))


def segment_min(masked: torch.Tensor, kk: int, fill: int) -> torch.Tensor:
    """Min over ``kk`` contiguous segments (padded with ``fill``)."""
    GB = -(-masked.shape[0] // kk)
    pad = kk * GB - masked.shape[0]
    if pad:
        masked = torch.cat([masked, masked.new_full((pad,), fill)])
    return masked.view(kk, GB).amin(dim=1)


def alloc_free_slots(free: torch.Tensor, want: torch.Tensor):
    """Rank the True entries of ``want`` onto the free slots of ``free``
    in ascending slot order.  Returns ``(can, slot_ids, sidx)``: ``can``
    marks served entries, ``slot_ids`` their slots, and ``sidx`` the slot
    id for served entries and ``len(free)`` (the drop sink) otherwise."""
    S = free.shape[0]
    free_order = torch.argsort(torch.where(free, 0, 1),
                               stable=True).to(_I32)
    n_free = free.sum(dtype=_I32)
    rank = torch.cumsum(want.to(_I32), 0, dtype=_I32) - 1
    can = want & (rank < n_free)
    slot_ids = free_order[rank.clamp(0, S - 1).long()]
    sidx = torch.where(can, slot_ids, S)
    return can, slot_ids, sidx
