"""Multi-datacenter gossip on torch tensors: per-DC LAN pools and one
cross-DC WAN pool (port of ``consul_tpu/gossip/multidc.py``, whose
docstring gives the topology: every node is in its DC's LAN pool, the
servers also form one WAN pool with coarser timers, and user events
cross DCs through the servers).

Under the same key and inputs every function here is bit-identical to
the reference's (``tests/test_torch_multidc.py``).  How the JAX program
maps onto eager PyTorch:

- The reference stacks the D LAN pools on a leading axis and runs a
  static Python loop over them inside the jit (not ``vmap``).  Here the
  loop is the same, and ``MultiDCState`` holds a tuple of D per-DC
  ``SwimState`` and ``EventState``: a sharded pool's ``heard`` is itself
  a tuple of shards, which a stack cannot hold, and a stack would copy
  every belief matrix each round.  ``convert.multidc_to_numpy`` and
  ``multidc_from_numpy`` map to and from the reference's stacked arrays.
- Every pool's round counter is mirrored on the host: one device read
  for all of them per ``multidc_round`` or ``run_multidc_rounds`` call.
- With ``lan_devices > 1`` each DC's round runs on that many column
  shards of the one device (``kernel.sharded_round_callable``).

Tensors passed in are never modified in place.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch import prng
from consul_tpu_torch._device import resolve_device
from consul_tpu_torch.gossip import kernel as _kernel
from consul_tpu_torch.gossip.events import (_SEEN, EventState, _event_round,
                                            init_events)
from consul_tpu_torch.gossip.kernel import (SwimState, _as_i32,
                                            _check_shardable, _on, _one_round,
                                            init_hist, init_state,
                                            shard_state,
                                            sharded_round_callable)
from consul_tpu_torch.gossip.params import SwimParams, lan_profile, wan_profile


class MultiDCParams(NamedTuple):
    n_dcs: int
    n_lan: int          # nodes per DC
    n_servers: int      # servers per DC (3-5 in the reference posture)
    event_slots: int
    lan: SwimParams
    wan: SwimParams
    # Column shards each DC's LAN round runs on (one device); 0/1 =
    # single-device LAN rounds.  Needs n_lan % lan_devices == 0 and
    # n_lan % lan.probe_every == 0 (``kernel._check_shardable``).
    lan_devices: int = 0


def make_params(n_dcs: int, n_lan: int, n_servers: int = 3,
                event_slots: int = 32, lan_devices: int = 0,
                **kw) -> MultiDCParams:
    """The reference's ``make_params`` (``kw`` goes to ``lan_profile``).
    A ``lan_devices`` the LAN pool cannot be split into raises here with
    the error the reference's first round raises."""
    lan = lan_profile(n_lan, **kw)
    if lan_devices > 1:
        _check_shardable(lan, lan_devices)
    return MultiDCParams(
        n_dcs=n_dcs, n_lan=n_lan, n_servers=n_servers,
        event_slots=event_slots,
        lan=lan,
        wan=wan_profile(n_dcs * n_servers),
        lan_devices=lan_devices,
    )


class MultiDCState(NamedTuple):
    lan: tuple          # D x SwimState (heard sharded with lan_devices > 1)
    lan_events: tuple   # D x EventState
    wan: SwimState
    wan_events: EventState


def init_multidc(p: MultiDCParams, device=None) -> MultiDCState:
    dev = resolve_device(device)

    def lan_state():
        st = init_state(p.lan, device=dev)
        return shard_state(st, p.lan_devices, dev) if p.lan_devices > 1 else st

    return MultiDCState(
        lan=tuple(lan_state() for _ in range(p.n_dcs)),
        lan_events=tuple(init_events(p.lan, p.event_slots, device=dev)
                         for _ in range(p.n_dcs)),
        wan=init_state(p.wan, device=dev),
        wan_events=init_events(p.wan, p.event_slots, device=dev),
    )


def init_multidc_hist(p: MultiDCParams, device=None) -> tuple:
    """Per-DC observatory banks: D ``HistBank``s."""
    dev = resolve_device(device)
    return tuple(init_hist(device=dev) for _ in range(p.n_dcs))


def _merge_seen(dst: torch.Tensor, src_seen: torch.Tensor) -> torch.Tensor:
    """Set the seen-bit (age 0) where src has seen and dst hasn't."""
    newly = src_seen & ((dst & _SEEN) == 0)
    return torch.where(newly, torch.tensor(_SEEN, dtype=torch.uint8,
                                           device=dst.device), dst)


def _host_rounds(state: MultiDCState) -> list:
    """Every pool's round counter in one device read: [lan x D,
    lan_events x D, wan, wan_events]."""
    _kernel.host_syncs += 1
    return torch.stack([s.round for s in state.lan]
                       + [e.round for e in state.lan_events]
                       + [state.wan.round, state.wan_events.round]).tolist()


def _lan_round_fn(p: MultiDCParams, has_hist: bool, dev: torch.device):
    """Each DC's LAN round: ``(state, key, fail[, hist], rnd=)``."""
    if p.lan_devices > 1:
        return sharded_round_callable(p.lan, p.lan_devices,
                                      has_hist=has_hist, device=dev)

    def _round(st, k, f, *hist, rnd):
        return _one_round(st, k, f, p.lan, hist[0] if hist else None, None,
                          dev, rnd=rnd)
    return _round


def _round(state: MultiDCState, rounds: list, base_key, lan_fail, wan_fail,
           p: MultiDCParams, lan_hist, lan_round, dev):
    """One LAN gossip interval across every pool; ``rounds`` is the host
    mirror of the counters (``_host_rounds``)."""
    D, s = p.n_dcs, p.n_servers
    lan_r, ev_r = rounds[:D], rounds[D:2 * D]
    wan_r, wev_r = rounds[2 * D:]
    keys = prng.split(prng.fold_in(base_key, 11), D)
    has_hist = lan_hist is not None

    # -- LAN pools: membership, then events, one static loop over the DCs.
    lan, hists = [], []
    for d in range(D):
        out = lan_round(state.lan[d], keys[d], lan_fail[d],
                        *((lan_hist[d],) if has_hist else ()), rnd=lan_r[d])
        if has_hist:
            out, hb = out
            hists.append(hb)
        lan.append(out)
    # Liveness from the pre-round event clock.
    lan_events = [_event_round(state.lan_events[d], ev_r[d], keys[d],
                               lan_fail[d] > ev_r[d], p.lan)
                  for d in range(D)]

    # -- WAN pool: its membership round and its event round share a key.
    wan_key = prng.fold_in(base_key, 13)
    wan = _one_round(state.wan, wan_key, wan_fail, p.wan, None, None, dev,
                     rnd=wan_r)
    wan_events = _event_round(state.wan_events, wev_r, wan_key,
                              wan_fail > wev_r, p.wan)

    # -- event bridge at the servers (serf's WAN user-event relay).  Slot
    # ids are global (fire_in_dc stamps every pool), so the bridge only
    # merges seen-bits: first into the WAN pool from every DC's servers
    # (WAN id d * s + j is server j of DC d), then back into each DC's
    # servers from the updated WAN bits, each gated on the receiving
    # pool's live slots.
    lan_srv_flat = torch.cat([(ev.has[:, :s] & _SEEN) > 0
                              for ev in lan_events], dim=1)     # [E, D*s]
    wan_has = _merge_seen(wan_events.has,
                          lan_srv_flat & wan_events.slot_used[:, None])
    wan_seen = (wan_has & _SEEN) > 0
    bridged = []
    for d, ev in enumerate(lan_events):
        srv = _merge_seen(ev.has[:, :s],
                          wan_seen[:, d * s:(d + 1) * s]
                          & ev.slot_used[:, None])
        bridged.append(ev._replace(
            has=torch.cat([srv, ev.has[:, s:]], dim=1)))
    out = MultiDCState(lan=tuple(lan), lan_events=tuple(bridged), wan=wan,
                       wan_events=wan_events._replace(has=wan_has))
    return out, (tuple(hists) if has_hist else None)


def _inputs(state, lan_fail, wan_fail, lan_hist, dev):
    state = MultiDCState(lan=tuple(_on(dev, st) for st in state.lan),
                         lan_events=tuple(_on(dev, e)
                                          for e in state.lan_events),
                         wan=_on(dev, state.wan),
                         wan_events=_on(dev, state.wan_events))
    if lan_hist is not None:
        lan_hist = tuple(_on(dev, hb) for hb in lan_hist)
    return state, _as_i32(lan_fail, dev), _as_i32(wan_fail, dev), lan_hist


def multidc_round(state: MultiDCState, base_key, lan_fail, wan_fail,
                  p: MultiDCParams, lan_hist: tuple | None = None,
                  device=None):
    """One LAN gossip interval across every pool (reference
    ``multidc_round``).  ``lan_fail``: [D, n_lan] fail rounds;
    ``wan_fail``: [D * n_servers].  The WAN pool ticks every round too
    (its protocol is slower through its own parameters).  With
    ``lan_hist`` (``init_multidc_hist``) returns ``(state, lan_hist)``."""
    dev = resolve_device(device)
    state, lan_fail, wan_fail, lan_hist = _inputs(state, lan_fail, wan_fail,
                                                  lan_hist, dev)
    out, hists = _round(state, _host_rounds(state), base_key, lan_fail,
                        wan_fail, p, lan_hist,
                        _lan_round_fn(p, lan_hist is not None, dev), dev)
    return (out, hists) if lan_hist is not None else out


def fire_in_dc(state: MultiDCState, dc: int, node: int,
               p: MultiDCParams) -> MultiDCState:
    """Originate one user event at (dc, node) (reference ``fire_in_dc``).

    Allocates a slot free in every pool (slot ids are global across DCs)
    and stamps the slot's metadata in every pool.  Three device reads,
    as there: whether a slot is free, which, and the firing node's
    clock.  With no free slot, every DC's ``drops`` counts the fire, as
    the reference's stacked counter does."""
    le, we = state.lan_events, state.wan_events
    used = we.slot_used
    for ev in le:
        used = used | ev.slot_used
    free = ~used
    if not bool(free.any()):
        return state._replace(lan_events=tuple(
            ev._replace(drops=ev.drops + 1) for ev in le))
    slot = int(torch.argmax(free.to(torch.int32)))
    fire_lt = int(le[dc].node_ltime[node]) + 1

    def put(t: torch.Tensor, i, v) -> torch.Tensor:
        t = t.clone()
        t[i] = v
        return t

    lan_events = []
    for d, ev in enumerate(le):
        mine = d == dc
        lan_events.append(ev._replace(
            has=put(ev.has, (slot, node), _SEEN) if mine else ev.has,
            slot_used=put(ev.slot_used, slot, True),
            ltime=put(ev.ltime, slot, fire_lt),
            origin=put(ev.origin, slot, node if mine else -1),
            start_round=put(ev.start_round, slot, ev.round),
            node_ltime=(put(ev.node_ltime, node, fire_lt) if mine
                        else ev.node_ltime),
            n_seen=put(ev.n_seen, slot, 1 if mine else 0)))
    wan_events = we._replace(
        slot_used=put(we.slot_used, slot, True),
        ltime=put(we.ltime, slot, fire_lt),
        origin=put(we.origin, slot, -1),
        start_round=put(we.start_round, slot, we.round),
        n_seen=put(we.n_seen, slot, 0))
    return state._replace(lan_events=tuple(lan_events),
                          wan_events=wan_events)


def _coverage(lan_events) -> torch.Tensor:
    """[D, E] float32: the seen count over n_lan (every node, live or
    not).  The reference's mean divides by a constant, which XLA
    compiles as a product with the float32 reciprocal: so here."""
    seen = torch.stack([((ev.has & _SEEN) > 0).sum(dim=1, dtype=torch.int32)
                        for ev in lan_events])
    n = lan_events[0].has.shape[1]
    recip = torch.tensor(np.float32(1) / np.float32(n), device=seen.device)
    return seen.to(torch.float32) * recip


def event_coverage(state: MultiDCState) -> torch.Tensor:
    """[D, E] fraction of each DC's nodes holding each event (all nodes:
    ``events.coverage`` divides by the live ones instead)."""
    return _coverage(state.lan_events)


def run_multidc_rounds(state: MultiDCState, base_key, lan_fail, wan_fail,
                       p: MultiDCParams, steps: int,
                       lan_hist: tuple | None = None, device=None):
    """``steps`` rounds (reference ``run_multidc_rounds``): returns
    ``(state, cov)``, or ``((state, lan_hist), cov)`` with ``lan_hist``;
    ``cov`` is the per-round [steps, D, E] event coverage."""
    dev = resolve_device(device)
    state, lan_fail, wan_fail, lan_hist = _inputs(state, lan_fail, wan_fail,
                                                  lan_hist, dev)
    lan_round = _lan_round_fn(p, lan_hist is not None, dev)
    rounds = _host_rounds(state)
    covs = []
    for _ in range(steps):
        state, lan_hist = _round(state, rounds, base_key, lan_fail, wan_fail,
                                 p, lan_hist, lan_round, dev)
        rounds = [r + 1 for r in rounds]
        covs.append(_coverage(state.lan_events))
    cov = (torch.stack(covs) if covs else
           torch.zeros((0, p.n_dcs, p.event_slots), dtype=torch.float32,
                       device=dev))
    return ((state, lan_hist) if lan_hist is not None else state), cov
