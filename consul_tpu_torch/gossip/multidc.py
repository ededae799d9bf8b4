"""Multi-datacenter gossip on torch tensors: per-DC LAN pools and one
cross-DC WAN pool (port of ``consul_tpu/gossip/multidc.py``, whose
docstring gives the topology: every node is in its DC's LAN pool, the
servers also form one WAN pool with coarser timers, and user events
cross DCs through the servers).

Under the same key and inputs every function here is bit-identical to
the reference's (``tests/test_torch_multidc.py``,
``tests/test_torch_multidc_program.py``).  How the JAX program maps onto
PyTorch:

- ``jax.jit(run_multidc_rounds)`` is ``MultiDCProgram`` on a card: each
  pool's rounds are replays of its own captured programs
  (``gossip/program.py``: a ``RoundProgram`` per DC's LAN pool, sharded
  or not, and for the WAN pool; an ``EventProgram`` per event pool; one
  small program for the server bridge and the coverage row), each holding
  its pool's state in its buffers for the whole call.  A round replays
  2 D + 3 graphs and reads nothing on the host; each pool's variant is
  picked on the host from its own mirror of its round counter.  The eager
  loop here is the plain version: the CPU runs it, and so does a card
  when asked (``graphed=False``).
- The reference stacks the D LAN pools on a leading axis and runs a
  static Python loop over them inside the jit (not ``vmap``).  Here the
  loop is the same, and ``MultiDCState`` holds a tuple of D per-DC
  ``SwimState`` and ``EventState``: a sharded pool's ``heard`` is itself
  a tuple of shards, which a stack cannot hold, and a stack would copy
  every belief matrix each round.  ``convert.multidc_to_numpy`` and
  ``multidc_from_numpy`` map to and from the reference's stacked arrays.
- Every pool's round counter is mirrored on the host: one device read
  for all of them per ``multidc_round`` or ``run_multidc_rounds`` call.
  The pools' keys (``split(fold_in(key, 11), D)`` for the LAN pools,
  ``fold_in(key, 13)`` for the WAN pool) do not depend on the round, so
  every pool's table of round and event rows for the call is made at
  once: on a card one launch of the table kernel (``round_table.fill``)
  into every program's buffer, eagerly one vectorised pass on the host
  (``round_args.build_pools``, its plain version).
- With ``lan_devices > 1`` each DC's round runs on that many column
  shards of the one device (``kernel.sharded_round_callable``).

Tensors passed in are never modified in place.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import numpy as np
import torch

from consul_tpu_torch import prng
from consul_tpu_torch._device import resolve_device
from consul_tpu_torch.gossip import kernel as _kernel
from consul_tpu_torch.gossip import probe, round_args, round_table
from consul_tpu_torch.gossip.events import (_SEEN, EventState, _event_round,
                                            init_events, is_pushpull)
from consul_tpu_torch.gossip.kernel import (SwimState, _as_i32,
                                            _check_shardable, _on,
                                            _own_hist, _own_state,
                                            _require_unsharded,
                                            _round_once,
                                            _sharded_setup, init_hist,
                                            init_state, round_variant,
                                            shard_state)
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
    return dst.masked_fill(src_seen & ((dst & _SEEN) == 0), _SEEN)


def _host_rounds(state: MultiDCState) -> list:
    """Every pool's round counter in one device read: [lan x D,
    lan_events x D, wan, wan_events]."""
    _kernel.host_syncs += 1
    return torch.stack([s.round for s in state.lan]
                       + [e.round for e in state.lan_events]
                       + [state.wan.round, state.wan_events.round]).tolist()


def _pool_keys(base_key, D: int):
    """The D LAN pools' keys and the WAN pool's (round-independent)."""
    return prng.split(prng.fold_in(base_key, 11), D), prng.fold_in(base_key,
                                                                   13)


def _tables(p: MultiDCParams, base_key, rounds: list, steps: int) -> tuple:
    """A call's tables from the counters ``rounds`` (``_host_rounds``'
    order): the LAN pools' round rows ``[D, steps, W]`` and event rows
    ``[D, steps, We]``, each in one vectorised pass over the pools, and
    the WAN pool's ``[steps, W']`` and ``[steps, We']``."""
    D = p.n_dcs
    keys, wan_key = _pool_keys(base_key, D)
    return (round_args.build_pools(p.lan, keys, rounds[:D], steps),
            round_args.build_pools(p.lan, keys, rounds[D:2 * D], steps,
                                   events=True),
            round_args.build(p.wan, wan_key, rounds[2 * D], steps),
            round_args.build_events(p.wan, wan_key, rounds[2 * D + 1],
                                    steps))


def _shard_ctx(p: MultiDCParams):
    if p.lan_devices > 1:
        return _kernel._ShardCtx(p.lan_devices, p.n_lan // p.lan_devices)
    return None


def _bridge(lan_events, wan_events, s: int):
    """The event bridge at the servers (serf's WAN user-event relay).
    Slot ids are global (fire_in_dc stamps every pool), so the bridge only
    merges seen-bits: first into the WAN pool from every DC's servers (WAN
    id d * s + j is server j of DC d), then back into each DC's servers
    from the updated WAN bits, each gated on the receiving pool's live
    slots.  Returns each DC's new ``has[:, :s]`` and the WAN pool's
    ``has``."""
    lan_srv_flat = torch.cat([(ev.has[:, :s] & _SEEN) > 0
                              for ev in lan_events], dim=1)     # [E, D*s]
    wan_has = _merge_seen(wan_events.has,
                          lan_srv_flat & wan_events.slot_used[:, None])
    wan_seen = (wan_has & _SEEN) > 0
    srvs = [_merge_seen(ev.has[:, :s],
                        wan_seen[:, d * s:(d + 1) * s] & ev.slot_used[:, None])
            for d, ev in enumerate(lan_events)]
    return srvs, wan_has


def _round(state: MultiDCState, tabs: tuple, steps: tuple, k: int,
           rounds: list, lan_fail, wan_fail, p: MultiDCParams, lan_hist,
           scratch: tuple):
    """Round ``k`` of a call across every pool, eagerly: ``tabs`` the
    call's tables on the device (``_tables``), ``steps`` each round pool's
    device row counter, ``rounds`` the counters at the call's start,
    ``scratch`` the probe tick's scratch of the LAN pools (one serves
    them in turn) and of the WAN pool, made once a call."""
    D, s = p.n_dcs, p.n_servers
    lan_t, lan_ev_t, wan_t, wan_ev_t = tabs
    sc = _shard_ctx(p)
    has_hist = lan_hist is not None

    # -- LAN pools: membership, then events, one static loop over the DCs.
    lan, hists = [], []
    for d in range(D):
        st, hb, _ = _round_once(
            p.lan, lan_t[d], steps[d], state.lan[d],
            round_variant(p.lan, None, rounds[d] + k), lan_fail[d], None,
            lan_hist[d] if has_hist else None, None, sc,
            probe_scratch=scratch[0])
        lan.append(st)
        hists.append(hb)
    # Liveness from the pre-round event clock.
    lan_events = [_event_round(ev, lan_ev_t[d][k], lan_fail[d] > ev.round,
                               p.lan, is_pushpull(p.lan, rounds[D + d] + k))[0]
                  for d, ev in enumerate(state.lan_events)]

    # -- WAN pool: its membership round and its event round share a key.
    wan, _, _ = _round_once(p.wan, wan_t, steps[D], state.wan,
                            round_variant(p.wan, None, rounds[2 * D] + k),
                            wan_fail, None, None, None,
                            probe_scratch=scratch[1])
    wev = state.wan_events
    wan_events, _ = _event_round(wev, wan_ev_t[k], wan_fail > wev.round,
                                 p.wan, is_pushpull(p.wan,
                                                    rounds[2 * D + 1] + k))

    srvs, wan_has = _bridge(lan_events, wan_events, s)
    bridged = tuple(ev._replace(has=torch.cat([srv, ev.has[:, s:]], dim=1))
                    for ev, srv in zip(lan_events, srvs))
    out = MultiDCState(lan=tuple(lan), lan_events=bridged, wan=wan,
                       wan_events=wan_events._replace(has=wan_has))
    return out, (tuple(hists) if has_hist else None)


def _inputs(state, lan_fail, wan_fail, lan_hist, p: MultiDCParams, dev,
            own: bool):
    """The call's inputs on ``dev``; each LAN pool sharded as ``p`` says
    (a pool given unsharded is split here).  ``own``: every pool's belief
    matrix, the registers the probe tick and the finish step write and the
    banks copies of the caller's (the eager rounds write them in place)."""
    def pool(st):
        return _on(dev, _own_state(st, dev) if own else st)

    def lan_pool(st):
        if p.lan_devices > 1:
            return _sharded_setup(st, p.lan, p.lan_devices, dev, own)[0]
        _require_unsharded(st)
        return pool(st)

    state = MultiDCState(lan=tuple(lan_pool(st) for st in state.lan),
                         lan_events=tuple(_on(dev, e)
                                          for e in state.lan_events),
                         wan=pool(state.wan),
                         wan_events=_on(dev, state.wan_events))
    if lan_hist is not None:
        lan_hist = tuple(_own_hist(hb, dev) if own else _on(dev, hb)
                         for hb in lan_hist)
    return state, _as_i32(lan_fail, dev), _as_i32(wan_fail, dev), lan_hist


def _recip(n: int, dev) -> torch.Tensor:
    """1 / n in float32, as a device scalar (made outside any capture)."""
    return torch.tensor(np.float32(1) / np.float32(n), device=dev)


def _coverage(lan_events, recip: torch.Tensor) -> torch.Tensor:
    """[D, E] float32: the seen count over n_lan (every node, live or
    not).  The reference's mean divides by a constant, which XLA
    compiles as a product with the float32 reciprocal ``recip``
    (``_recip``): so here."""
    seen = torch.stack([((ev.has & _SEEN) > 0).sum(dim=1, dtype=torch.int32)
                        for ev in lan_events])
    return seen.to(torch.float32) * recip


def event_coverage(state: MultiDCState) -> torch.Tensor:
    """[D, E] fraction of each DC's nodes holding each event (all nodes:
    ``events.coverage`` divides by the live ones instead)."""
    ev = state.lan_events
    return _coverage(ev, _recip(ev[0].has.shape[1], ev[0].has.device))


def _run_eager(state, base_key, lan_fail, wan_fail, p: MultiDCParams,
               steps: int, lan_hist, dev, cov: bool = True):
    rounds = _host_rounds(state)
    tabs = tuple(round_args.to_device(t, dev)
                 for t in _tables(p, base_key, rounds, steps))
    ctr = tuple(torch.zeros(1, dtype=torch.int64, device=dev)
                for _ in range(p.n_dcs + 1))
    recip = _recip(p.n_lan, dev)
    scratch = (probe.scratch(p.lan, dev), probe.scratch(p.wan, dev))
    covs = []
    for k in range(steps):
        state, lan_hist = _round(state, tabs, ctr, k, rounds, lan_fail,
                                 wan_fail, p, lan_hist, scratch)
        if cov:
            covs.append(_coverage(state.lan_events, recip))
    return state, lan_hist, (torch.stack(covs) if covs else torch.zeros(
        (0, p.n_dcs, p.event_slots), dtype=torch.float32, device=dev))


def multidc_round(state: MultiDCState, base_key, lan_fail, wan_fail,
                  p: MultiDCParams, lan_hist: tuple | None = None,
                  device=None, graphed: bool | None = None):
    """One LAN gossip interval across every pool (reference
    ``multidc_round``).  ``lan_fail``: [D, n_lan] fail rounds;
    ``wan_fail``: [D * n_servers].  The WAN pool ticks every round too
    (its protocol is slower through its own parameters).  With
    ``lan_hist`` (``init_multidc_hist``) returns ``(state, lan_hist)``.
    On a card a replay of ``MultiDCProgram`` (``graphed=False``: the eager
    round there)."""
    out, _ = run_multidc_rounds(state, base_key, lan_fail, wan_fail, p, 1,
                                lan_hist, device, graphed, _cov=False)
    return out


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




# -- the multi-DC round as replayed graphs ----------------------------------------

MAX_PROGRAMS = 2   # MultiDCPrograms kept (each holds 2 D + 3 programs)
_programs: collections.OrderedDict = collections.OrderedDict()


def _bridge_program(p: MultiDCParams, dev, lan_events, wan_events, pool):
    """The server bridge and the coverage row as a program of its own:
    reads and writes the event programs' buffers, and the round's [D, E]
    coverage row into its trace buffer at ``step``.  Its variant is the
    event programs' parity after their floods (the set of buffers that
    holds their state), so it is captured once per parity."""
    from consul_tpu_torch.gossip import program

    class BridgeProgram(program._Program):
        def __init__(self):
            super().__init__(dev, pool)
            self.step = torch.zeros(1, dtype=torch.int64, device=dev)
            self.cov = torch.zeros((program.TABLE_ROWS, p.n_dcs,
                                    p.event_slots), dtype=torch.float32,
                                   device=dev)
            self.recip = _recip(p.n_lan, dev)

        def _states(self, cur):
            return [e.sets[cur] for e in lan_events], wan_events.sets[cur]

        def _warm(self, v) -> None:
            lan, wan = self._states(v)
            _bridge(lan, wan, p.n_servers)
            _coverage(lan, self.recip)

        def _body(self, v) -> None:
            lan, wan = self._states(v)
            srvs, wan_has = _bridge(lan, wan, p.n_servers)
            for ev, srv in zip(lan, srvs):
                ev.has[:, :p.n_servers].copy_(srv)
            wan.has.copy_(wan_has)
            self.cov.index_copy_(0, self.step,
                                 _coverage(lan, self.recip)[None])
            self.step.add_(1)

    return BridgeProgram()


class MultiDCProgram:
    """``jax.jit(run_multidc_rounds)`` on a card, for one configuration:
    each pool's own programs (module docstring), outside the round
    programs' cache and sharing one memory pool, their state in their
    buffers across all the rounds of a call (no copy between pools or
    rounds).  ``run`` makes one host read a call (every pool's counter)
    and none inside a round; a round is 2 D + 3 graph launches."""

    def __init__(self, p: MultiDCParams, dev, state, lan_fail, wan_fail,
                 lan_hist):
        from consul_tpu_torch.gossip import program
        self.p, self.dev = p, dev
        pool = (torch.cuda.graph_pool_handle() if dev.type == "cuda"
                else None)
        D, sc = p.n_dcs, _shard_ctx(p)
        self.lan = [program.RoundProgram(
            p.lan, None, sc, dev, state.lan[d], lan_fail[d], None, None,
            None if lan_hist is None else lan_hist[d], None, False,
            pool=pool) for d in range(D)]
        self.lan_events = [program.EventProgram(
            p.lan, dev, state.lan_events[d], fail=lan_fail[d], cov=False,
            pool=pool) for d in range(D)]
        self.wan = program.RoundProgram(p.wan, None, None, dev, state.wan,
                                        wan_fail, None, None, None, None,
                                        False, pool=pool)
        self.wan_events = program.EventProgram(
            p.wan, dev, state.wan_events, fail=wan_fail, cov=False,
            pool=pool)
        self.bridge = _bridge_program(p, dev, self.lan_events,
                                      self.wan_events, pool)
        self.programs = [*self.lan, *self.lan_events, self.wan,
                         self.wan_events, self.bridge]
        for prog in self.programs:
            program.own(prog)
        self.captured = False

    def capture_all(self) -> None:
        """Capture every variant the pools can take (push/pull or not)
        before the first round, so that no capture falls inside a call's
        rounds later; the buffers are left as they were."""
        p = self.p
        for q, rounds, evs in ((p.lan, self.lan, self.lan_events),
                               (p.wan, [self.wan], [self.wan_events])):
            for pp in (False, True) if q.pushpull_every else (False,):
                for prog in rounds:
                    prog.graph(_kernel.Variant(pp, False, False, False))
                for prog in evs:
                    prog.capture(pp)
        for cur in (0, 1):
            self.bridge.graph(cur)
        self.captured = True

    def _jobs(self, keys, wan_key, rounds: list) -> list:
        """Every pool's table of a chunk from the counters ``rounds``
        (``_host_rounds``' order), as ``_tables`` builds them, each into
        its program's buffer with its row counter reset: one fill."""
        p, D = self.p, self.p.n_dcs
        Job = round_table.Job
        return ([Job(p.lan, keys[d], rounds[d], prog.table, step=prog.step)
                 for d, prog in enumerate(self.lan)]
                + [Job(p.lan, keys[d], rounds[D + d], prog.table,
                       events=True, step=prog.step)
                   for d, prog in enumerate(self.lan_events)]
                + [Job(p.wan, wan_key, rounds[2 * D], self.wan.table,
                       step=self.wan.step),
                   Job(p.wan, wan_key, rounds[2 * D + 1],
                       self.wan_events.table, events=True,
                       step=self.wan_events.step)])

    @property
    def pool_bytes(self) -> list:
        """What each program's captures reserved: LAN pools, their event
        pools, the WAN pool, its event pool, the bridge."""
        return [prog.pool_bytes for prog in self.programs]

    def close(self) -> None:
        from consul_tpu_torch.gossip import program
        for prog in self.programs:
            program.disown(prog)

    def run(self, state, base_key, lan_fail, wan_fail, steps: int,
            lan_hist, cov: bool = True):
        """``steps`` rounds from ``state``: ``(state, lan_hist, cov)``,
        new tensors (``cov`` [steps, D, E], or None)."""
        from consul_tpu_torch.gossip import program
        p, D = self.p, self.p.n_dcs
        rounds = _host_rounds(state)
        for d in range(D):
            self.lan[d].load(state.lan[d], lan_fail[d],
                             hist=None if lan_hist is None else lan_hist[d])
            self.lan_events[d].load(state.lan_events[d], fail=lan_fail[d])
        self.wan.load(state.wan, wan_fail)
        self.wan_events.load(state.wan_events, fail=wan_fail)
        if not self.captured:
            self.capture_all()
        covs = []
        keys, wan_key = _pool_keys(base_key, D)
        for done in range(0, steps, program.TABLE_ROWS):
            n = min(program.TABLE_ROWS, steps - done)
            round_table.fill(self._jobs(keys, wan_key,
                                        [r + done for r in rounds]), n)
            self.bridge.step.zero_()
            for k in range(done, done + n):
                for d in range(D):
                    self.lan[d].replay(round_variant(p.lan, None,
                                                     rounds[d] + k))
                for d in range(D):
                    self.lan_events[d].replay(
                        is_pushpull(p.lan, rounds[D + d] + k))
                self.wan.replay(round_variant(p.wan, None,
                                              rounds[2 * D] + k))
                self.wan_events.replay(is_pushpull(p.wan,
                                                   rounds[2 * D + 1] + k))
                self.bridge.replay(self.wan_events.cur)
            if cov:
                covs.append(self.bridge.cov[:n].clone())
        lan = [prog.result() for prog in self.lan]
        out = MultiDCState(
            lan=tuple(r[0] for r in lan),
            lan_events=tuple(program._clone(e.state)
                             for e in self.lan_events),
            wan=self.wan.result()[0],
            wan_events=program._clone(self.wan_events.state))
        hists = None if lan_hist is None else tuple(r[2] for r in lan)
        if not cov:
            return out, hists, None
        return out, hists, (torch.cat(covs) if covs else torch.zeros(
            (0, D, p.event_slots), dtype=torch.float32, device=self.dev))


def program_for(p: MultiDCParams, dev, state, lan_fail, wan_fail,
                lan_hist) -> MultiDCProgram:
    """The cached ``MultiDCProgram`` of this configuration (built on first
    use; the least recently used of more than ``MAX_PROGRAMS`` is
    closed)."""
    key = (p, str(dev), lan_hist is not None)
    prog = _programs.get(key)
    if prog is None:
        prog = _programs[key] = MultiDCProgram(p, dev, state, lan_fail,
                                               wan_fail, lan_hist)
        while len(_programs) > MAX_PROGRAMS:
            _programs.popitem(last=False)[1].close()
    _programs.move_to_end(key)
    return prog


def close_programs() -> None:
    """Close every cached ``MultiDCProgram`` (its graphs and buffers go;
    its counts are settled first)."""
    while _programs:
        _programs.popitem()[1].close()


def _run_graphed(state, base_key, lan_fail, wan_fail, p: MultiDCParams,
                 steps: int, lan_hist, dev, cov: bool = True):
    prog = program_for(p, dev, state, lan_fail, wan_fail, lan_hist)
    return prog.run(state, base_key, lan_fail, wan_fail, steps, lan_hist,
                    cov)


def run_multidc_rounds(state: MultiDCState, base_key, lan_fail, wan_fail,
                       p: MultiDCParams, steps: int,
                       lan_hist: tuple | None = None, device=None,
                       graphed: bool | None = None, _cov: bool = True):
    """``steps`` rounds (reference ``run_multidc_rounds``): returns
    ``(state, cov)``, or ``((state, lan_hist), cov)`` with ``lan_hist``;
    ``cov`` is the per-round [steps, D, E] event coverage.  On a card the
    rounds are replays of ``MultiDCProgram``'s graphs; ``graphed=False``
    runs the eager rounds there instead (the plain version, bit-identical;
    the CPU always runs it)."""
    dev = resolve_device(device)
    if graphed is None:
        graphed = dev.type == "cuda"
    if graphed and dev.type != "cuda":
        raise ValueError(f"graphed rounds run on a CUDA card, not {dev}")
    state, lan_fail, wan_fail, lan_hist = _inputs(state, lan_fail, wan_fail,
                                                  lan_hist, p, dev,
                                                  own=not graphed)
    run = _run_graphed if graphed else _run_eager
    state, lan_hist, cov = run(state, base_key, lan_fail, wan_fail, p, steps,
                               lan_hist, dev, _cov)
    return ((state, lan_hist) if lan_hist is not None else state), cov
