"""The port's gossip plane (consul_tpu_torch/gossip/plane.py) against the
reference's (consul_tpu/gossip/plane.py) on the CPU.

- Lockstep: both planes with the same config and key, driven by one
  script with no client sockets (registrations through ``_register``
  with writers that record every frame).  After every ``_dispatch``
  their ``SwimState``, ``EventState``, ``FlightRing``, ``HistBank`` (and
  under a nemesis scenario ``NemState``) are equal (tolerance 0) and
  every recorded frame is byte-identical; the stats, members, slo and
  event-coverage surfaces agree too.  Without a scenario, and under
  ``degraded_observer`` and ``partition_heal``, at 1 and 2 shards.
- Socket round trip: the JAX package's agent-side backend
  (``TpuSerfPool``) against the port's plane: join visibility and a user
  event.
- The full flows of tests/test_tpu_backend.py against the port's plane
  (``slow``): abrupt death, graceful leave, failed-node rejoin, keyring
  auth."""

import asyncio
import base64
import time

import jax
import numpy as np
import pytest

from consul_tpu.agent.keyring import Keyring
from consul_tpu.gossip import plane as jplane
from consul_tpu.membership.serf import SerfConfig
from consul_tpu.membership.swim import (EV_FAILED, EV_JOIN, EV_LEAVE,
                                        STATE_ALIVE, STATE_DEAD)
from consul_tpu.membership.tpu_backend import TpuSerfPool
from consul_tpu_torch.gossip import convert
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip import plane as tplane

pytestmark = pytest.mark.timeout_s(300)


class _Recorder:
    """A bridge writer that keeps every frame it is sent."""

    def __init__(self):
        self.frames = []

    def write(self, raw):
        self.frames.append(bytes(raw))

    def close(self):
        pass


def _config(mod, ndev, nemesis=""):
    kw = dict(bind_port=0, capacity=32, sim_nodes=2968, slots=16,
              gossip_interval_s=0.02, probe_every=5, suspicion_mult=1.0,
              hb_lapse_s=0.3, event_slots=8, shard_devices=ndev,
              dissem="swar", hot_slots=0, fused_nb=1, unroll=1,
              flight_drain_every=2, nemesis=nemesis)
    if mod is tplane:
        kw["device"] = "cpu"
    return mod.PlaneConfig(**kw)


def _np_fields(tup):
    return {f: np.asarray(getattr(tup, f)) for f in tup._fields}


class _Lockstep:
    """One script, two planes: every step is applied to both, and every
    dispatch is followed by the comparison."""

    def __init__(self, ndev, nemesis=""):
        self.loop = asyncio.new_event_loop()
        self.ref = jplane.GossipPlane(_config(jplane, ndev, nemesis))
        self.port = tplane.GossipPlane(_config(tplane, ndev, nemesis))
        for plane in (self.ref, self.port):
            self.loop.run_until_complete(plane.start())
            # The script dispatches; the wall-clock ticker must not.
            plane._tick_task.cancel()
        key = jax.random.PRNGKey(20260)
        self.ref._key = key
        self.port._key = convert.key_from_numpy(np.asarray(key))
        self.writers = {}
        self.dispatches = 0

    def close(self):
        for plane in (self.ref, self.port):
            self.loop.run_until_complete(plane.stop())
        self.loop.close()

    def register(self, name):
        msg = {"t": "register", "name": name, "addr": "127.0.0.1",
               "port": 7000 + len(self.writers), "tags": {"role": "node"}}
        pair = (_Recorder(), _Recorder())
        self.writers[name] = pair
        r = self.ref._register(dict(msg), pair[0])
        p = self.port._register(dict(msg), pair[1])
        assert r[1] == p[1] == "" and r[0].id == p[0].id

    def node(self, plane, name):
        return plane._nodes_by_name[name]

    def dispatch(self):
        self.ref._dispatch()
        self.port._dispatch()
        self.dispatches += 1
        self.check(f"dispatch {self.dispatches}")

    def check(self, where):
        ref, port = self.ref, self.port
        pairs = ((ref._state, port._state), (ref._ev_state, port._ev_state),
                 (ref._flight, port._flight), (ref._hist, port._hist))
        assert (ref._nem_state is None) == (port._nem_state is None), where
        if ref._nem_state is not None:
            pairs += ((ref._nem_state, port._nem_state),)
        for a, b in pairs:
            want, got = _np_fields(a), convert.state_to_numpy(b)
            assert set(want) == set(got)
            for f in want:
                assert want[f].dtype == got[f].dtype, (where, f)
                assert np.array_equal(want[f], got[f]), (where, f)
        for name, (wr, wp) in self.writers.items():
            assert wr.frames == wp.frames, (where, name)
        assert np.array_equal(ref._fail, port._fail), where
        assert np.array_equal(ref._join, port._join), where
        assert ref._rounds_done == port._rounds_done

    def surfaces(self):
        ref, port = self.ref, self.port
        assert ref._stats_wire() == port._stats_wire()
        assert ref.members_wire() == port.members_wire()
        assert ref._slo_wire() == port._slo_wire()
        assert ref.event_coverage() == port.event_coverage()

    def statuses(self, name):
        return tuple(self.node(p, name).status for p in (self.ref,
                                                         self.port))

    def dispatch_until(self, cond, limit=80):
        for _ in range(limit):
            if cond():
                return
            self.dispatch()
        raise AssertionError(f"not reached in {limit} dispatches")


@pytest.mark.parametrize("ndev", [1, 2])
def test_plane_lockstep_with_reference(ndev, monkeypatch):
    # The journey ledger stamps evbatch events with host clock times;
    # off, so frames compare byte for byte.
    monkeypatch.setattr(jplane._journey, "journey", None)
    monkeypatch.setattr(tplane._journey, "journey", None)
    ls = _Lockstep(ndev)
    try:
        assert ls.ref._ndev == ls.port._ndev == ndev
        names = [f"n{i}" for i in range(6)]
        for name in names:
            ls.register(name)
        ls.check("registered")
        ls.dispatch_until(lambda: all(
            ls.statuses(n) == ("alive", "alive") for n in names))
        # Lapse two nodes: the others heartbeat, n4's and n5's
        # heartbeats stop, and both start failing probes.
        now = time.monotonic()
        for plane in (ls.ref, ls.port):
            for name in names:
                plane._hb_at[ls.node(plane, name).id] = (
                    now - 10.0 if name in ("n4", "n5") else now)
            plane._mark_lapsed()
        ls.dispatch_until(lambda: all(
            ls.statuses(n) == ("failed", "failed") for n in ("n4", "n5")))
        assert all(ls.statuses(n) == ("alive", "alive") for n in names[:4])
        # Two user events, from n0 and n1.
        for plane in (ls.ref, ls.port):
            for name in ("n0", "n1"):
                node = ls.node(plane, name)
                plane._fire_queue.append((node.id, {
                    "name": f"deploy-{name}", "payload": b"v2",
                    "coalesce": True, "from": name}))
        ls.dispatch()
        ls.dispatch()
        assert ls.port.event_coverage() and ls.port._ev_meta
        ls.surfaces()
        # n3 leaves; n4 is force-left; n5's heartbeats resume (re-admit).
        for plane in (ls.ref, ls.port):
            n3, n4, n5 = (ls.node(plane, n) for n in ("n3", "n4", "n5"))
            plane._evict(n3, "left")
            plane._broadcast_member_event(jplane.EV_LEAVE, n3)
            plane._evict(n4, "left")
            plane._broadcast_member_event(jplane.EV_LEAVE, n4)
            plane._hb_at[n5.id] += 10.0
            plane._admit(n5)
        ls.check("left and re-admitted")
        ls.dispatch_until(lambda: ls.statuses("n5") == ("alive", "alive"))
        # n4 registers again under its left name.
        ls.register("n4")
        ls.dispatch_until(lambda: ls.statuses("n4") == ("alive", "alive"))
        for _ in range(3):
            ls.dispatch()
        ls.surfaces()
        st = ls.port._stats_wire()
        assert st["members"] == {"alive": 5, "failed": 0, "left": 1,
                                 "joining": 0}
        assert st["kernel"]["n_detected"] >= 2
    finally:
        ls.close()


@pytest.mark.parametrize("ndev", [1, 2])
@pytest.mark.parametrize("nemesis", ["degraded_observer", "partition_heal"])
def test_plane_nemesis_lockstep_with_reference(nemesis, ndev, monkeypatch):
    """Both planes under a nemesis scenario through 200 rounds (the
    partition's window [40, 160) and its heal; the degraded observers'
    kills at round 30): every state field, NemState and frame after each
    dispatch, and the slo frame's ``scenario``/``scenarios``."""
    monkeypatch.setattr(jplane._journey, "journey", None)
    monkeypatch.setattr(tplane._journey, "journey", None)
    ls = _Lockstep(ndev, nemesis)
    try:
        assert ls.port._nem == t_nem.build(nemesis,
                                           ls.port.n_universe).nem
        assert (ls.ref._nem_fail is None) == (ls.port._nem_fail is None)
        names = [f"n{i}" for i in range(10)]
        for name in names:
            ls.register(name)
        while ls.dispatches < 50:
            ls.dispatch()
        ls.surfaces()
        slo = ls.port._slo_wire()
        assert slo["scenario"] == nemesis
        assert set(slo["scenarios"]) == {nemesis}
        kernel = ls.port._stats_wire()["kernel"]
        if nemesis == "partition_heal":
            # Each half declared members of the other dead.
            assert kernel["n_false_dead"] > 0
        else:
            # Id 7 (an agent) is among the scenario's kills at round 30.
            assert kernel["n_detected"] > 0
            assert ls.statuses("n7") == ("failed", "failed")
            assert int(ls.port._nem_state.lhm.max()) > 0
    finally:
        ls.close()



# -- the agents' backend against the port's plane over sockets --------------

async def _wait(cond, timeout=20.0, interval=0.02):
    deadline = asyncio.get_event_loop().time() + timeout
    while asyncio.get_event_loop().time() < deadline:
        if cond():
            return True
        await asyncio.sleep(interval)
    return cond()


def _fast_cfg(name):
    return SerfConfig(node_name=name, bind_addr="127.0.0.1",
                      tags={"role": "node", "dc": "dc1"},
                      probe_interval=0.05, probe_timeout=0.02,
                      gossip_interval=0.02, suspicion_mult=3.0,
                      push_pull_interval=1.0)


class Cluster:
    """tests/test_tpu_backend.py's harness, with the port's plane."""

    def __init__(self, use_native=True, **plane_kw):
        self.plane = None
        self.pools = {}
        self.events = {}
        self.use_native = use_native
        self.plane_kw = plane_kw

    @property
    def addr(self):
        return "127.0.0.1:%d" % self.plane.local_addr[1]

    async def start(self, names):
        kw = dict(bind_port=0, capacity=32, slots=16,
                  gossip_interval_s=0.02, probe_every=5,
                  suspicion_mult=1.0, hb_lapse_s=0.3, device="cpu")
        kw.update(self.plane_kw)
        self.plane = tplane.GossipPlane(tplane.PlaneConfig(**kw))
        await self.plane.start()
        for name in names:
            await self.add(name)

    async def add(self, name, **kw):
        ev = []
        self.events[name] = ev
        pool = TpuSerfPool(_fast_cfg(name),
                           on_event=lambda k, p, _ev=ev: _ev.append((k, p)),
                           plane_addr=self.addr, use_native=self.use_native,
                           **kw)
        await pool.start()
        self.pools[name] = pool
        return pool

    async def kill(self, name):
        """Abrupt death: the bridge closes, heartbeats stop."""
        await self.pools.pop(name).stop()
        self.events.pop(name, None)

    async def stop(self):
        for pool in self.pools.values():
            await pool.stop()
        if self.plane is not None:
            await self.plane.stop()

    def alive(self, viewer):
        return {n.name for n in self.pools[viewer].members()
                if n.state == STATE_ALIVE}


def _run(body):
    loop = asyncio.new_event_loop()
    try:
        loop.run_until_complete(body())
    finally:
        loop.close()


def test_agents_join_and_user_event_over_sockets():
    async def body():
        c = Cluster(use_native=False)
        try:
            await c.start(["a", "b"])
            for viewer in ("a", "b"):
                assert await _wait(lambda v=viewer: c.alive(v) >= {"a", "b"})
            c.pools["a"].user_event("deploy", b"v2")
            assert await _wait(lambda: any(
                k == "user" and p.get("name") == "deploy"
                and p.get("payload") == b"v2" for k, p in c.events["b"]))
            assert c.plane.event_coverage()
        finally:
            await c.stop()
    _run(body)


@pytest.mark.slow
def test_abrupt_death_detected():
    async def body():
        c = Cluster()
        try:
            await c.start(["a", "b", "c"])
            assert await _wait(lambda: len(c.pools["a"].alive_members()) == 3)
            await c.kill("c")
            assert await _wait(lambda: any(
                k == EV_FAILED and n.name == "c"
                for k, n in c.events["a"]), timeout=30.0)
            states = {n.name: n.state for n in c.pools["a"].members()}
            assert states.get("c") == STATE_DEAD
            # Only c failed, and nothing was declared dead by mistake.
            assert not any(k == EV_FAILED and n.name != "c"
                           for k, n in c.events["a"])
            assert c.plane._stats_wire()["kernel"]["n_false_dead"] == 0
        finally:
            await c.stop()
    _run(body)


@pytest.mark.slow
def test_graceful_leave():
    async def body():
        c = Cluster()
        try:
            await c.start(["a", "b"])
            assert await _wait(lambda: len(c.pools["a"].alive_members()) == 2)
            await c.pools["b"].leave()
            assert await _wait(lambda: any(
                k == EV_LEAVE and n.name == "b" for k, n in c.events["a"]))
            assert not any(k == EV_FAILED and n.name == "b"
                           for k, n in c.events["a"])
        finally:
            await c.stop()
    _run(body)


@pytest.mark.slow
def test_failed_node_rejoins():
    async def body():
        c = Cluster()
        try:
            await c.start(["a", "b"])
            assert await _wait(lambda: len(c.pools["a"].alive_members()) == 2)
            await c.kill("b")
            assert await _wait(lambda: any(
                k == EV_FAILED and n.name == "b"
                for k, n in c.events["a"]), timeout=30.0)
            await c.add("b")
            assert await _wait(lambda: any(
                k == EV_JOIN and n.name == "b" for k, n in c.events["a"]))
            assert await _wait(lambda: "b" in c.alive("a"))
        finally:
            await c.stop()
    _run(body)


@pytest.mark.slow
def test_keyring_auth():
    key = base64.b64encode(b"0123456789abcdef").decode()
    wrong = base64.b64encode(b"fedcba9876543210").decode()

    async def body():
        c = Cluster(use_native=False, capacity=8, slots=8,
                    encrypt_keys=[key])
        await c.start([])
        try:
            bare = TpuSerfPool(_fast_cfg("bare"), plane_addr=c.addr,
                               use_native=False)
            with pytest.raises(ConnectionError, match="authentication"):
                await bare._connect(c.addr)
            liar = TpuSerfPool(_fast_cfg("liar"),
                               keyring=Keyring(initial_key=wrong),
                               plane_addr=c.addr, use_native=False)
            with pytest.raises(ConnectionError, match="authentication"):
                await liar._connect(c.addr)
            assert not c.plane._nodes_by_name
            await c.add("good", keyring=Keyring(initial_key=key))
            assert await _wait(lambda: any(
                k == EV_JOIN and n.name == "good"
                for k, n in c.events["good"]))
        finally:
            await c.stop()
    _run(body)
