"""The port's multi-DC gossip (consul_tpu_torch/gossip/multidc.py) against
the reference's (consul_tpu/gossip/multidc.py) on the CPU, tolerance 0:
every field of the LAN pools, their event pools, the WAN pool and its
event pool, the per-DC hist banks and the [steps, D, E] coverage trace,
through ``convert.multidc_to_numpy``.  Events are fired before the run
and in the middle of it, past the last free slot; LAN pools run on one
device and on 2 column shards (the reference's ``lan_devices=2`` on two
of the 8 CPU mesh devices), with the hot tier on and off.

Then the reference's multi-DC behaviour tests (tests/test_gossip_events.py,
``TestMultiDC``) on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.gossip import multidc as jm
from consul_tpu.gossip.kernel import NEVER
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert
from consul_tpu_torch.gossip import multidc as tm

pytestmark = pytest.mark.timeout_s(600)

STEPS = 60  # per half: the reference compiles one scan for both halves


def _ref_np(st) -> dict:
    return {pool: {f: np.asarray(getattr(getattr(st, pool), f))
                   for f in getattr(st, pool)._fields}
            for pool in ("lan", "lan_events", "wan", "wan_events")}


def _diff(a: dict, b: dict, where: str) -> list:
    out = []
    for k in a:
        if isinstance(a[k], dict):
            out += _diff(a[k], b[k], f"{where}.{k}")
        elif a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
            out.append(f"{where}.{k}")
    assert set(a) == set(b), where
    return out


def _fail_rounds(D: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    lan = np.full((D, n), NEVER, np.int32)
    for d in range(D):
        # Servers (ids 0-2) fail too in the last DC: the bridge then runs
        # through fewer live relays.
        ids = rng.choice(np.arange(1 if d == D - 1 else 3, n), 4, False)
        lan[d, ids] = rng.integers(5, 2 * STEPS, 4)
    wan = np.full((D * 3,), NEVER, np.int32)
    wan[4] = 15
    return lan, wan


# (D, n_lan, hot_slots, lan_devices, with hist)
CASES = [(2, 160, 0, 0, True), (3, 320, 8, 1, False),
         (2, 320, 8, 2, True), (2, 160, 0, 2, False)]


@pytest.mark.parametrize("D,n,hot,ndev,hist", CASES)
def test_multidc_matches_reference(D, n, hot, ndev, hist):
    kw = dict(event_slots=2, lan_devices=ndev, slots=8, hot_slots=hot)
    jp, tp = jm.make_params(D, n, **kw), tm.make_params(D, n, **kw)
    lan_fail, wan_fail = _fail_rounds(D, n, seed=D * n + hot)
    jl, jw = jnp.asarray(lan_fail), jnp.asarray(wan_fail)
    jkey, tkey = jax.random.key(7), prng.key(7)

    js, ts = jm.init_multidc(jp), tm.init_multidc(tp, device="cpu")
    jh = jm.init_multidc_hist(jp) if hist else None
    th = tm.init_multidc_hist(tp, device="cpu") if hist else None
    # Before the run: one event in DC 0.  Mid-run: one more in the last
    # DC, at a server, takes the other slot, and the next overflows.
    fires = [[(0, n // 2)], [(D - 1, 1), (0, 7)]]
    covs = []
    for half in fires:
        for dc, node in half:
            js = jm.fire_in_dc(js, dc, node, jp)
            ts = tm.fire_in_dc(ts, dc, node, tp)
        assert not _diff(_ref_np(js), convert.multidc_to_numpy(ts), "fired")
        jo, jc = jm.run_multidc_rounds(js, jkey, jl, jw, jp, STEPS,
                                       lan_hist=jh)
        to, tc = tm.run_multidc_rounds(ts, tkey, lan_fail, wan_fail, tp,
                                       STEPS, lan_hist=th, device="cpu")
        (js, jh), (ts, th) = (jo, to) if hist else ((jo, None), (to, None))
        covs.append((np.asarray(jc), tc.numpy()))
    bad = _diff(_ref_np(js), convert.multidc_to_numpy(ts), "state")
    if hist:
        bad += _diff({f: np.asarray(getattr(jh, f)) for f in jh._fields},
                     convert.hist_banks_to_numpy(th), "hist")
    bad += [f"coverage[{i}]" for i, (a, b) in enumerate(covs)
            if a.shape != b.shape or a.dtype != b.dtype
            or not np.array_equal(a, b)]
    if not np.array_equal(np.asarray(jm.event_coverage(js)),
                          tm.event_coverage(ts).numpy()):
        bad.append("event_coverage")
    assert not bad, bad
    # The run exercised what it is for: detections in every DC, the mid-
    # run overflow, events bridged into every DC.
    assert all(int(st.n_detected) > 0 for st in ts.lan)
    assert all(int(ev.drops) == 1 for ev in ts.lan_events)
    assert (covs[0][1][-1, :, 0] > 0).all()
    if ndev > 1:
        assert all(len(st.heard) == ndev for st in ts.lan)


def test_round_and_state_round_trip():
    """multidc_round (one step, with and without hist) equals the
    reference's, and multidc_from_numpy/multidc_to_numpy round-trip the
    reference's stacked state, sharded or not (the hist banks through
    hist_banks_from_numpy/hist_banks_to_numpy)."""
    p_kw = dict(event_slots=4, slots=8)
    jp, tp = jm.make_params(2, 160, **p_kw), tm.make_params(2, 160, **p_kw)
    js = jm.fire_in_dc(jm.init_multidc(jp), 1, 30, jp)
    lan_fail = np.full((2, 160), NEVER, np.int32)
    lan_fail[0, 40] = 0
    wan_fail = np.full((6,), NEVER, np.int32)
    key = jax.random.key(3)
    for _ in range(3):
        js = jm.multidc_round(js, key, jnp.asarray(lan_fail),
                              jnp.asarray(wan_fail), jp)
    arrays = _ref_np(js)
    for ndev in (0, 2):
        ts = convert.multidc_from_numpy(arrays, device="cpu",
                                        lan_devices=ndev)
        assert not _diff(arrays, convert.multidc_to_numpy(ts), "round trip")
        jh = jm.init_multidc_hist(jp)
        jh_np = {f: np.asarray(getattr(jh, f)) for f in jh._fields}
        th = convert.hist_banks_from_numpy(jh_np, "cpu")
        assert not _diff(jh_np, convert.hist_banks_to_numpy(th),
                         "hist round trip")
        jo, jh = jm.multidc_round(js, key, jnp.asarray(lan_fail),
                                  jnp.asarray(wan_fail), jp, jh)
        to, th = tm.multidc_round(ts, prng.key(3), lan_fail, wan_fail,
                                  tm.make_params(2, 160, lan_devices=ndev,
                                                 **p_kw), th, device="cpu")
        assert not _diff(_ref_np(jo), convert.multidc_to_numpy(to), "round")
        assert not _diff({f: np.asarray(getattr(jh, f)) for f in jh._fields},
                         convert.hist_banks_to_numpy(th), "hist")


@pytest.mark.parametrize("n_lan,ndev", [(161, 2), (162, 2), (160, 3)])
def test_misaligned_lan_devices_raise(n_lan, ndev):
    """The port refuses at make_params what the reference refuses at its
    first round, with the same message."""
    jp = jm.make_params(2, n_lan, lan_devices=ndev)
    with pytest.raises(ValueError) as a:
        jm.run_multidc_rounds(jm.init_multidc(jp), jax.random.key(0),
                              jnp.full((2, n_lan), NEVER, jnp.int32),
                              jnp.full((6,), NEVER, jnp.int32), jp, 1)
    with pytest.raises(ValueError) as b:
        tm.make_params(2, n_lan, lan_devices=ndev)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("n,ndev", [(161, 2), (162, 2), (160, 0)])
def test_sharded_round_callable_raises_as_the_reference(n, ndev):
    from consul_tpu.gossip import kernel as jk
    from consul_tpu.gossip.params import lan_profile as j_lan
    from consul_tpu_torch.gossip import kernel as tk
    from consul_tpu_torch.gossip.params import lan_profile as t_lan
    with pytest.raises(ValueError) as a:
        jk.sharded_round_callable(j_lan(n), ndev)
    with pytest.raises(ValueError) as b:
        tk.sharded_round_callable(t_lan(n), ndev)
    assert str(a.value) == str(b.value)


def test_fire_overflow_counts_in_every_dc():
    p = tm.make_params(3, 64, event_slots=1)
    st = tm.fire_in_dc(tm.init_multidc(p, device="cpu"), 2, 5, p)
    st = tm.fire_in_dc(st, 0, 6, p)
    assert [int(ev.drops) for ev in st.lan_events] == [1, 1, 1]
    assert [int(ev.origin[0]) for ev in st.lan_events] == [-1, -1, 5]
    assert int(st.wan_events.origin[0]) == -1
    assert bool(st.wan_events.slot_used[0])


# -- the reference's behaviour tests, on the port ------------------------------

def _fails(p, lan=(), wan=()):
    lan_fail = np.full((p.n_dcs, p.n_lan), NEVER, np.int32)
    for (d, i), t in lan:
        lan_fail[d, i] = t
    wan_fail = np.full((p.n_dcs * p.n_servers,), NEVER, np.int32)
    for i, t in wan:
        wan_fail[i] = t
    return lan_fail, wan_fail


def test_event_crosses_datacenters():
    p = tm.make_params(n_dcs=3, n_lan=128, n_servers=3, event_slots=4)
    st = tm.fire_in_dc(tm.init_multidc(p, device="cpu"), dc=0, node=50, p=p)
    st, cov = tm.run_multidc_rounds(st, prng.key(6), *_fails(p), p, steps=60,
                                    device="cpu")
    cov = cov.numpy()
    peak = cov.max(axis=0)  # [D, E] best live coverage
    # the event covered every DC, not just its origin
    assert (peak[:, 0] == 1.0).all(), peak[:, 0]
    # origin DC converged no later than remote DCs
    origin_half = int(np.argmax(cov[:, 0, 0] >= 0.5))
    remote_half = int(np.argmax(cov[:, 1, 0] >= 0.5))
    assert origin_half <= remote_half


def test_lan_failure_detected_per_dc():
    p = tm.make_params(n_dcs=2, n_lan=128, n_servers=3, event_slots=2)
    st, _ = tm.run_multidc_rounds(tm.init_multidc(p, device="cpu"),
                                  prng.key(7), *_fails(p, lan=[((1, 60), 10)]),
                                  p, steps=400, device="cpu")
    # DC1 detected its dead node; DC0 membership untouched
    assert int(st.lan[1].n_detected) == 1
    assert not bool(st.lan[1].member[60])
    assert int(st.lan[0].n_detected) == 0
    assert bool(st.lan[0].member.all())


def test_wan_server_failure_detected():
    p = tm.make_params(n_dcs=3, n_lan=64, n_servers=3, event_slots=2)
    st, _ = tm.run_multidc_rounds(tm.init_multidc(p, device="cpu"),
                                  prng.key(8), *_fails(p, wan=[(4, 20)]),
                                  p, steps=800, device="cpu")
    assert int(st.wan.n_detected) == 1
    assert not bool(st.wan.member[4])
    assert isinstance(st.wan.member, torch.Tensor)
