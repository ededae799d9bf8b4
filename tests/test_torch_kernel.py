"""The port's SWIM round (consul_tpu_torch/gossip/kernel.py) against the
reference's ``run_rounds``/``swim_round`` on the CPU: every field of the
carry (state, flight ring, hist banks) and of the ``RoundTrace``,
bit-identical, in every regime with a distinct code path.

The reference runs its XLA SWAR tail (``dissem="swar"``), and in one
regime its Pallas kernel in interpret mode (``dissem="fused"``); the
port runs its plain torch tail on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip import params as j_params
from consul_tpu.gossip.params import SwimParams as JParams
from consul_tpu.gossip.params import lan_profile as j_lan
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import params as t_params
from consul_tpu_torch.gossip.params import SwimParams as TParams
from consul_tpu_torch.gossip.params import lan_profile as t_lan

pytestmark = pytest.mark.timeout_s(600)

NEVER = 2**31 - 1
# The reference's scan unroll: results do not depend on it, and at 1 XLA
# compiles each regime in about two thirds of the default's time.
UNROLL = 1


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """Each case compiles the reference's scan once and runs it briefly,
    so compiling is the cost: compile with XLA's optimisations off
    (about a third quicker; the results are the same integers)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)

# The regimes of tests/test_fused_parity.py (healthy, churn, loss,
# push/pull, hot tier): name -> (params, [(node, fail_round), ...]).
REGIMES = {
    "healthy": (dict(), []),
    "churn": (dict(), [(40, 20), (90, 35), (170, 50), (230, 65)]),
    "loss": (dict(loss_rate=0.1), [(40, 20), (170, 50)]),
    "pushpull": (dict(pushpull_every=20, loss_rate=0.05),
                 [(40, 20), (170, 50)]),
    "hot_tier": (dict(hot_slots=4), [(40, 20), (170, 50)]),
}


def _fails(n, spec):
    f = np.full(n, NEVER, np.int32)
    for idx, rnd in spec:
        f[idx] = rnd
    return f


def _assert_equal(ref, port, ctx):
    """Every field of a reference NamedTuple equals the port's, dtype
    included."""
    assert type(ref).__name__ == type(port).__name__
    got = convert.state_to_numpy(port)
    for f in ref._fields:
        x = np.asarray(getattr(ref, f))
        assert x.dtype == got[f].dtype, f"{ctx}{f}: {x.dtype} vs {got[f].dtype}"
        assert x.shape == got[f].shape, f"{ctx}{f}: shape"
        if not np.array_equal(x, got[f]):
            bad = np.argwhere(x != got[f])[:3] if x.ndim else "scalar"
            raise AssertionError(f"{ctx}{type(ref).__name__}.{f} diverged "
                                 f"at {bad}")


def _both(kw, fail, steps, seed=7, join=None, flight=False, hist=False,
          fused=False):
    """Run the reference and the port from the same state and key with
    the same extras threaded; compare the whole carry and the trace."""
    n = len(fail)
    jp = JParams(n=n, **kw, dissem="fused" if fused else "swar")
    tp = TParams(n=n, **kw)
    jst, tst = jk.init_state(jp), tk.init_state(tp, device="cpu")
    jkw, tkw = {}, {}
    if join is not None:
        jst = jst._replace(member=jnp.asarray(join == NEVER))
        tst = tst._replace(member=torch.from_numpy(join == NEVER))
        jkw["join_round"], tkw["join_round"] = jnp.asarray(join), join
    if flight:
        jkw["flight"] = jk.init_flight()
        tkw["flight"] = tk.init_flight(device="cpu")
    if hist:
        jkw["hist"], tkw["hist"] = jk.init_hist(), tk.init_hist(device="cpu")
    jc, jtr = jk.run_rounds(jst, jax.random.PRNGKey(seed), jnp.asarray(fail),
                            jp, steps, trace=True, unroll=UNROLL, **jkw)
    tc, ttr = tk.run_rounds(tst, prng.PRNGKey(seed), fail, tp, steps,
                            trace=True, device="cpu", **tkw)
    if not (flight or hist):
        jc, tc = (jc,), (tc,)
    assert len(jc) == len(tc)
    for a, b in zip(jc, tc):
        _assert_equal(a, b, f"{sorted(kw)} ")
    _assert_equal(jtr, ttr, "trace ")
    return jc[0]


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_regime_parity(regime):
    """200 rounds at n=240, S=16 with the flight ring, hist banks and
    trace threaded."""
    kw, spec = REGIMES[regime]
    st = _both(dict(slots=16, probe_every=5, **kw), _fails(240, spec), 200,
               flight=True, hist=True)
    if spec:  # churny regimes must actually detect something
        assert int(st.n_detected) > 0


# Edge pools (the verify skill's probes): a two-node pool, slot overflow
# under mass failure, every node dead, refutation off under loss, and
# the WAN profile (fanout 4, probe every 10 rounds).  Each compiles its
# own reference scan (about 5 s on one core), so these, the WAN profile
# and lan_profile's own settings run outside tier-1 (``-m slow``).
EDGES = {  # name -> (params, failures, rounds, what the run must show)
    "n2": (dict(n=2, slots=4), [(1, 10)], 180,
           lambda st: int(st.n_detected) == 1),
    "slot_overflow": (dict(n=120, slots=4),
                      [(i, 10 + i % 7) for i in range(0, 120, 4)], 150,
                      lambda st: int(st.drops) > 0),
    "all_dead": (dict(n=40, slots=8), [(i, 5) for i in range(40)], 150,
                 lambda st: int(st.n_detected) == 0),
    "no_refute": (dict(n=120, slots=8, refute=False, loss_rate=0.25),
                  [(7, 20)], 150, lambda st: int(st.n_false_dead) > 0),
}


@pytest.mark.slow
@pytest.mark.parametrize("edge", sorted(EDGES))
def test_edge_pools(edge):
    kw, spec, steps, shows = EDGES[edge]
    kw = dict(kw)
    n = kw.pop("n")
    st = _both(dict(probe_every=5, **kw), _fails(n, spec), steps, hist=True)
    assert shows(st), edge


@pytest.mark.slow
def test_wan_profile():
    n = 200
    fail = _fails(n, [(11, 30), (150, 60)])
    jp = j_params.wan_profile(n, slots=8, hot_slots=2, loss_rate=0.05)
    tp = t_params.wan_profile(n, slots=8, hot_slots=2, loss_rate=0.05)
    jst, jtr = jk.run_rounds(jk.init_state(jp), jax.random.key(9),
                             jnp.asarray(fail), jp, 200, trace=True,
                             unroll=UNROLL)
    tst, ttr = tk.run_rounds(tk.init_state(tp, device="cpu"), prng.key(9),
                             fail, tp, 200, trace=True, device="cpu")
    _assert_equal(jst, tst, "wan ")
    _assert_equal(jtr, ttr, "wan trace ")


def test_parity_against_pallas_interpret():
    """The churn regime against the reference's Pallas kernel
    (interpret mode) instead of its XLA tail."""
    kw, spec = REGIMES["churn"]
    _both(dict(slots=16, probe_every=5, **kw), _fails(240, spec), 120,
          fused=True)


def test_unaligned_n():
    """n not a multiple of probe_every: the gather/scatter probe path."""
    st = _both(dict(slots=16, probe_every=5, loss_rate=0.05),
               _fails(242, [(40, 20), (100, 30), (241, 45)]), 200, hist=True)
    assert int(st.n_detected) > 0


def test_joins_flight_hist():
    """join_round, flight and hist all threaded, as the gossip plane's
    dispatch does, with loss, push/pull and the hot tier."""
    n = 240
    join = np.full(n, NEVER, np.int32)
    join[10:20] = 5
    join[100] = 50
    join[130:134] = 90
    st = _both(dict(slots=16, probe_every=5, loss_rate=0.05,
                    pushpull_every=20, hot_slots=4),
               _fails(n, [(40, 20), (170, 50), (131, 120)]), 200,
               join=join, flight=True, hist=True)
    assert bool(np.asarray(st.member)[10:20].all())


@pytest.mark.slow
def test_lan_profile_small():
    """lan_profile's own settings (hot tier 8, push/pull 150) past one
    push/pull round."""
    n = 160
    fail = _fails(n, [(3, 10), (77, 40), (120, 90), (151, 100)])
    jp, tp = j_lan(n, slots=16), t_lan(n, slots=16)
    key = 3
    jst, jtr = jk.run_rounds(jk.init_state(jp), jax.random.key(key),
                             jnp.asarray(fail), jp, 160, trace=True,
                             unroll=UNROLL)
    tst, ttr = tk.run_rounds(tk.init_state(tp, device="cpu"), prng.key(key),
                             fail, tp, 160, trace=True, device="cpu")
    _assert_equal(jst, tst, "lan ")
    _assert_equal(jtr, ttr, "lan trace ")


def test_entry_shape_swim_round():
    """``__graft_entry__.entry()``'s shape: lan_profile n=4096, S=32,
    8 failures at round 3; one swim_round, then a chain of rounds past
    the failures (through swim_round_hist)."""
    jp, tp = j_lan(4096, slots=32), t_lan(4096, slots=32)
    fail = np.full(jp.n, NEVER, np.int32)
    fail[:8] = 3
    jkey, tkey = jax.random.PRNGKey(0), prng.PRNGKey(0)
    jst = jk.swim_round(jk.init_state(jp), jkey, jnp.asarray(fail), jp)
    tst = tk.swim_round(tk.init_state(tp, device="cpu"), tkey, fail, tp,
                        device="cpu")
    _assert_equal(jst, tst, "entry ")
    jh, th = jk.init_hist(), tk.init_hist(device="cpu")
    j_round_hist = jax.jit(jk.swim_round_hist, static_argnums=(3,))
    for _ in range(12):
        jst, jh = j_round_hist(jst, jkey, jnp.asarray(fail), jp, jh)
        tst, th = tk.swim_round_hist(tst, tkey, fail, tp, th, device="cpu")
    _assert_equal(jst, tst, "entry chain ")
    _assert_equal(jh, th, "entry hist ")
    assert int(tst.round) == 13


def test_state_roundtrip_and_resume():
    """State exported from the reference mid-run and continued in the
    port ends where the reference ends, with failures on both sides of
    the hand-over.  (The loss regime's settings, extras and length, so
    the reference's compiled scan is reused.)"""
    kw, _ = REGIMES["loss"]
    n, steps = 240, 400
    fail = _fails(n, [(40, 20), (99, 190), (170, 230)])
    kw = dict(slots=16, probe_every=5, **kw)
    jp, tp = JParams(n=n, dissem="swar", **kw), TParams(n=n, **kw)
    key = jax.random.PRNGKey(5)
    run = dict(trace=True, unroll=UNROLL)
    (jst, jfl, jh), _ = jk.run_rounds(
        jk.init_state(jp), key, jnp.asarray(fail), jp, steps // 2,
        flight=jk.init_flight(), hist=jk.init_hist(), **run)
    tst, tfl, th = (convert.state_from_numpy(
        {f: np.asarray(getattr(x, f)) for f in x._fields}, "cpu")
        for x in (jst, jfl, jh))
    assert isinstance(tst, tk.SwimState) and isinstance(tfl, tk.FlightRing)
    assert isinstance(th, tk.HistBank)
    tkey = convert.key_from_numpy(jax.random.key_data(key))
    (jst, jfl, jh), _ = jk.run_rounds(jst, key, jnp.asarray(fail), jp,
                                      steps // 2, flight=jfl, hist=jh, **run)
    (tst, tfl, th), _ = tk.run_rounds(tst, tkey, fail, tp, steps // 2,
                                      flight=tfl, hist=th, trace=True,
                                      device="cpu")
    _assert_equal(jst, tst, "resumed ")
    _assert_equal(jfl, tfl, "resumed flight ")
    _assert_equal(jh, th, "resumed hist ")


def test_run_rounds_leaves_inputs_intact():
    """The port never writes the caller's tensors (the reference donates
    them instead)."""
    tp = TParams(n=120, slots=8, probe_every=5)
    st = tk.init_state(tp, device="cpu")
    before = {f: t.clone() for f, t in zip(st._fields, st)}
    fail = _fails(120, [(5, 3), (50, 4)])
    out, _ = tk.run_rounds(st, prng.key(1), fail, tp, 60, device="cpu")
    assert int(out.round) == 60 and int(out.n_detected) > 0
    for f, t in zip(st._fields, st):
        assert torch.equal(t, before[f]), f
