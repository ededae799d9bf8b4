"""The port's sharded round on the CPU, tolerance 0 everywhere.

- the shard helpers (``_roll_sharded``, ``_sloc_roll``, the probe
  tick's point reads ``slot_ops.get_points``; the shifts on the host and as
  device values) against plain torch on the concatenated matrix;
- kernel 2's plain version ``fused.merge_ref`` against the reference's
  ``_age_u8``/``_merge`` composed as ``_fused_sharded``'s body;
- the sharded dissemination tail against the reference's
  ``fused_disseminate(..., sc=_ShardCtx(8, L))`` under ``shard_map`` on
  the 8-device CPU mesh (its Pallas kernel in interpret mode);
- ``run_rounds_sharded(ndev=8)`` against the reference's, every field of
  the carry and the trace;
- the port's sharded round against its own single-device round for
  ndev in {1, 2, 4, 8} across the regimes with distinct code paths.

Failures, joins and pools are placed so that subjects and prober
windows sit on shard boundaries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as Ps

from consul_tpu.gossip import fused as j_fused
from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip.params import SwimParams as JParams
from consul_tpu.gossip.params import lan_profile as j_lan
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert, fused, round_args, slot_ops
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip.params import SwimParams as TParams
from consul_tpu_torch.gossip.params import lan_profile as t_lan

pytestmark = pytest.mark.timeout_s(600)

NEVER = 2**31 - 1
UNROLL = 1  # as tests/test_torch_kernel.py: the results do not depend on it


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """Compile the reference with XLA's optimisations off (the same
    integers, about a third quicker), as tests/test_torch_kernel.py."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _split(x: torch.Tensor, ndev: int):
    L = x.shape[-1] // ndev
    return tuple(x[..., i * L:(i + 1) * L].contiguous() for i in range(ndev))


def _bytes(shape, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8))


# -- (a) the shard helpers ----------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 8])
def test_roll_sharded_matches_roll(ndev):
    L = 7
    N = ndev * L
    x = _bytes((3, N), seed=ndev)
    v = torch.arange(N, dtype=torch.int32) * 3 - 5
    sc = tk._ShardCtx(ndev, L)
    xs = _split(x, ndev)
    rng = np.random.default_rng(100 + ndev)
    shifts = sorted({0, 1, L - 1, L, L + 1, N - 1, N, -1, -L - 2, 3 * N + 2}
                    | set(rng.integers(-2 * N, 2 * N, 6).tolist()))
    for o in shifts:
        want = torch.roll(x, o, dims=1)
        vr = torch.roll(v, o)
        # The shift as a device value, as the round's row holds it.
        s = torch.tensor(o, dtype=torch.int32)
        assert torch.equal(torch.cat(tk._roll_sharded(sc, xs, s), dim=1),
                           want), o
        out = tuple(torch.empty_like(h) for h in xs)
        tk._roll_sharded(sc, xs, s, out=out)
        assert torch.equal(torch.cat(out, dim=1), want), o
        assert torch.equal(tk._roll(x, s, 1), want), o
        for i in range(ndev):
            assert torch.equal(tk._sloc_roll(sc, v, s, i),
                               vr[i * L:(i + 1) * L]), (o, i)
            assert torch.equal(tk._sloc(sc, v, i), v[i * L:(i + 1) * L])


# (N, ndev, probe_every): windows of B = N / probe_every columns inside
# one shard, across two, across three (B = 128, L = 80 is n = 640 on 8
# shards; B = 8, L = 5 has the shape of 1M on 8 shards, 200,000 / 125,000).
WINDOW_POOLS = [(40, 2, 4), (40, 4, 5), (640, 8, 5), (40, 8, 5), (48, 3, 4)]


def _shards_spanned(N, ndev, blk, B):
    L = N // ndev
    return len({c // L for c in range(blk, blk + B)})


def test_window_pools_cover_one_two_and_three_shards():
    spans = {_shards_spanned(N, nd, k * (N // pe), N // pe)
             for N, nd, pe in WINDOW_POOLS for k in range(pe)}
    assert {1, 2, 3} <= spans


@pytest.mark.parametrize("pool", WINDOW_POOLS)
def test_window_read_write_match_slicing(pool):
    """The probe tick's reads in the prober window of the sharded matrix
    (``slot_ops.get_points``: one byte a prober column, at any slot row) equal
    the unsharded matrix's, whichever shards the window spans."""
    N, ndev, probe_every = pool
    B = N // probe_every
    x = _bytes((6, N), seed=N + ndev)
    xs = _split(x, ndev)
    rng = np.random.default_rng(N)
    for k in range(probe_every):
        cols = k * B + torch.arange(B)
        rows = torch.from_numpy(rng.integers(0, 6, B))
        assert torch.equal(slot_ops.get_points(xs, rows, cols),
                           x[rows, cols]), k


# -- (b) kernel 2's plain version ---------------------------------------------

def _merge_inputs(F, S, L, seed):
    """Every byte value in cur and the pins (every message, confirmation
    count and age, the fresh sentinel included); senders dead, alive and
    non-member; receivers on and off; caps 0..3."""
    rng = np.random.default_rng(seed)
    rnd = 50
    cur = rng.integers(0, 256, (S, L)).astype(np.uint8)
    pins = rng.integers(0, 256, (F, S, L)).astype(np.uint8)
    mf = rng.choice(np.asarray([-1, 10, 200, NEVER], np.int32), (F, L))
    src = mf > rnd
    rx = rng.random(L) < 0.9
    cap = rng.integers(0, 4, (S,)).astype(np.int32)
    return cur, pins, src, rx, cap


def _reference_merge(jp, cur, pins, src, rx, cap):
    """``_fused_sharded``'s Pallas body, outside the kernel."""
    i32 = jnp.int32
    out = j_fused._merge(
        jp, j_fused._age_u8(jnp.asarray(cur, i32)),
        [j_fused._age_u8(jnp.asarray(p, i32)) for p in pins],
        [jnp.asarray(s, i32)[None, :] for s in src],
        jnp.asarray(rx, i32)[None, :], jnp.asarray(cap, i32)[:, None])
    return np.asarray(out.astype(jnp.uint8))


@pytest.mark.parametrize("shape", [(4, 24), (8, 125), (16, 40), (3, 1001)])
@pytest.mark.parametrize("kw", [dict(), dict(fanout=1), dict(fanout=4),
                                dict(retransmit_mult=1.0)])
def test_merge_ref_matches_reference_body(shape, kw):
    S, L = shape
    jp, tp = JParams(n=8 * L, slots=S, **kw), TParams(n=8 * L, slots=S, **kw)
    cur, pins, src, rx, cap = _merge_inputs(tp.fanout, S, L, seed=S * L)
    got = fused.merge_ref(tp, *(torch.from_numpy(a)
                                for a in (cur, pins, src, rx, cap)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), _reference_merge(jp, cur, pins, src, rx, cap))


# -- (c) the sharded tail against the reference under shard_map ---------------

def _round_inputs(S, N, seed):
    rng = np.random.default_rng(seed)
    heard = rng.integers(0, 256, (S, N)).astype(np.uint8)
    mf = rng.choice(np.asarray([-1, 10, 200, NEVER], np.int32), (N,))
    rx_ok = rng.random(N) < 0.9
    cap = rng.integers(0, 4, (S,)).astype(np.int32)
    return heard, mf, rx_ok, cap


def _reference_sharded_tail(jp, rnd, seed, heard, mf, rx_ok, cap, ndev=8):
    sc = jk._ShardCtx(ndev, jp.n // ndev)

    def body(h, m, r, c):
        return j_fused.fused_disseminate(jp, rnd, jax.random.key(seed), h, m,
                                         r, c, sc)

    fn = shard_map(body, mesh=jk._shard_mesh(ndev),
                   in_specs=(Ps(None, jk._SHARD_AXIS), Ps(), Ps(), Ps()),
                   out_specs=Ps(None, jk._SHARD_AXIS), check_rep=False)
    return np.asarray(jax.jit(fn)(*(jnp.asarray(a)
                                    for a in (heard, mf, rx_ok, cap))))


@pytest.mark.parametrize("S, N, fused_nb", [(8, 64, 1), (6, 200, 7),
                                            (4, 48, 5)])
def test_sharded_tail_matches_reference_shard_map(S, N, fused_nb):
    """``fused_nb`` need not divide n on the sharded path: the reference
    checks it only in ``_fused_single``."""
    kw = dict(n=N, slots=S, dissem="fused", fused_nb=fused_nb)
    jp, tp = JParams(**kw), TParams(**kw)
    heard, mf, rx_ok, cap = _round_inputs(S, N, seed=N)
    for rnd, seed in ((50, 3), (150, 21)):
        want = _reference_sharded_tail(jp, rnd, seed, heard, mf, rx_ok, cap)
        ra = round_args.custom(tp, rnd, gossip=tk.gossip_offsets(
            prng.key(seed), N, tp.fanout))
        got = tk._disseminate(tp, ra, tk.round_variant(tp, None, rnd),
                              _split(torch.from_numpy(heard), 8),
                              torch.from_numpy(mf), torch.from_numpy(rx_ok),
                              torch.from_numpy(cap), tk._ShardCtx(8, N // 8))
        np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), want,
                                      err_msg=f"rnd={rnd}")


# -- (d) the sharded round against the reference's, end to end ----------------

def _boundary_schedule(n):
    """Failures and joins of nodes at shard boundaries (L = n / 8) and
    elsewhere; member0 leaves the joiners out."""
    L = n // 8
    fail = np.full(n, NEVER, np.int32)
    for node, rnd in ((L - 1, 10), (L, 30), (2 * L, 45), (5 * L - 1, 60),
                      (n - 1, 75), (3 * L + 7, 90)):
        fail[node] = rnd
    join = np.full(n, NEVER, np.int32)
    for node, rnd in ((4 * L, 25), (6 * L - 1, 40), (L + 3, 65),
                      (n - 2, 80)):
        join[node] = rnd
    return fail, join


def _assert_fields_equal(ref, port, ctx):
    got = convert.state_to_numpy(port)
    for f in ref._fields:
        x = np.asarray(getattr(ref, f))
        assert x.dtype == got[f].dtype and x.shape == got[f].shape, \
            f"{ctx}{f}: {x.dtype}{x.shape} vs {got[f].dtype}{got[f].shape}"
        assert np.array_equal(x, got[f]), f"{ctx}{type(ref).__name__}.{f}"


def test_run_rounds_sharded_matches_reference():
    """n = 640 on 8 shards (L = 80, prober windows of 128 columns across
    two and three shards), failures and joins on shard boundaries, the
    flight ring, hist banks and trace; the reference runs its Pallas
    sharded merge in interpret mode."""
    n, steps, seed = 640, 160, 7
    fail, join = _boundary_schedule(n)
    member0 = join == NEVER
    jp = j_lan(n, slots=8, loss_rate=0.02, pushpull_every=40,
               dissem="fused")
    tp = t_lan(n, slots=8, loss_rate=0.02, pushpull_every=40,
               dissem="fused")
    jst = jk.shard_state(jk.init_state(jp)._replace(
        member=jnp.asarray(member0)), 8)
    jc, jtr = jk.run_rounds_sharded(
        jst, jax.random.PRNGKey(seed), jnp.asarray(fail), jp, steps,
        trace=True, unroll=UNROLL, join_round=jnp.asarray(join),
        flight=jk.init_flight(), hist=jk.init_hist(), ndev=8)
    tst = tk.init_state(tp, device="cpu")._replace(
        member=torch.from_numpy(member0))
    tc, ttr = tk.run_rounds_sharded(
        tst, prng.PRNGKey(seed), fail, tp, steps, trace=True,
        join_round=join, flight=tk.init_flight(device="cpu"),
        hist=tk.init_hist(device="cpu"), ndev=8, device="cpu")
    assert isinstance(tc[0].heard, tuple) and len(tc[0].heard) == 8
    for a, b in zip(jc, tc):
        _assert_fields_equal(a, b, "sharded ")
    _assert_fields_equal(jtr, ttr, "sharded trace ")
    st = tc[0]
    assert int(st.n_detected) > 0 and int(st.n_refuted) >= 0
    assert bool(st.member[4 * 80])  # a joiner on a boundary joined


# -- (e) the port's sharded round against its own single-device round ---------

SELF_REGIMES = {  # name -> (params, joins threaded)
    "churn": (dict(), False),
    "loss_pushpull": (dict(loss_rate=0.05, pushpull_every=20), False),
    "hot_tier": (dict(hot_slots=4, loss_rate=0.02, pushpull_every=50), False),
    "joins_flight_hist": (dict(hot_slots=4, loss_rate=0.03,
                               pushpull_every=30), True),
}
_single_runs = {}


def _port_run(regime, ndev):
    kw, joins = SELF_REGIMES[regime]
    n = 640
    fail, join = _boundary_schedule(n)
    p = TParams(n=n, slots=8, probe_every=5, **kw)
    st = tk.init_state(p, device="cpu")
    extra = {}
    if joins:
        st = st._replace(member=torch.from_numpy(join == NEVER))
        extra["join_round"] = join
    args = (st, prng.key(3), fail, p, 220)
    extra.update(trace=True, flight=tk.init_flight(device="cpu"),
                 hist=tk.init_hist(device="cpu"), device="cpu")
    if ndev is None:
        return tk.run_rounds(*args, **extra)
    return tk.run_rounds_sharded(*args, ndev=ndev, **extra)


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("regime", sorted(SELF_REGIMES))
def test_sharded_equals_single_device(regime, ndev):
    if regime not in _single_runs:
        tails0 = dict(tk.tail_rounds)
        _single_runs[regime] = (_port_run(regime, None),
                                {k: tk.tail_rounds[k] - tails0[k]
                                 for k in tails0})
    (ref, rtr), tails = _single_runs[regime]
    if SELF_REGIMES[regime][0].get("hot_slots"):
        assert tails["hot"] > 0 and tails["full"] > 0, tails
    assert int(ref[0].n_detected) > 0
    (out, otr) = _port_run(regime, ndev)
    assert len(out[0].heard) == ndev
    for a, b in list(zip(ref, (tk.unshard_state(out[0]),) + out[1:])) + [
            (rtr, otr)]:
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), \
                f"{regime} ndev={ndev}: {type(a).__name__}.{f}"


def test_swim_round_sharded_one_round():
    """One round from a mid-run state with live episodes, joins pending:
    ``swim_round_sharded`` equals ``swim_round``, and leaves its sharded
    input intact."""
    n = 640
    fail, join = _boundary_schedule(n)
    p = t_lan(n, slots=8)
    st = tk.init_state(p, device="cpu")._replace(
        member=torch.from_numpy(join == NEVER))
    st, _ = tk.run_rounds(st, prng.key(4), fail, p, 70, join_round=join,
                          device="cpu")
    assert int((st.slot_node >= 0).sum()) > 0
    sh = tk.shard_state(st, 8, device="cpu")
    before = [h.clone() for h in sh.heard]
    for _ in range(3):
        one = tk.swim_round(st, prng.key(4), fail, p, join_round=join,
                            device="cpu")
        got = tk.swim_round_sharded(sh, prng.key(4), fail, p,
                                    join_round=join, device="cpu")
        for f in one._fields:
            assert torch.equal(getattr(one, f),
                               getattr(tk.unshard_state(got), f)), f
        assert all(torch.equal(a, b) for a, b in zip(sh.heard, before))
        st, sh, before = one, got, [h.clone() for h in got.heard]


def test_run_rounds_sharded_leaves_inputs_intact():
    """The sharded twin of test_torch_kernel's
    test_run_rounds_leaves_inputs_intact: neither an unsharded input nor
    a sharded one (its shards included) is written."""
    tp = TParams(n=120, slots=8, probe_every=5)
    fail = np.full(120, NEVER, np.int32)
    fail[[14, 15, 29, 30, 50]] = [3, 4, 5, 6, 8]
    for st in (tk.init_state(tp, device="cpu"),
               tk.shard_state(tk.init_state(tp, device="cpu"), 4,
                              device="cpu")):
        before = convert.state_to_numpy(st)
        shards = st.heard if isinstance(st.heard, tuple) else ()
        kept = [h.clone() for h in shards]
        out, _ = tk.run_rounds_sharded(st, prng.key(1), fail, tp, 60,
                                       ndev=4, device="cpu")
        assert int(out.round) == 60 and int(out.n_detected) > 0
        after = convert.state_to_numpy(st)
        for f, x in before.items():
            assert np.array_equal(x, after[f]), f
        assert all(torch.equal(a, b) for a, b in zip(shards, kept))


@pytest.mark.parametrize("n", [641, 104])
def test_check_shardable_refuses_like_reference(n):
    msgs = []
    for mod, prof in ((jk, j_lan), (tk, t_lan)):
        with pytest.raises(ValueError) as err:
            mod._check_shardable(prof(n), 8)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    tk._check_shardable(t_lan(640), 8)


def test_sharded_state_contracts():
    """run_rounds refuses a sharded state; run_rounds_sharded refuses one
    with another shard count; state_to_numpy unshards."""
    p = TParams(n=40, slots=4, probe_every=5)
    fail = np.full(40, NEVER, np.int32)
    sh = tk.shard_state(tk.init_state(p, device="cpu"), 4, device="cpu")
    with pytest.raises(ValueError, match="sharded"):
        tk.run_rounds(sh, prng.key(0), fail, p, 1, device="cpu")
    with pytest.raises(ValueError, match="shards"):
        tk.run_rounds_sharded(sh, prng.key(0), fail, p, 1, ndev=2,
                              device="cpu")
    with pytest.raises(ValueError, match="ndev"):
        tk.run_rounds_sharded(tk.init_state(p, device="cpu"), prng.key(0),
                              fail, p, 1, device="cpu")
    out, _ = tk.run_rounds_sharded(sh, prng.key(0), fail, p, 2,
                                   device="cpu")
    assert convert.state_to_numpy(out)["heard"].shape == (4, 40)
    assert torch.equal(tk.unshard_state(sh).heard, torch.zeros(4, 40,
                                                               dtype=torch.uint8))
