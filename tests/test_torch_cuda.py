"""The port on a CUDA card: the Hopper kernels (fused_dissem and the
sharded round's all-shards fused_merge, the store's kv_apply and
watch_match, the draws' threefry entry points) against their plain
torch versions, the whole round loop on the card against the same loop on the CPU, and the
sharded round on the card against the single-device round on the card.
Exact: belief bytes and every state field are compared bit for bit.

Every test here carries the ``cuda`` marker and skips without a card.
This file imports torch and numpy only (no JAX), so it runs on a GPU
machine that has no JAX:

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from consul_tpu_torch import prng
from consul_tpu_torch.gossip import fused, program
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip.params import SwimParams

NEVER = 2**31 - 1

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _random_round_inputs(S, N, seed):
    """Every belief byte value (message, confirmation count, age with the
    fresh sentinel), senders dead/alive/non-member, receivers on and off,
    caps 0..3."""
    rng = np.random.default_rng(seed)
    heard = rng.integers(0, 256, (S, N)).astype(np.uint8)
    mf = rng.choice(np.asarray([-1, 10, 200, NEVER], np.int32), (N,))
    rx_ok = rng.random(N) < 0.9
    cap = rng.integers(0, 4, (S,)).astype(np.int32)
    return heard, mf, rx_ok, cap


@pytest.mark.parametrize("shape", [(4, 24), (6, 40), (16, 96), (64, 4099)])
def test_kernel_matches_plain_on_card(shape):
    _need_card()
    S, N = shape
    heard, mf, rx_ok, cap = (torch.from_numpy(a).cuda()
                             for a in _random_round_inputs(S, N, seed=N))
    p = SwimParams(n=N, slots=S)
    for legs in ([1, N - 1, 7], [3], [N - 1] * 8):
        rnd, offs = fused.tail_args(50, legs, "cuda")
        ref = fused.disseminate_ref(p, rnd, offs, heard, mf, rx_ok, cap)
        out = fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd,
                                 p.spread_budget_rounds)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), offs


def test_round_on_card_matches_cpu():
    """run_rounds with joins, loss, push/pull, the hot tier, the flight
    ring and the hist banks: the card (Hopper kernel) against the CPU
    (plain tail)."""
    _need_card()
    n = 240
    join = np.full(n, NEVER, np.int32)
    join[10:14] = 5
    fail = np.full(n, NEVER, np.int32)
    fail[40], fail[170] = 20, 50
    p = SwimParams(n=n, slots=16, probe_every=5, loss_rate=0.05,
                   pushpull_every=20, hot_slots=4)
    program.settle_counts()
    launches0 = fused.launches
    outs = []
    for dev in ("cuda", "cpu"):
        st = tk.init_state(p, device=dev)._replace(
            member=torch.from_numpy(join == NEVER).to(dev))
        outs.append(tk.run_rounds(st, prng.key(2), fail, p, 200,
                                  trace=True, join_round=join,
                                  flight=tk.init_flight(device=dev),
                                  hist=tk.init_hist(device=dev), device=dev))
    # The card's rounds are graph replays: their launches are counted
    # once their branch runs are read.
    program.settle_counts()
    assert fused.launches > launches0
    (cg, tg), (cc, tc) = outs
    for a, b in list(zip(cg, cc)) + [(tg, tc)]:
        for f in a._fields:
            assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


@pytest.mark.parametrize("shape", [(8, 125), (64, 1000), (3, 1001),
                                   (7, 4099)])
def test_merge_kernel_matches_plain_on_card(shape):
    """fused_merge (all shards in one launch) against merge_shards_ref,
    ragged L included, on 1, 2, 4 and 8 shards, at fanouts 1, 3 and 8,
    with offsets above L."""
    _need_card()
    S, L = shape
    rng = np.random.default_rng(S * L)
    for ndev in (1, 2, 4, 8):
        N = ndev * L
        heard, mf, rx_ok, cap = (torch.from_numpy(a).cuda() for a in
                                 _random_round_inputs(S, N, seed=N + S))
        shards = tuple(h.contiguous() for h in heard.split(L, dim=1))
        sc = tk._ShardCtx(ndev, L)
        for F in (1, 3, 8):
            rnd, offs = fused.tail_args(50, ([1, N - 1, L + 3] + rng.integers(
                1, N, F).tolist())[:F], "cuda")
            p = SwimParams(n=N, slots=S, fanout=F)
            ref = fused.merge_shards_ref(p, rnd, offs, shards, mf, rx_ok,
                                         cap, sc)
            out = fused.fused_merge(shards, offs, mf, rx_ok, cap, rnd,
                                    p.spread_budget_rounds)
            torch.cuda.synchronize()
            for i in range(ndev):
                assert torch.equal(out[i], ref[i]), (shape, ndev, F, i)


def test_sharded_round_on_card_matches_single_on_card():
    """run_rounds_sharded(ndev=8) on the card (fused_merge) against
    run_rounds on the card (fused_dissem): joins, loss, push/pull, the
    hot tier, the flight ring and the hist banks."""
    _need_card()
    n = 640
    join = np.full(n, NEVER, np.int32)
    join[[79, 80, 400]] = [5, 9, 30]
    fail = np.full(n, NEVER, np.int32)
    fail[[159, 160, 40]] = [20, 35, 50]
    p = SwimParams(n=n, slots=16, probe_every=5, loss_rate=0.05,
                   pushpull_every=20, hot_slots=4)
    program.settle_counts()
    merges0 = fused.merge_launches
    outs = []
    for ndev in (None, 8):
        st = tk.init_state(p, device="cuda")._replace(
            member=torch.from_numpy(join == NEVER).cuda())
        kw = dict(trace=True, join_round=join,
                  flight=tk.init_flight(device="cuda"),
                  hist=tk.init_hist(device="cuda"), device="cuda")
        if ndev is None:
            outs.append(tk.run_rounds(st, prng.key(2), fail, p, 200, **kw))
        else:
            outs.append(tk.run_rounds_sharded(st, prng.key(2), fail, p, 200,
                                              ndev=ndev, **kw))
    program.settle_counts()
    assert fused.merge_launches > merges0
    (cs, ts), (cg, tg) = outs
    cg = (tk.unshard_state(cg[0]),) + tuple(cg[1:])
    for a, b in list(zip(cs, cg)) + [(ts, tg)]:
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("shape", [(6, 40), (64, 4099), (8, 1000)])
def test_kernels_take_the_drop_operand_on_card(shape):
    """Both kernels with a partition's drop operand (u8 with any nonzero
    value, and bool) against their plain versions; a drop operand on the
    wrong device or of the wrong shape raises."""
    _need_card()
    S, N = shape
    heard, mf, rx_ok, cap = (torch.from_numpy(a).cuda()
                             for a in _random_round_inputs(S, N, seed=N))
    rng = np.random.default_rng(S)
    d = (rng.random((3, N)) < 0.5) * rng.integers(1, 256, (3, N))
    drop = torch.from_numpy(d.astype(np.uint8)).cuda()
    p = SwimParams(n=N, slots=S)
    rnd, offs = fused.tail_args(50, [1, N - 1, 7], "cuda")
    for dr in (drop, drop != 0):
        ref = fused.disseminate_ref(p, rnd, offs, heard, mf, rx_ok, cap, dr)
        before = fused.drop_launches
        out = fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd,
                                 p.spread_budget_rounds, dr)
        torch.cuda.synchronize()
        assert torch.equal(out, ref) and fused.drop_launches == before + 1
    for ndev in (1, 2):
        L = N // ndev
        if L * ndev != N:
            continue
        shards = tuple(h.contiguous() for h in heard.split(L, dim=1))
        ref = fused.merge_shards_ref(p, rnd, offs, shards, mf, rx_ok, cap,
                                     tk._ShardCtx(ndev, L), drop)
        out = fused.fused_merge(shards, offs, mf, rx_ok, cap, rnd,
                                p.spread_budget_rounds, drop)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    for bad in (drop.cpu(), drop[:2].contiguous()):
        with pytest.raises(ValueError, match="drop"):
            fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd,
                               p.spread_budget_rounds, bad)


def test_multidc_on_card_matches_cpu():
    """run_multidc_rounds with per-DC hist banks, LAN and WAN failures,
    an event fired before the run and one past the last free slot: the
    card against the CPU (state, banks, coverage trace), and the LAN pools
    on 2 column shards of the card against one."""
    _need_card()
    from consul_tpu_torch.gossip import convert
    from consul_tpu_torch.gossip import multidc as tm

    D, n = 2, 320
    lan_fail = np.full((D, n), NEVER, np.int32)
    lan_fail[0, [40, 200]] = [10, 60]
    lan_fail[1, 77] = 30
    wan_fail = np.full((D * 3,), NEVER, np.int32)
    wan_fail[4] = 15
    outs = []
    for dev, ndev in (("cuda", 0), ("cpu", 0), ("cuda", 2)):
        p = tm.make_params(D, n, event_slots=2, slots=8, hot_slots=0,
                           lan_devices=ndev)
        st = tm.fire_in_dc(tm.init_multidc(p, device=dev), 0, 150, p)
        st = tm.fire_in_dc(tm.fire_in_dc(st, 1, 9, p), 1, 10, p)
        program.settle_counts()
        merges0 = fused.merge_launches
        (st, hb), cov = tm.run_multidc_rounds(
            st, prng.key(4), lan_fail, wan_fail, p, 120,
            lan_hist=tm.init_multidc_hist(p, device=dev), device=dev)
        # The card's rounds are replays: their branch bodies' launches
        # are counted once settled.
        program.settle_counts()
        if ndev:
            assert fused.merge_launches > merges0
        outs.append((convert.multidc_to_numpy(st),
                     convert.hist_banks_to_numpy(hb), cov.cpu().numpy()))
    ref = outs[1]
    for out in (outs[0], outs[2]):
        for pool in ref[0]:
            for f in ref[0][pool]:
                assert np.array_equal(out[0][pool][f], ref[0][pool][f]), \
                    (pool, f)
        for f in ref[1]:
            assert np.array_equal(out[1][f], ref[1][f]), f
        assert np.array_equal(out[2], ref[2])


# -- the device store's kernels ------------------------------------------------

def _store_ops(rng, capacity, batch, n_keys, start):
    """Sets, deletes and pad rows over a clustered key pool whose key 0
    has fingerprints (0, 0) (pad rows match it), indexes from ``start``
    (across 2**31 and past 2**32)."""
    from consul_tpu_torch.state import device_store as tds
    span = max(capacity // 8, 2)
    h1 = ((rng.integers(0, 2**32, n_keys, dtype=np.uint64)
           & np.uint64(2**32 - capacity))
          | rng.integers(0, span, n_keys).astype(np.uint64)).astype(np.uint32)
    h2 = rng.integers(0, 2**32, n_keys, dtype=np.uint64).astype(np.uint32)
    h1[0] = h2[0] = 0
    k = rng.integers(0, n_keys, batch)
    opc = rng.choice(np.asarray([tds.OP_SET, tds.OP_SET, tds.OP_DEL,
                                 tds.OP_PAD], np.int32), batch)
    pad = opc == tds.OP_PAD
    idx = ((start + np.arange(batch)) % 2**32).astype(np.uint32)
    word = lambda: rng.integers(0, 2**32, batch,  # noqa: E731
                                dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(tds._pack_ops(opc, np.where(pad, 0, h1[k]),
                                          np.where(pad, 0, h2[k]), idx,
                                          word(), word()))


@pytest.mark.parametrize("capacity, probe, n_keys, batch", [
    (64, 16, 150, 64), (4096, 16, 3000, 512), (1024, 32, 900, 33),
    (65536, 16, 40000, 4096)])
def test_kv_apply_matches_plain_on_card(capacity, probe, n_keys, batch):
    """Every verdict, every table word and the full count after each
    batch: the kernel on the card against apply_ref on the CPU."""
    _need_card()
    from consul_tpu_torch.state import device_store as tds
    rng = np.random.default_rng(capacity + batch)
    ref = (torch.zeros((capacity, tds.SLOT_COLS), dtype=torch.int32),
           torch.zeros((), dtype=torch.int32))
    tab = tuple(t.cuda() for t in ref)
    for b in range(3):
        ops = _store_ops(rng, capacity, batch, n_keys, 2**31 - 50 + b * batch)
        ref, (want_e, want_o) = tds.apply_ref(ref, ops, probe)
        existed, old = tds.kv_apply(tab, ops.cuda(), probe)
        torch.cuda.synchronize()
        assert torch.equal(existed.cpu(), want_e), b
        assert torch.equal(old.cpu(), want_o), b
        assert torch.equal(tab[0].cpu(), ref[0]), b
        assert int(tab[1]) == int(ref[1]), b
    if capacity == 64:
        assert int(tab[1]) > 0


@pytest.mark.parametrize("layout", ["one_key", "trailing_pads"])
def test_kv_apply_schedules_chains_on_card(layout):
    """The two chains the schedule must survive, on a half-full table of
    65,536 slots: 4,096 ops on one key (walked in order) and 2,049 ops of
    spread keys with 2,047 pad rows at the end, as the bridge pads a chunk
    (run in levels, not chained).  Every verdict, table word and the full
    count against apply_ref on the CPU."""
    _need_card()
    from consul_tpu_torch.state import device_store as tds
    rng = np.random.default_rng(8)
    C, P = 65536, 16
    ref = (torch.zeros((C, tds.SLOT_COLS), dtype=torch.int32),
           torch.zeros((), dtype=torch.int32))
    spread = lambda n: rng.integers(0, 2**32, n,  # noqa: E731
                                    dtype=np.uint64).astype(np.uint32)
    fill = torch.from_numpy(tds._pack_ops(
        np.zeros(4096, np.int32), spread(4096), spread(4096),
        np.arange(4096, dtype=np.uint32), spread(4096), spread(4096)))
    ref, _ = tds.apply_ref(ref, fill, P)
    tab = tuple(t.cuda() for t in ref)
    opc = rng.choice(np.asarray([tds.OP_SET, tds.OP_SET, tds.OP_DEL],
                                np.int32), 4096)
    if layout == "one_key":
        h1 = np.full(4096, spread(1)[0], np.uint32)
        h2 = np.full(4096, spread(1)[0], np.uint32)
    else:
        keys = spread(1500), spread(1500)
        k = rng.integers(0, 1500, 4096)
        h1, h2 = keys[0][k], keys[1][k]
        opc[2049:] = tds.OP_PAD
        h1[2049:] = h2[2049:] = 0
    ops = torch.from_numpy(tds._pack_ops(
        opc, h1, h2, (2**31 - 5 + np.arange(4096)).astype(np.uint32),
        spread(4096), spread(4096)))
    ref, (want_e, want_o) = tds.apply_ref(ref, ops, P)
    (existed, old), stats = tds.kv_apply_schedule(tab, ops.cuda(), P)
    assert torch.equal(existed.cpu(), want_e)
    assert torch.equal(old.cpu(), want_o)
    assert torch.equal(tab[0].cpu(), ref[0])
    assert int(tab[1]) == int(ref[1])
    assert stats["walked_ops"] == (4096 if layout == "one_key" else 0), stats


@pytest.mark.parametrize("W, B, lmax", [(32, 1, 0), (512, 16, 8),
                                        (4096, 256, 64)])
def test_watch_match_matches_plain_on_card(W, B, lmax):
    """fired and packed on the card against match_ref on the CPU, on rows
    whose hashes collide often, with pads, tables and index gates on both
    sides of 2**31."""
    _need_card()
    from consul_tpu_torch.state import device_store as tds
    rng = np.random.default_rng(W + B)
    alphabet = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    near = np.asarray([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1],
                      np.uint32)
    watches = torch.from_numpy(tds._pack_rows(
        rng.choice(np.asarray([-1, 0, 1, 2], np.int32), W),
        rng.choice(alphabet, W), rng.choice(alphabet, W),
        rng.integers(-2, lmax + 3, W).astype(np.int32), rng.choice(near, W)))
    events = torch.from_numpy(tds._pack_rows(
        rng.choice(np.asarray([-1, 0, 0, 1], np.int32), B),
        rng.integers(-1, lmax + 90, B).astype(np.int32),
        rng.choice(near, B), rng.choice(alphabet, B),
        rng.choice(alphabet, B)))
    hp = torch.from_numpy(np.ascontiguousarray(
        rng.choice(alphabet, (2, B, lmax + 1)).view(np.int32)))
    want_f, want_p = tds.match_ref(watches, events, hp, lmax)
    fired, packed = tds.watch_match(watches.cuda(), events.cuda(), hp.cuda(),
                                    lmax)
    torch.cuda.synchronize()
    assert torch.equal(fired.cpu(), want_f)
    assert torch.equal(packed.cpu(), want_p)


# The draws' kernel (csrc/threefry.cu): every entry point against its
# plain version at the main path's shapes (the probe tick's [200,000] and
# [200,000, 3] at 1M nodes, the drop legs' [3, 1M] and [2, 1M], the
# Feistel targets' [1M]) and at odd lengths; bit for bit.
DRAW_KEYS = [prng.key(0), prng.fold_in(prng.key(42), 7),
             np.asarray([0x80000000, 0xFFFFFFFF], np.uint32)]


@pytest.mark.parametrize("shape", [(200_000,), (200_000, 3), (1,), (4099,)])
def test_uniform_and_below_on_card(shape):
    _need_card()
    for k in DRAW_KEYS:
        got = prng.uniform_tensor(k, shape, "cuda")
        want = prng.uniform_ref(k, shape, "cuda")
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        for p in (2.0**-24, 0.010000000000000009, 0.5, 1.0 - 2.0**-24):
            assert torch.equal(prng.below(k, shape, p, "cuda"),
                               prng.below_ref(k, shape, p, "cuda")), p


@pytest.mark.parametrize("n", [1_000_000, 7])
def test_bits_and_randint_on_card(n):
    _need_card()
    for k in DRAW_KEYS:
        bits = prng.random_bits_tensor(k, (n,), "cuda")
        assert bits.dtype == torch.int64
        assert torch.equal(bits, prng.random_bits_ref(k, (n,), "cuda"))
        for lo, hi in ((0, n - 1), (1, 1_000_000), (-500, 499)):
            assert torch.equal(prng.randint_tensor(k, (n,), lo, hi, "cuda"),
                               prng.randint_ref(k, (n,), lo, hi, "cuda"))


@pytest.mark.parametrize("rows, n", [(3, 1_000_000), (2, 1_000_000),
                                     (4, 16_001)])
def test_uniform_rows_and_edge_drops_on_card(rows, n):
    _need_card()
    keys = [prng.fold_in(DRAW_KEYS[1], f) for f in range(rows)]
    got = prng.uniform_rows(keys, n, "cuda")
    want = prng.uniform_rows_ref(keys, n, "cuda")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ids = torch.arange(n, dtype=torch.int64, device="cuda")
    for grp in ((((ids * 2654435761) & 0xFFFFFFFF) >> 31).to(torch.int32),
                (ids >= n // 2).to(torch.int32)):
        shifts = [1, n - 1, -(n // 3), 5, n + 2][:rows]
        for p_ab, p_ba in ((1.0, 1.0), (0.6, 0.0), (0.3, 0.45), (0.0, 1.0)):
            assert torch.equal(
                prng.edge_drops(keys, grp, shifts, p_ab, p_ba),
                prng.edge_drops_ref(keys, grp, shifts, p_ab, p_ba)), (p_ab,
                                                                      p_ba)


# -- the round as replayed CUDA graphs (gossip/program.py) ---------------------

def _churn_inputs(n, steps, seed):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)
    fail = np.full(n, NEVER, np.int32)
    fail[ids[:24]] = rng.integers(0, steps // 2, 24)
    join = np.full(n, NEVER, np.int32)
    join[ids[24:36]] = rng.integers(1, steps // 2, 12)
    return fail, join


def _same_fields(a, b):
    from consul_tpu_torch.gossip import convert
    bad = []
    for x, y in zip(a, b):
        if isinstance(x, tk.SwimState):
            x, y = tk.unshard_state(x), tk.unshard_state(y)
        X, Y = convert.state_to_numpy(x), convert.state_to_numpy(y)
        bad += [f"{type(x).__name__}.{f}" for f in X
                if not np.array_equal(X[f], Y[f])]
    return bad


@pytest.mark.parametrize("ndev, scenario", [(None, None), (4, None),
                                            (None, "partition_heal"),
                                            (None, "degraded_observer")])
def test_graphed_round_matches_eager_on_card(ndev, scenario):
    """The replayed graphs against the eager round on the card: every
    field of the carry and the trace; the graphed call reads the round
    counter and the flight cursor and nothing else; launches, settled,
    equal the non-quiescent rounds."""
    _need_card()
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile
    n, steps = 4000, 120
    p = lan_profile(n, slots=32, loss_rate=0.01)
    fail, join = _churn_inputs(n, steps, 3)
    kw = {}
    if scenario:
        sc = build(scenario, n)
        fail = np.minimum(fail, sc.fail_round)
        kw["nem"] = sc.nem
        if sc.join_round is not None:
            join = np.minimum(join, sc.join_round)
        if sc.nem.needs_state:
            kw["nem_state"] = tk.init_nem_state(n)
    st = tk.init_state(p)._replace(member=torch.from_numpy(join == NEVER)
                                   .cuda())
    runs = {}
    for graphed in (False, True):
        program.settle_counts()
        syncs, dissems = tk.host_syncs, fused.launches + fused.merge_launches
        tails = dict(tk.tail_rounds)
        a = dict(trace=True, join_round=join, flight=tk.init_flight(),
                 hist=tk.init_hist(), graphed=graphed, **kw)
        if ndev:
            out = tk.run_rounds_sharded(st, prng.key(5), fail, p, steps,
                                        ndev=ndev, **a)
        else:
            out = tk.run_rounds(st, prng.key(5), fail, p, steps, **a)
        torch.cuda.synchronize()
        syncs = tk.host_syncs - syncs
        program.settle_counts()
        busy = sum(tk.tail_rounds[k] - tails[k] for k in ("hot", "full"))
        assert fused.launches + fused.merge_launches - dissems == busy
        runs[graphed] = out
        if graphed:
            assert syncs == 2
    (ce, te), (cg, tg) = runs[False], runs[True]
    assert _same_fields(list(ce) + [te], list(cg) + [tg]) == []
    assert int(ce[0].n_detected) > 0


@pytest.mark.parametrize("ndev, scenario", [(None, None), (4, None),
                                            (None, "partition_heal")])
def test_looped_calls_match_replays_on_card(ndev, scenario, monkeypatch):
    """A call of 600 rounds (chunks of 512 and 88) as the card runs it, a
    table launch and a loop launch a chunk, against the same call with a
    replay a round (``RoundProgram.run(replays=True)``, the loop's plain
    version): every field of the carry and the trace, the graph and table
    launches, ceil(n / U) loop kernels a chunk of n rounds
    (``program.loop_kernels``); the settled counts agree."""
    _need_card()
    import functools

    from consul_tpu_torch.gossip import round_table
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile
    n, steps = 4000, 600
    p = lan_profile(n, slots=32, loss_rate=0.01)
    fail, join = _churn_inputs(n, steps, 4)
    kw = {}
    if scenario:
        sc = build(scenario, n)
        fail = np.minimum(fail, sc.fail_round)
        kw["nem"] = sc.nem
        join = np.minimum(join, sc.join_round)
    st = tk.init_state(p)._replace(member=torch.from_numpy(join == NEVER)
                                   .cuda())
    runs, counts = {}, {}
    run = program.RoundProgram.run
    for replays in (False, True):
        if replays:
            monkeypatch.setattr(program.RoundProgram, "run",
                                functools.partialmethod(run, replays=True))
        program.settle_counts()
        c0 = (program.launches, round_table.launches, program.loop_launches,
              dict(tk.tail_rounds))
        a = dict(trace=True, join_round=join, flight=tk.init_flight(),
                 hist=tk.init_hist(), **kw)
        if ndev:
            out = tk.run_rounds_sharded(st, prng.key(6), fail, p, steps,
                                        ndev=ndev, **a)
        else:
            out = tk.run_rounds(st, prng.key(6), fail, p, steps, **a)
        program.settle_counts()
        runs[replays] = out
        counts[replays] = (program.launches - c0[0],
                           round_table.launches - c0[1],
                           program.loop_launches - c0[2],
                           {k: tk.tail_rounds[k] - c0[3][k]
                            for k in c0[3]})
    (cl, tl), (cr, tr) = runs[False], runs[True]
    assert _same_fields(list(cl) + [tl], list(cr) + [tr]) == []
    assert counts[False][:3] == (2, 2, program.loop_kernels(steps))
    assert counts[True][:3] == (steps, 2, 0)
    assert counts[False][3] == counts[True][3]


def test_table_kernel_matches_plain_on_card():
    """``round_table.fill`` on the card against ``fill_ref`` on the CPU:
    the round's layout with a flight ring and the variant column under a
    nemesis schedule, and the event layout, at 1, 30 and 512 rows."""
    _need_card()
    from consul_tpu_torch.gossip import round_args, round_table
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile
    p = lan_profile(1_000_000)
    nem = build("flapping", p.n).nem
    lay, ev = (round_args.layout(p.fanout, p.indirect_k),
               round_args.event_layout(p.fanout))
    for rows in (1, 30, 512):
        for dev in ("cuda", "cpu"):
            z = torch.zeros
            jobs = [round_table.Job(
                p, prng.key(rows), 40 + rows, z((rows, lay.width),
                                                dtype=torch.int32,
                                                device=dev),
                variant=z(rows, dtype=torch.int32, device=dev), nem=nem,
                left=z(1, dtype=torch.int32, device=dev),
                step=torch.ones(1, dtype=torch.int64, device=dev),
                cursor=rows * 7, ring=256),
                round_table.Job(p, prng.key(rows), 9, z(
                    (rows, ev.width), dtype=torch.int32, device=dev),
                    events=True)]
            round_table.fill(jobs, rows)
            out = [(j.table.cpu(), None if j.variant is None
                    else j.variant.cpu()) for j in jobs]
            if dev == "cuda":
                got = out
                assert int(jobs[0].left) == rows and int(jobs[0].step) == 0
        for (a, va), (b, vb) in zip(got, out):
            assert torch.equal(a, b)
            assert (va is None) == (vb is None)
            assert va is None or torch.equal(va, vb)


def test_device_argument_modes_on_card():
    """The tail's shifts off by -N against the same shifts in [1, N), and
    the draws' device-argument entry points against their by-value
    launches."""
    _need_card()
    S, N = 64, 4099
    heard, mf, rx_ok, cap = (torch.from_numpy(a).cuda()
                             for a in _random_round_inputs(S, N, seed=9))
    p = SwimParams(n=N, slots=S)
    legs = [1, N - 1, 777]
    rnd, offs = fused.tail_args(50, legs, "cuda")
    want = fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd,
                              p.spread_budget_rounds)
    rnd, offs = fused.tail_args(50, [o - N for o in legs], "cuda")
    got = fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd,
                             p.spread_budget_rounds)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(want, fused.disseminate_ref(p, rnd, offs, heard, mf,
                                                   rx_ok, cap))
    keys = [prng.fold_in(prng.key(3), f) for f in range(3)]
    dkeys = torch.from_numpy(np.asarray(keys, np.uint32).view(np.int32)
                             .copy()).cuda()
    assert torch.equal(prng.uniform_tensor(dkeys[0], (200_000, 3), "cuda"),
                       prng.uniform_tensor(keys[0], (200_000, 3), "cuda"))
    assert torch.equal(prng.below(dkeys[1], (200_000,), 0.3, "cuda"),
                       prng.below(keys[1], (200_000,), 0.3, "cuda"))
    grp = (torch.arange(N, device="cuda") >= N // 2).to(torch.int32)
    shifts = torch.tensor([5, -7, N + 3], dtype=torch.int32, device="cuda")
    assert torch.equal(prng.edge_drops(dkeys, grp, shifts, 0.6, 0.3),
                       prng.edge_drops(keys, grp, [5, -7, N + 3], 0.6, 0.3))


def test_conditional_graph_nodes_on_card(tmp_path):
    """``csrc/round_graph.cu``: a segment under an IF node runs exactly
    when its device predicate holds (a cond's group: its chooser node
    reads the bool)."""
    _need_card()
    import ctypes

    x = torch.zeros(1024, device="cuda")
    pool = torch.cuda.graph_pool_handle()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    segs = []
    with torch.cuda.stream(side):
        # x + 1, then x * 3, then x * 3 again under IF (x + 1 > 1).
        for seg in ("add", "mul", "if_mul"):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            g.capture_begin(pool=pool)
            if seg == "add":
                x.add_(1)
                pred = x[0] > 1
            else:
                x.mul_(3)
            g.capture_end()
            segs.append((g, pred if seg == "if_mul" else None, None, ()))
    torch.cuda.current_stream().wait_stream(side)
    groups = [None if p is None else program._Group(tk.Choice(p, 1))
              for _, p, _, _ in segs]
    for grp in groups:
        if grp is not None:
            grp.bids = [0]
    graph = program._Graph([(g, grp, 0 if grp else None,
                             (0,) * len(program._COUNTERS))
                            for (g, _, _, _), grp in zip(segs, groups)])
    assert graph.described(tmp_path / "joined.dot") == {
        "kernel": 1, "chooser": 1, "conditional": 1, "set_condition": False}
    for x0, want in ((0.0, 3.0), (1.0, 18.0)):
        x.fill_(x0)
        graph.launch()
        torch.cuda.synchronize()
        assert float(x[0]) == want, x0
    graph.close()
    assert isinstance(graph.exec, ctypes.c_void_p)


# -- the event flood and the multi-DC program ------------------------------------

def _flood_inputs(E, N, seed, rnd=500, ttl=40):
    """Every byte value, alive holes, slots on both sides of the TTL,
    clocks and counts at the int32 edge."""
    rng = np.random.default_rng(seed)
    i32 = 2**31 - 1
    has = np.where(rng.random((E, N)) < 0.35, rng.integers(0, 256, (E, N)),
                   (rng.random((E, N)) < 0.4) * 0x80
                   + rng.integers(0, 16, (E, N))).astype(np.uint8)
    arrays = (has, rng.random(N) < 0.8, rng.random(E) < 0.8,
              rng.choice(np.asarray([-5, 0, 7, i32], np.int32), E),
              rng.integers(-1, N, E).astype(np.int32),
              (rnd - ttl + rng.integers(-2, 3, E)).astype(np.int32),
              rng.choice(np.asarray([-3, 0, 999, i32], np.int32), N),
              rng.choice(np.asarray([0, i32 - 2, -1], np.int32), E))
    return [torch.from_numpy(a).cuda() for a in arrays]


@pytest.mark.parametrize("E, N, F", [(8, 4096, 3), (16, 1001, 3),
                                     (32, 12, 4), (64, 4099, 3),
                                     (300, 40, 2)])
def test_event_flood_matches_plain_on_card(E, N, F):
    """``csrc/event_flood.cu`` against ``event_flood_ref`` on the card,
    push/pull on and off, budgets 1 to 14, shifts off by -N: every
    output, tolerance 0."""
    _need_card()
    from consul_tpu_torch.gossip import events as te
    rng = np.random.default_rng(N)
    ins = _flood_inputs(E, N, seed=E + N)
    for budget, pushpull in ((3, False), (3, True), (1, True), (14, False)):
        offs = rng.integers(1, N, F).tolist()
        pp = int(rng.integers(1, N))
        want = te.event_flood_ref(*ins, torch.tensor(
            [500, *offs, pp, -pp], dtype=torch.int32, device="cuda"),
            budget, 40, pushpull)
        row = torch.tensor([500, *(o - N for o in offs), pp - N, N - pp],
                           dtype=torch.int32, device="cuda")
        n0 = te.launches
        got = te.event_flood(*ins, row, budget, 40, pushpull)
        torch.cuda.synchronize()
        assert te.launches == n0 + 1
        for f in te.Flood._fields:
            assert torch.equal(getattr(got, f), getattr(want, f)), \
                (budget, pushpull, f)


def test_graphed_events_match_eager_on_card():
    """``run_event_rounds`` replayed against eager on the card: every
    field and the coverage trace; one host read a graphed call; one
    flood launch a round on both routes."""
    _need_card()
    from consul_tpu_torch.gossip import events as te
    from consul_tpu_torch.gossip.params import lan_profile
    n, steps = 4000, 90
    p = lan_profile(n, pushpull_every=4)
    alive = torch.from_numpy(np.random.default_rng(2).random(n) > 0.1).cuda()
    st = te.init_events(p, slots=16)
    st = te.fire_events(st, torch.tensor([5, 900, 17, 17, -1, 3999],
                                         dtype=torch.int32))
    runs = {}
    for graphed in (False, True):
        program.settle_counts()
        syncs, n0 = tk.host_syncs, te.launches
        runs[graphed] = te.run_event_rounds(st, prng.key(6), alive, p, steps,
                                            graphed=graphed)
        torch.cuda.synchronize()
        assert te.launches - n0 == steps
        if graphed:
            assert tk.host_syncs - syncs == 1
    (a, ca), (b, cb) = runs[False], runs[True]
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(ca, cb)
    # The first event reached the live nodes, and its slot was freed
    # after the TTL (coverage 0 again).
    assert float(cb[:, 0].max()) > 0.9 and float(cb[-1, 0]) == 0.0
    assert not bool(b.slot_used[0])


@pytest.mark.parametrize("ndev", [0, 2])
def test_graphed_multidc_matches_eager_on_card(ndev):
    """``MultiDCProgram`` against the eager multi-DC round on the card:
    state, banks and coverage trace; one host read a graphed call, and
    2 D + 3 graph launches a round."""
    _need_card()
    from consul_tpu_torch.gossip import convert
    from consul_tpu_torch.gossip import multidc as tm

    D, n, steps = 2, 320, 80
    lan_fail = np.full((D, n), NEVER, np.int32)
    lan_fail[0, [40, 200]] = [10, 60]
    lan_fail[1, [1, 77]] = [20, 30]
    wan_fail = np.full((D * 3,), NEVER, np.int32)
    wan_fail[4] = 15
    p = tm.make_params(D, n, event_slots=2, slots=8, hot_slots=4,
                       lan_devices=ndev)
    st = tm.fire_in_dc(tm.init_multidc(p), 0, 150, p)
    st = tm.fire_in_dc(st, 1, 9, p)
    outs = {}
    for graphed in (False, True):
        syncs, graphs = tk.host_syncs, program.launches
        (s, hb), cov = tm.run_multidc_rounds(
            st, prng.key(4), lan_fail, wan_fail, p, steps,
            lan_hist=tm.init_multidc_hist(p), graphed=graphed)
        torch.cuda.synchronize()
        if graphed:
            assert tk.host_syncs - syncs == 1
            assert program.launches - graphs == (2 * D + 3) * steps
        outs[graphed] = (convert.multidc_to_numpy(s),
                         convert.hist_banks_to_numpy(hb), cov.cpu().numpy())
    tm.close_programs()
    (se, he, ce), (sg, hg, cg) = outs[False], outs[True]
    for pool in se:
        for f in se[pool]:
            assert np.array_equal(se[pool][f], sg[pool][f]), (pool, f)
    for f in he:
        assert np.array_equal(he[f], hg[f]), f
    assert np.array_equal(ce, cg)
    assert se["lan"]["n_detected"].min() > 0


def _observe_inputs(R, N, seed):
    """Every byte value, member with holes, verdicts DEAD and REFUTE and
    out of range, a want mask with holes."""
    rng = np.random.default_rng(seed)
    heard = rng.integers(0, 256, (R, N)).astype(np.uint8)
    member = rng.random(N) < 0.8
    verdict = rng.choice(np.asarray([2, 3, 2, 3, -1, 7], np.int32), R)
    want = rng.random(R) < 0.5
    return [torch.from_numpy(a).cuda() for a in (heard, member, verdict,
                                                 want)]


@pytest.mark.parametrize("R, N, ndev", [(64, 4096, 1), (8, 1001, 1),
                                        (64, 4104, 2), (16, 8 * 1250, 8),
                                        (64, 8 * 31_250, 8), (5, 7, 1)])
def test_heard_counts_match_plain_on_card(R, N, ndev):
    """``csrc/observe.cu`` against ``heard_counts_ref`` on the card: the
    16-byte, 4-byte and byte paths, 1, 2 and 8 shards, with and without
    a verdict and a want mask, budgets 0 to 16: every count, tolerance
    0; one launch each."""
    _need_card()
    from consul_tpu_torch.gossip import observe
    heard, member, verdict, want = _observe_inputs(R, N, seed=R + N)
    L = N // ndev
    shards = tuple(heard[:, i * L:(i + 1) * L].contiguous()
                   for i in range(ndev))
    arg = shards if ndev > 1 else heard
    for budget in (0, 1, 3, 14, 16):
        for v, w in ((None, None), (verdict, None), (verdict, want),
                     (None, torch.zeros_like(want))):
            n0 = observe.launches
            got = observe.heard_counts(arg, member, budget, v, w)
            torch.cuda.synchronize()
            assert observe.launches == n0 + 1
            assert torch.equal(got, observe.heard_counts_ref(
                arg, member, budget, v, w)), (budget, v is None, w is None)


@pytest.mark.parametrize("L, offsets", [(16 * 700 + 1, (0, 3)),
                                        (16 * 700 + 2, (5, 0, 11)),
                                        (16 * 700 + 8, (8, 1))])
@pytest.mark.parametrize("ndev", [1, 8])
def test_heard_counts_forms_and_phases_on_card(L, offsets, ndev):
    """``csrc/observe.cu`` in the forms the round launches it: the final
    matrix's (every row), the spread's with 1, 3 and 40 of 64 rows wanted
    and with none (``out`` all zero), on shards at byte offsets of their
    buffers (rows at every phase mod 16, L % 16 of 1, 2 and 8) and
    ``member`` at an odd offset: every count, tolerance 0, one launch
    each, the scratch left zero."""
    _need_card()
    from consul_tpu_torch.gossip import observe
    R = 64
    heard, member, verdict, _ = _observe_inputs(R, L * ndev, seed=L + ndev)
    shards = []
    for i in range(ndev):
        o = offsets[i % len(offsets)]
        buf = torch.full((R * L + o + 16,), 0xA5, dtype=torch.uint8,
                         device="cuda")
        view = buf[o:o + R * L].view(R, L)
        view.copy_(heard[:, i * L:(i + 1) * L])
        shards.append(view)
    arg = tuple(shards) if ndev > 1 else shards[0]
    mbuf = torch.ones(L * ndev + 32, dtype=torch.bool, device="cuda")
    mem = mbuf[7:7 + L * ndev]
    mem.copy_(member)
    verdict = torch.where((verdict >= 0) & (verdict <= 3), verdict, 2)
    scratch = observe.counts_scratch(R, "cuda")
    forms = [(None, None)]
    for rows in ((5,), (5, 17, 40), tuple(range(0, 64, 3)), ()):
        w = torch.zeros(R, dtype=torch.bool, device="cuda")
        w[list(rows)] = True
        forms.append((verdict, w))
    for v, w in forms:
        n0 = observe.launches
        got = observe.heard_counts(arg, mem, 6, v, w, scratch)
        torch.cuda.synchronize()
        assert observe.launches == n0 + 1
        assert torch.equal(got, observe.heard_counts_ref(arg, member, 6, v,
                                                         w))
        if w is not None and not w.any():
            assert not got.any()
        assert int(scratch.abs().sum()) == 0


@pytest.mark.parametrize("ndev", [None, 8])
def test_record_behind_the_count_matches_plain_on_card(ndev):
    """Record with the hist banks as the round launches it, a programmatic
    dependent launch right behind the spread's count (which triggers it as
    it starts), against the plain versions: every field, the holders and
    the banks, tolerance 0; a dropped subject whose own byte is DEAD in
    its row counts among the holders (the count read member before record
    cleared it)."""
    _need_card()
    from consul_tpu_torch.gossip import finish, finish_slots as fs, observe
    n, S = 4000, 64
    cfg, t, rx = _finish_slots_inputs(n, S, None, ndev, True, False, True,
                                      4065)
    rnd = int(t.rnd)
    node, phase, _, dead = t.slots
    subject = 777
    node[9], phase[9], dead[9] = subject, 2, rnd - cfg.gc_rounds - 1
    t.slot_of_node[subject] = 9
    t.member[subject] = True
    t.fail_round[subject] = rnd - 40  # failed: the verdict stands
    t.alive[subject] = False
    shards = t.heard if isinstance(t.heard, tuple) else (t.heard,)
    L = shards[0].shape[1]
    shards[subject // L][9, subject % L] = 0x80  # DEAD, conf 0, age 0
    scratch = observe.counts_scratch(S, "cuda")
    torch.cuda.synchronize()
    dec = fs.finish_decide(cfg, t)
    fired = finish.fire_timers(t.heard, rx, dec.ok_mask, dec.refute,
                               scratch)
    st = fs.finish_settle(cfg, t, fired)
    torch.cuda.synchronize()
    assert int(st.marks[9]) & fs.DROPPED and bool(st.spread[9])

    def copy(t):
        heard = (tuple(h.clone() for h in t.heard)
                 if isinstance(t.heard, tuple) else t.heard.clone())
        return t._replace(
            heard=heard, slots=tuple(x.clone() for x in t.slots),
            member=t.member.clone(), slot_of_node=t.slot_of_node.clone(),
            hist=tk.HistBank(*(x.clone() for x in t.hist)))

    got, want = copy(t), copy(t)
    n_hold_w = observe.heard_counts_ref(want.heard, want.member, cfg.budget,
                                        st.verdict, st.spread)[observe.HOLD]
    fs.finish_record_ref(cfg, want, dec, st, n_hold_w)
    torch.cuda.synchronize()
    n0 = fs.record_launches
    n_hold = observe.count(got.heard, got.member, cfg.budget, st.verdict,
                           st.spread, scratch)[observe.HOLD]
    fs.record(cfg, got, dec, st, n_hold)
    torch.cuda.synchronize()
    assert fs.record_launches == n0 + 1
    assert torch.equal(n_hold, n_hold_w) and int(n_hold[9]) > 0
    for x, y in zip([*got.slots, got.member, got.slot_of_node, *got.hist],
                    [*want.slots, want.member, want.slot_of_node,
                     *want.hist]):
        assert torch.equal(x, y)
    assert not bool(got.member[subject])


@pytest.mark.parametrize("ndev", [None, 4])
def test_graphed_observers_launch_the_kernel_on_card(ndev):
    """With the flight ring, hist banks and trace threaded, the graphed
    round launches ``heard_counts`` once a round for the trace and the
    flight row and once a non-quiescent round for the spread, on one card
    and on shards; the results equal the eager round's."""
    _need_card()
    from consul_tpu_torch.gossip import observe
    from consul_tpu_torch.gossip.params import lan_profile
    n, steps = 4000, 120
    p = lan_profile(n, slots=32, loss_rate=0.01, hot_slots=8)
    fail, join = _churn_inputs(n, steps, 7)
    st = tk.init_state(p)._replace(member=torch.from_numpy(join == NEVER)
                                   .cuda())
    runs = {}
    for graphed in (False, True):
        program.settle_counts()
        n0, tails = observe.launches, dict(tk.tail_rounds)
        a = dict(trace=True, join_round=join, flight=tk.init_flight(),
                 hist=tk.init_hist(), graphed=graphed)
        if ndev:
            out = tk.run_rounds_sharded(st, prng.key(8), fail, p, steps,
                                        ndev=ndev, **a)
        else:
            out = tk.run_rounds(st, prng.key(8), fail, p, steps, **a)
        torch.cuda.synchronize()
        program.settle_counts()
        busy = sum(tk.tail_rounds[k] - tails[k] for k in ("hot", "full"))
        assert busy > 0
        assert observe.launches - n0 == steps + busy
        runs[graphed] = out
    (ce, te), (cg, tg) = runs[False], runs[True]
    assert _same_fields(list(ce) + [te], list(cg) + [tg]) == []
    assert int(ce[2].spread.sum()) > 0


def test_round_programs_own_their_observer_scratch():
    """Each round program launches the observers' kernel with a scratch
    of its own, left zero by its replays."""
    _need_card()
    from consul_tpu_torch.gossip.params import lan_profile
    before = {id(g) for g in program._programs.values()}
    for n in (4000, 8000):
        p = lan_profile(n, slots=24, loss_rate=0.01, hot_slots=8)
        fail, join = _churn_inputs(n, 60, 3)
        st = tk.init_state(p)._replace(
            member=torch.from_numpy(join == NEVER).cuda())
        tk.run_rounds(st, prng.key(5), fail, p, 60, trace=True,
                      join_round=join, flight=tk.init_flight(),
                      hist=tk.init_hist(), graphed=True)
    torch.cuda.synchronize()
    progs = [g for g in program._programs.values() if id(g) not in before]
    assert len(progs) == 2
    assert len({g.obs_scratch.data_ptr() for g in progs}) == 2
    assert all(int(g.obs_scratch.abs().sum()) == 0 for g in progs)


def _finish_inputs(R, N, seed):
    """Bytes of every message, conf and age (a third any byte value), rx
    with holes, a timer mask a row (0 on about half the rows), a
    refutation on some rows."""
    rng = np.random.default_rng(seed)
    heard = np.where(rng.random((R, N)) < 0.35,
                     rng.integers(0, 256, (R, N)),
                     rng.integers(0, 4, (R, N)) << 6
                     | rng.integers(0, 4, (R, N)) << 4
                     | rng.integers(0, 16, (R, N))).astype(np.uint8)
    rx = rng.random(N) < 0.8
    ok = np.where(rng.random(R) < 0.5, rng.integers(1, 16, R), 0)
    ok[0] = 15
    col = rng.integers(0, N, R).astype(np.int32)
    rb = np.where(rng.random(R) < 0.4, 0xC0, 0).astype(np.uint8)
    return [torch.from_numpy(a).cuda() for a in (heard, rx,
                                                 ok.astype(np.uint8), col,
                                                 rb)]


@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("R, N, ndev", [(64, 4096, 1), (8, 1001, 1),
                                        (64, 4104, 2), (16, 8 * 1250, 8),
                                        (64, 8 * 31_250, 8), (5, 7, 1),
                                        (16, 8 * 125_000, 8)])
def test_finish_kernels_match_plain_on_card(R, N, ndev, offset):
    """``csrc/finish.cu`` against ``fire_timers_ref`` / ``wipe_rows_ref``
    on the card: rows at every phase mod 16 (L % 16 of 0, 8, 2 and odd N;
    the shards ``offset`` bytes into buffers of their own), 1, 2 and 8
    shards, with and without the refutation, no row live and some: every
    byte and ``fired``, tolerance 0; one launch each."""
    _need_card()
    from consul_tpu_torch.gossip import finish
    heard, rx, ok, col, rb = _finish_inputs(R, N, seed=R + N)
    L = N // ndev

    def split(h):
        out = []
        for i in range(ndev):
            o = (offset * (i + 1)) % 16
            buf = torch.empty(R * L + 16, dtype=h.dtype, device=h.device)
            out.append(buf[o:o + R * L].view(R, L))
            out[-1].copy_(h[:, i * L:(i + 1) * L])
        return tuple(out) if ndev > 1 else out[0]

    for mask in (ok, torch.zeros_like(ok)):
        for refute in (None, (col, rb)):
            got, ref = split(heard), split(heard)
            n0 = finish.fire_launches
            fired = finish.fire_timers(got, rx, mask, refute)
            torch.cuda.synchronize()
            assert finish.fire_launches == n0 + 1
            assert torch.equal(fired, finish.fire_timers_ref(ref, rx, mask,
                                                             refute))
            for a, b in zip(got if ndev > 1 else (got,),
                            ref if ndev > 1 else (ref,)):
                assert torch.equal(a, b)
    for flags in (ok > 0, torch.zeros_like(ok, dtype=torch.bool),
                  torch.ones_like(ok, dtype=torch.bool)):
        got, ref = split(heard), split(heard)
        n0 = finish.wipe_launches
        finish.wipe_rows(got, flags)
        torch.cuda.synchronize()
        assert finish.wipe_launches == n0 + 1
        finish.wipe_rows_ref(ref, flags)
        for a, b in zip(got if ndev > 1 else (got,),
                        ref if ndev > 1 else (ref,)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("ndev", [None, 4])
def test_graphed_round_launches_finish_on_card(ndev):
    """The graphed round launches ``fire_timers`` and ``wipe_rows`` once
    a non-quiescent round (the fire and the GC) and ``wipe_rows`` once
    more a join round (the stale wipe; the probe tick's rearm wipe is
    inside ``probe_rearm_marks``); its matrix is copied once a call and
    once a full-tail round; results equal the eager round's, which
    launches the same."""
    _need_card()
    from consul_tpu_torch.gossip import finish
    from consul_tpu_torch.gossip.params import lan_profile
    n, steps = 4000, 120
    p = lan_profile(n, slots=32, loss_rate=0.01, hot_slots=8)
    fail, join = _churn_inputs(n, steps, 9)
    st = tk.init_state(p)._replace(member=torch.from_numpy(join == NEVER)
                                   .cuda())
    before = {f: getattr(st, f).clone() for f in st._fields}
    runs = {}
    for graphed in (False, True):
        program.settle_counts()
        f0, w0, j0 = finish.fire_launches, finish.wipe_launches, \
            tk.join_rounds
        c0, tails = program.copy_bytes, dict(tk.tail_rounds)
        a = dict(trace=True, join_round=join, flight=tk.init_flight(),
                 hist=tk.init_hist(), graphed=graphed)
        if ndev:
            out = tk.run_rounds_sharded(st, prng.key(8), fail, p, steps,
                                        ndev=ndev, **a)
        else:
            out = tk.run_rounds(st, prng.key(8), fail, p, steps, **a)
        torch.cuda.synchronize()
        program.settle_counts()
        busy = sum(tk.tail_rounds[k] - tails[k] for k in ("hot", "full"))
        joins = tk.join_rounds - j0
        assert busy > 0 and joins > 0
        assert finish.fire_launches - f0 == busy
        assert finish.wipe_launches - w0 == joins + busy
        full = tk.tail_rounds["full"] - tails["full"]
        copied = program.copy_bytes - c0
        assert copied == (p.slots * p.n * (1 + full) if graphed else 0)
        runs[graphed] = out
    (ce, te), (cg, tg) = runs[False], runs[True]
    assert _same_fields(list(ce) + [te], list(cg) + [tg]) == []
    for f in st._fields:
        assert torch.equal(before[f], getattr(st, f)), f


def _probe_tick_inputs(n, slots, probe_every, ndev, seed, nem=None,
                       lhm=False):
    """A probe tick's inputs on the card (``probe.Tick``) and its
    configuration: a prober block half of whose lanes probe a dead
    member, slots in every phase on targets of the round, every byte
    value in the matrix, NemState where ``lhm``."""
    from consul_tpu_torch.gossip import probe, round_args
    from consul_tpu_torch.gossip.params import SwimParams
    rng = np.random.default_rng(seed)
    p = SwimParams(n=n, slots=slots, probe_every=probe_every,
                   loss_rate=0.05)
    rnd = 52
    cfg = probe.config(p, tk.round_variant(p, nem, rnd), nem)
    ra = round_args.row_args(
        round_args.layout(p.fanout, p.indirect_k),
        torch.from_numpy(round_args.build(p, prng.key(seed), rnd, 1)[0])
        .cuda())
    blk, o_t = int(ra.blk), int(ra.probe[0])
    mf = rng.choice(np.asarray([-1, 10, rnd, NEVER], np.int32), n,
                    p=[0.1, 0.2, 0.1, 0.6])
    pids = [blk + i for i in rng.permutation(cfg.B) if blk + i < n]
    tgts = [(q + o_t) % n for q in pids]
    for q, t in zip(pids[:len(pids) // 2], tgts[:len(pids) // 2]):
        mf[q], mf[t] = NEVER, 10
    subjects = list(dict.fromkeys(tgts[1:slots]))[:slots - 4]
    slot_node = np.full(slots, -1, np.int32)
    slot_node[:len(subjects)] = subjects
    son = np.full(n, -1, np.int32)
    son[subjects] = np.arange(len(subjects), dtype=np.int32)
    heard = torch.from_numpy(rng.integers(0, 256, (slots, n))
                             .astype(np.uint8)).cuda()
    if ndev > 1:
        L = n // ndev
        heard = tuple(heard[:, i * L:(i + 1) * L].clone()
                      for i in range(ndev))
    regs = (slot_node, np.where(slot_node >= 0, rng.integers(1, 5, slots),
                                0), rng.integers(0, 9, slots),
            rng.integers(0, rnd, slots), rng.integers(0, 4, slots),
            np.full(slots, -1))
    ns = None
    if lhm:
        ns = tk.NemState(*(torch.from_numpy(rng.integers(0, 4, n).astype(
            np.int32)).cuda() for _ in range(2)))
    return cfg, probe.Tick(
        heard, ra, torch.from_numpy(mf).cuda(), torch.from_numpy(son).cuda(),
        ns, tuple(torch.from_numpy(np.asarray(r, np.int32)).cuda()
                  for r in regs),
        torch.from_numpy(rng.integers(0, 9, n).astype(np.int32)).cuda(),
        torch.tensor(2**31 - 2, dtype=torch.int32).cuda(),
        probe.scratch(p, "cuda"))


@pytest.mark.parametrize("n, slots, probe_every, ndev, legs", [
    (4000, 32, 5, 1, False), (4001, 32, 5, 1, True), (4000, 32, 5, 8, True),
    (12, 32, 10, 1, False), (200_000, 64, 5, 1, True)])
def test_probe_kernels_match_plain_on_card(n, slots, probe_every, ndev,
                                           legs):
    """``csrc/probe.cu`` against ``probe_lanes_ref`` then
    ``probe_slots_ref`` (the merged launch) and the rearm's wipe then
    ``probe_marks_ref`` (``probe_rearm_marks``) on the card: every output
    field after each, tolerance 0, one launch each; aligned and unaligned
    N, 8 shards, the WAN pool's two lanes, the partition and degraded legs
    with NemState."""
    _need_card()
    from consul_tpu_torch.gossip import finish, probe
    from consul_tpu_torch.gossip.nemesis import NemesisParams
    nem = (NemesisParams(scenario="probe", start=0, stop=NEVER,
                         part_kind="hash", p_ab=0.6, p_ba=0.1, obs_lo=0,
                         obs_hi=n, p_obs_miss=0.3, lhm_max=3)
           if legs else None)
    cfg, t = _probe_tick_inputs(n, slots, probe_every, ndev, n + slots,
                                nem, legs)

    def copy(t):
        heard = (tuple(h.clone() for h in t.heard)
                 if isinstance(t.heard, tuple) else t.heard.clone())
        ns = None if t.nem_state is None else tk.NemState(
            *(x.clone() for x in t.nem_state))
        return t._replace(heard=heard, slot_of_node=t.slot_of_node.clone(),
                          nem_state=ns,
                          slots=tuple(x.clone() for x in t.slots),
                          drops=t.drops.clone(), sp=t.sp.clone())

    def leaves(t):
        heard = t.heard if isinstance(t.heard, tuple) else (t.heard,)
        return [*heard, t.slot_of_node, *(t.nem_state or ()), *t.slots,
                t.drops, t.sp]

    got, want = copy(t), copy(t)
    n0 = (probe.lanes_slots_launches, probe.rearm_marks_launches)
    rearm, stats = probe.probe_lanes_slots(cfg, got)
    probe.probe_lanes_ref(cfg, want.ra, want.mf, want.heard,
                          want.slot_of_node, want.nem_state, want.sp)
    rearm_w, stats_w = probe.probe_slots_ref(
        cfg, want.ra, want.slots, want.slot_of_node, want.incarnation,
        want.drops, want.sp)
    torch.cuda.synchronize()
    assert torch.equal(rearm, rearm_w) and torch.equal(stats, stats_w)
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    probe.probe_rearm_marks(cfg, got, rearm)
    finish.wipe_rows_ref(want.heard, rearm_w)
    probe.probe_marks_ref(cfg, want.ra, want.heard, want.slot_of_node,
                          want.sp)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))
    assert (probe.lanes_slots_launches,
            probe.rearm_marks_launches) == tuple(x + 1 for x in n0)
    assert int(stats[3]) > 0


@pytest.mark.parametrize("ndev", [None, 4])
def test_graphed_round_launches_probe_on_card(ndev):
    """The graphed and the eager round launch each of ``probe.cu``'s two
    kernels once a round and the draws' kernel not at all (no nemesis);
    their results are equal and the caller's state and NemState are left
    as they were."""
    _need_card()
    from consul_tpu_torch.gossip import probe
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile
    n, steps = 4000, 60
    p = lan_profile(n, slots=32, loss_rate=0.01, hot_slots=8)
    fail, join = _churn_inputs(n, steps, 9)
    sc = build("degraded_observer", n)
    st = tk.init_state(p)._replace(member=torch.from_numpy(join == NEVER)
                                   .cuda())
    ns = tk.init_nem_state(n, device="cuda")
    before = [x.clone() for x in list(st) + list(ns)]
    runs = {}
    for graphed in (False, True):
        program.settle_counts()
        n0 = (probe.lanes_slots_launches, probe.rearm_marks_launches)
        d0 = prng.launches
        a = dict(join_round=join, graphed=graphed, nem=sc.nem,
                 nem_state=ns)
        if ndev:
            out = tk.run_rounds_sharded(st, prng.key(8), fail, p, steps,
                                        ndev=ndev, **a)
        else:
            out = tk.run_rounds(st, prng.key(8), fail, p, steps, **a)
        torch.cuda.synchronize()
        program.settle_counts()
        assert (probe.lanes_slots_launches,
                probe.rearm_marks_launches) == tuple(x + steps for x in n0)
        assert prng.launches == d0
        runs[graphed] = out
    assert _same_fields(list(runs[False][0]), list(runs[True][0])) == []
    for a, b in zip(before, list(st) + list(ns)):
        assert torch.equal(a, b)


def _finish_slots_inputs(n, S, hot, ndev, hist, lhm, refute, seed):
    """The finish step's inputs on the card: distinct live subjects in
    every phase, starts and dead rounds on both sides of the timers, the
    TTL and the GC window, every byte value, 30% SUSPECT bytes; hot cases
    list their live slots and then free ones."""
    from consul_tpu_torch.gossip import finish_slots
    from consul_tpu_torch.gossip.nemesis import NemesisParams
    from consul_tpu_torch.gossip.params import lan_profile
    p = lan_profile(n, slots=S, refute=refute)
    cfg = finish_slots.config(p, NemesisParams(
        scenario="probe", start=0, stop=NEVER, lhm_max=3) if lhm else None)
    rnd = p.slot_ttl_rounds + 300
    rng = np.random.default_rng(seed)
    live = min(S if hot is None else hot - 3, n)
    subjects = rng.permutation(n)[:live].astype(np.int32)
    slots = np.sort(rng.permutation(S)[:live])
    node = np.full(S, -1, np.int32)
    node[slots] = subjects
    phase = np.zeros(S, np.int32)
    phase[slots] = rng.choice([1, 1, 2, 3, 4], live)
    start = np.zeros(S, np.int32)
    start[slots] = rnd - rng.integers(0, p.slot_ttl_rounds + 20, live)
    dead = np.full(S, -1, np.int32)
    late = slots[phase[slots] != 1]
    dead[late] = rnd - rng.integers(0, 3 * cfg.gc_rounds, late.size)
    fail = rng.choice(np.asarray([NEVER, rnd - 40, rnd + 3], np.int32), n,
                      p=[0.6, 0.3, 0.1])
    member = rng.random(n) < 0.92
    heard = rng.integers(0, 256, (S, n)).astype(np.uint8)
    heard = np.where(rng.random((S, n)) < 0.3, heard & 0x3F | 0x40, heard)
    son = np.full(n, -1, np.int32)
    son[subjects] = slots
    idx = np.arange(S, dtype=np.int32)
    if hot is not None:
        idx = np.argsort(-(node >= 0).astype(np.int32),
                         kind="stable")[:hot].astype(np.int32)
    cuda = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in
            dict(node=node, phase=phase, start=start, dead=dead, fail=fail,
                 member=member, heard=heard[idx], son=son, idx=idx,
                 cc=np.clip(rng.integers(0, 5, S) - 1, 0, 3).astype(
                     np.int32),
                 inc=rng.integers(0, 9, n).astype(np.int32)).items()}
    sub = cuda["heard"]
    if ndev:
        L = n // ndev
        sub = tuple(sub[:, i * L:(i + 1) * L].clone() for i in range(ndev))
    t = finish_slots.Step(
        sub, torch.tensor(rnd, dtype=torch.int32, device="cuda"),
        cuda["idx"], tuple(cuda[k] for k in ("node", "phase", "start",
                                              "dead")), cuda["cc"],
        cuda["fail"] > rnd, cuda["member"], cuda["fail"], cuda["son"],
        cuda["inc"], tuple(torch.tensor(v, dtype=torch.int32, device="cuda")
                           for v in (2**31 - 2, 5, 2**31 - 1, 7)),
        torch.randint(0, 4, (n,), dtype=torch.int32, device="cuda")
        if lhm else None, tk.init_hist() if hist else None)
    return cfg, t, (cuda["fail"] > rnd) & cuda["member"]


@pytest.mark.parametrize("n, S, hot, ndev, hist, lhm, refute", [
    (4000, 64, None, None, True, True, True),
    (4000, 64, 8, None, True, False, True),
    (4000, 64, None, 8, False, True, True),
    (4001, 32, None, None, True, False, False),
    (12, 32, None, None, False, False, True)])
def test_finish_slots_kernels_match_plain_on_card(n, S, hot, ndev, hist,
                                                  lhm, refute):
    """``csrc/finish_slots.cu``'s three kernels against their plain
    versions, with the fire pass and the spread's count between them as
    the round runs them: every field and output after every launch,
    tolerance 0, one launch each."""
    _need_card()
    from consul_tpu_torch.gossip import finish, finish_slots as fs, observe
    cfg, t, rx = _finish_slots_inputs(n, S, hot, ndev, hist, lhm, refute,
                                      n + S)

    def copy(t):
        heard = (tuple(h.clone() for h in t.heard)
                 if isinstance(t.heard, tuple) else t.heard.clone())
        return t._replace(
            heard=heard, slots=tuple(x.clone() for x in t.slots),
            member=t.member.clone(), slot_of_node=t.slot_of_node.clone(),
            incarnation=t.incarnation.clone(),
            stats=tuple(x.clone() for x in t.stats),
            lhm=None if t.lhm is None else t.lhm.clone(),
            hist=None if t.hist is None else tk.HistBank(
                *(x.clone() for x in t.hist)))

    def leaves(t):
        heard = t.heard if isinstance(t.heard, tuple) else (t.heard,)
        return [*heard, *t.slots, t.member, t.slot_of_node, t.incarnation,
                *t.stats, *([] if t.lhm is None else [t.lhm]),
                *(t.hist or ())]

    def same(a, b):
        torch.cuda.synchronize()
        return all((x is None and y is None) or torch.equal(x, y)
                   for x, y in zip(a, b))

    got, want = copy(t), copy(t)
    n0 = (fs.decide_launches, fs.settle_launches, fs.record_launches)
    # Decide loads before it waits for the kernel before it: the copies
    # end first.
    torch.cuda.synchronize()
    dec = fs.finish_decide(cfg, got)
    dec_w = fs.finish_decide_ref(cfg, want)
    assert same(leaves(got) + [dec.ok_mask, *(dec.refute or ())],
                leaves(want) + [dec_w.ok_mask, *(dec_w.refute or ())])
    fired = finish.fire_timers(got.heard, rx, dec.ok_mask, dec.refute)
    fired_w = finish.fire_timers_ref(want.heard, rx, dec_w.ok_mask,
                                     dec_w.refute)
    st = fs.finish_settle(cfg, got, fired)
    st_w = fs.finish_settle_ref(cfg, want, fired_w)
    assert same(leaves(got) + list(st), leaves(want) + list(st_w))
    n_hold = n_hold_w = None
    if hist:
        n_hold = observe.heard_counts(got.heard, got.member, cfg.budget,
                                      st.verdict, st.spread)[observe.HOLD]
        n_hold_w = observe.heard_counts_ref(
            want.heard, want.member, cfg.budget, st_w.verdict,
            st_w.spread)[observe.HOLD]
    fs.finish_record(cfg, got, dec, st, n_hold)
    fs.finish_record_ref(cfg, want, dec_w, st_w, n_hold_w)
    assert same(leaves(got), leaves(want))
    assert (fs.decide_launches, fs.settle_launches,
            fs.record_launches) == tuple(x + 1 for x in n0)
    assert bool(fired.any()) or bool(st.expired.any())


@pytest.mark.parametrize("ndev", [None, 8])
def test_decide_after_tail_matches_plain_on_card(ndev):
    """Decide as the round makes it, right after the tail (a programmatic
    dependent launch behind a kernel that triggers it as it starts), on
    rows whose own bytes are zero before the tail, so that a row refutes
    only where the tail's merge made its byte SUSPECT or DEAD, against its
    plain version on the tail's output: every field and output, tolerance
    0, and rows refute."""
    _need_card()
    from consul_tpu_torch.gossip import finish_slots as fs
    from consul_tpu_torch.gossip.params import lan_profile
    n, S = 4000, 64
    cfg, t, rx_ok = _finish_slots_inputs(n, S, None, ndev, False, True,
                                         True, 4064)
    p = lan_profile(n, slots=S, refute=True)
    shards = t.heard if isinstance(t.heard, tuple) else (t.heard,)
    L = shards[0].shape[1]
    for h, col in enumerate(t.slots[0].clamp(0, n - 1).tolist()):
        shards[col // L][h, col % L] = 0
    rnd, offs = fused.tail_args(
        int(t.rnd), np.random.default_rng(4064).integers(1, n, p.fanout),
        "cuda")
    sc = None if ndev is None else tk._ShardCtx(ndev, L)

    def copy(t):
        return t._replace(
            slots=tuple(x.clone() for x in t.slots),
            member=t.member.clone(), incarnation=t.incarnation.clone(),
            stats=tuple(x.clone() for x in t.stats),
            lhm=None if t.lhm is None else t.lhm.clone())

    before = fs.finish_decide_ref(cfg, copy(t))
    assert int(before.refute[1].count_nonzero()) == 0
    got, want = copy(t), copy(t)
    torch.cuda.synchronize()
    out = fused.disseminate(p, rnd, offs, t.heard, t.fail_round, rx_ok,
                            t.conf_cap, sc, None)
    dec = fs.decide(cfg, got._replace(heard=out))
    torch.cuda.synchronize()
    dec_w = fs.finish_decide_ref(cfg, want._replace(heard=out))
    for x, y in zip([*got.slots, got.incarnation, *got.stats, got.lhm,
                     dec.ok_mask, *dec.refute],
                    [*want.slots, want.incarnation, *want.stats, want.lhm,
                     dec_w.ok_mask, *dec_w.refute]):
        assert torch.equal(x, y)
    assert int(dec.refute[1].count_nonzero()) > 0


@pytest.mark.parametrize("ndev", [None, 4])
def test_graphed_round_launches_finish_slots_on_card(ndev):
    """The graphed and the eager round launch each of
    ``finish_slots.cu``'s kernels once a non-quiescent round, with the hist
    banks and NemState threaded; their results are equal and the caller's
    state, banks and NemState are left as they were."""
    _need_card()
    from consul_tpu_torch.gossip import finish_slots as fs
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile
    n, steps = 4000, 80
    p = lan_profile(n, slots=32, loss_rate=0.01, hot_slots=8)
    fail, join = _churn_inputs(n, steps, 9)
    sc = build("degraded_observer", n)
    st = tk.init_state(p)._replace(member=torch.from_numpy(join == NEVER)
                                   .cuda())
    ns = tk.init_nem_state(n, device="cuda")
    hist = tk.init_hist()
    before = [x.clone() for x in list(st) + list(ns) + list(hist)]
    runs = {}
    for graphed in (False, True):
        program.settle_counts()
        n0 = (fs.decide_launches, fs.settle_launches, fs.record_launches)
        tails = dict(tk.tail_rounds)
        a = dict(join_round=join, graphed=graphed, nem=sc.nem,
                 nem_state=ns, hist=hist)
        if ndev:
            out = tk.run_rounds_sharded(st, prng.key(8), fail, p, steps,
                                        ndev=ndev, **a)
        else:
            out = tk.run_rounds(st, prng.key(8), fail, p, steps, **a)
        torch.cuda.synchronize()
        program.settle_counts()
        busy = sum(tk.tail_rounds[k] - tails[k] for k in ("hot", "full"))
        assert busy > 0
        assert (fs.decide_launches, fs.settle_launches,
                fs.record_launches) == tuple(x + busy for x in n0)
        runs[graphed] = out
    assert _same_fields(list(runs[False][0]), list(runs[True][0])) == []
    for a, b in zip(before, list(st) + list(ns) + list(hist)):
        assert torch.equal(a, b)
