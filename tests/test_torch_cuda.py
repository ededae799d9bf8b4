"""The port on a CUDA card: the Hopper kernels (fused_dissem and the
sharded round's all-shards fused_merge) against their plain torch
versions, the
whole round loop on the card against the same loop on the CPU, and the
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
from consul_tpu_torch.gossip import fused
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
    for offs in ([1, N - 1, 7], [3], [N - 1] * 8):
        ref = fused.disseminate_ref(p, 50, offs, heard, mf, rx_ok, cap)
        out = fused.fused_dissem(heard, offs, mf, rx_ok, cap, 50,
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
    launches0 = fused.launches
    outs = []
    for dev in ("cuda", "cpu"):
        st = tk.init_state(p, device=dev)._replace(
            member=torch.from_numpy(join == NEVER).to(dev))
        outs.append(tk.run_rounds(st, prng.key(2), fail, p, 200,
                                  trace=True, join_round=join,
                                  flight=tk.init_flight(device=dev),
                                  hist=tk.init_hist(device=dev), device=dev))
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
            offs = ([1, N - 1, L + 3] + rng.integers(1, N, F).tolist())[:F]
            p = SwimParams(n=N, slots=S, fanout=F)
            ref = fused.merge_shards_ref(p, 50, offs, shards, mf, rx_ok, cap,
                                         sc)
            out = fused.fused_merge(shards, offs, mf, rx_ok, cap, 50,
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
    offs = [1, N - 1, 7]
    for dr in (drop, drop != 0):
        ref = fused.disseminate_ref(p, 50, offs, heard, mf, rx_ok, cap, dr)
        before = fused.drop_launches
        out = fused.fused_dissem(heard, offs, mf, rx_ok, cap, 50,
                                 p.spread_budget_rounds, dr)
        torch.cuda.synchronize()
        assert torch.equal(out, ref) and fused.drop_launches == before + 1
    for ndev in (1, 2):
        L = N // ndev
        if L * ndev != N:
            continue
        shards = tuple(h.contiguous() for h in heard.split(L, dim=1))
        ref = fused.merge_shards_ref(p, 50, offs, shards, mf, rx_ok, cap,
                                     tk._ShardCtx(ndev, L), drop)
        out = fused.fused_merge(shards, offs, mf, rx_ok, cap, 50,
                                p.spread_budget_rounds, drop)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    for bad in (drop.cpu(), drop[:2].contiguous()):
        with pytest.raises(ValueError, match="drop"):
            fused.fused_dissem(heard, offs, mf, rx_ok, cap, 50,
                               p.spread_budget_rounds, bad)
