"""The port's dense dissemination tail (consul_tpu_torch/gossip/fused.py)
against the reference's ``kernel._disseminate``: the XLA SWAR lowering
(``dissem="swar"``) and the Pallas kernel in interpret mode
(``dissem="fused"``).  Exact: belief bytes are compared byte for byte.

On the CPU the port runs the kernel's plain torch version; the
``cuda``-marked test holds the Hopper kernel against it on a card."""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip.params import SwimParams as JParams
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import fused
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip.params import SwimParams as TParams

NEVER = 2**31 - 1


def _random_round_inputs(S, N, seed=0):
    """A saturated, adversarial belief matrix + masks: every message
    kind, confirmation count, and age (incl. the fresh sentinel and
    budget-edge values)."""
    rng = np.random.default_rng(seed)
    heard = ((rng.integers(0, 4, (S, N)) << 6)
             | (rng.integers(0, 4, (S, N)) << 4)
             | rng.integers(0, 16, (S, N))).astype(np.uint8)
    mf = rng.choice(np.asarray([-1, 10, 200, NEVER], np.int32), (N,))
    rx_ok = rng.random(N) < 0.9
    conf_cap = rng.integers(0, 4, (S,)).astype(np.int32)
    return heard, mf, rx_ok, conf_cap


def _ref(dissem, heard, mf, rx_ok, cap, rnd, seed, **kw):
    S, N = heard.shape
    p = JParams(n=N, slots=S, dissem=dissem, **kw)
    return np.asarray(jk._disseminate(p, rnd, jax.random.key(seed),
                                      jax.numpy.asarray(heard),
                                      jax.numpy.asarray(mf),
                                      jax.numpy.asarray(rx_ok),
                                      jax.numpy.asarray(cap)))


def _port(heard, mf, rx_ok, cap, rnd, seed, slots=None, **kw):
    S, N = heard.shape
    p = TParams(n=N, slots=slots or S, **kw)
    out = tk._disseminate(p, rnd, prng.key(seed), torch.from_numpy(heard),
                          torch.from_numpy(mf), torch.from_numpy(rx_ok),
                          torch.from_numpy(cap))
    assert out.dtype == torch.uint8
    return out.numpy()


@pytest.mark.parametrize("dissem", ["swar", "fused"])
@pytest.mark.parametrize("shape", [(4, 24), (8, 120), (16, 96), (6, 40)])
def test_tail_matches_reference(shape, dissem):
    S, N = shape
    heard, mf, rx_ok, cap = _random_round_inputs(S, N, seed=S + N)
    for rnd, seed in ((50, 3), (5, 8), (150, 21)):
        np.testing.assert_array_equal(
            _port(heard, mf, rx_ok, cap, rnd, seed, dissem=dissem),
            _ref(dissem, heard, mf, rx_ok, cap, rnd, seed),
            err_msg=f"{shape} {dissem} rnd={rnd}")


@pytest.mark.parametrize("dissem", ["swar", "fused"])
def test_hot_tier_subset(dissem):
    """The hot tail's call: an [H, N] row subset with cap[idx]."""
    S, N, H = 16, 120, 4
    heard, mf, rx_ok, cap = _random_round_inputs(S, N, seed=5)
    idx = np.asarray([2, 3, 9, 0])
    sub, cap_sub = np.ascontiguousarray(heard[idx]), cap[idx]
    ref = _ref(dissem, sub, mf, rx_ok, cap_sub, 60, 4)
    got = _port(sub, mf, rx_ok, cap_sub, 60, 4, slots=S, dissem=dissem,
                hot_slots=H)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kw", [dict(fanout=1), dict(fanout=4),
                                dict(retransmit_mult=1.0),
                                dict(max_confirmations=1)])
def test_tail_other_params(kw):
    S, N = 8, 64
    heard, mf, rx_ok, cap = _random_round_inputs(S, N, seed=9)
    np.testing.assert_array_equal(
        _port(heard, mf, rx_ok, cap, 40, 2, **kw),
        _ref("swar", heard, mf, rx_ok, cap, 40, 2, **kw))


def test_fused_nb_must_divide_n():
    S, N = 4, 24
    heard, mf, rx_ok, cap = _random_round_inputs(S, N)
    with pytest.raises(ValueError, match="fused_nb"):
        _ref("fused", heard, mf, rx_ok, cap, 50, 3, fused_nb=7)
    with pytest.raises(ValueError, match="fused_nb") as port_err:
        _port(heard, mf, rx_ok, cap, 50, 3, dissem="fused", fused_nb=7)
    assert "n=24 must be divisible by fused_nb=7" in str(port_err.value)
    # Any divisor is accepted and changes nothing in the port.
    ref = _ref("swar", heard, mf, rx_ok, cap, 50, 3)
    for nb in (1, 4, 24):
        np.testing.assert_array_equal(
            _port(heard, mf, rx_ok, cap, 50, 3, dissem="fused", fused_nb=nb),
            ref)


def test_dissem_value_validated():
    with pytest.raises(ValueError, match="dissem"):
        TParams(n=64, dissem="bogus")  # noqa: K02 — the invalid value is the point
    with pytest.raises(ValueError, match="fused_nb"):
        TParams(n=64, fused_nb=0)


def test_age_tick_matches_reference():
    heard, *_ = _random_round_inputs(8, 200, seed=3)
    np.testing.assert_array_equal(
        tk._age_tick(torch.from_numpy(heard)).numpy(),
        np.asarray(jk._age_tick(jax.numpy.asarray(heard))))


@pytest.mark.parametrize("seed", range(4))
def test_alloc_free_slots_matches_reference(seed):
    rng = np.random.default_rng(seed)
    free = rng.random(16) < 0.4
    want = rng.random(16) < 0.5
    a = jk.alloc_free_slots(jax.numpy.asarray(free), jax.numpy.asarray(want))
    b = tk.alloc_free_slots(torch.from_numpy(free), torch.from_numpy(want))
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), y.numpy())


def test_gossip_offsets_match_reference():
    for seed in range(5):
        for n, fanout in ((240, 3), (2, 3), (1_000_000, 4)):
            a = np.asarray(jk.gossip_offsets(jax.random.key(seed), n, fanout))
            assert a.tolist() == tk.gossip_offsets(prng.key(seed), n, fanout)


@pytest.mark.parametrize("shape", [(4, 24), (6, 40), (16, 96)])
def test_plain_version_matches_reference_directly(shape):
    """``disseminate_ref`` itself (the plain version the card's kernel is
    held against) with the reference's own gossip offsets, against the
    reference's Pallas kernel in interpret mode."""
    S, N = shape
    heard, mf, rx_ok, cap = _random_round_inputs(S, N, seed=2 * S + N)
    offs = tk.gossip_offsets(prng.key(6), N, 3)
    p = TParams(n=N, slots=S)
    got = fused.disseminate_ref(p, 70, offs, torch.from_numpy(heard),
                                torch.from_numpy(mf), torch.from_numpy(rx_ok),
                                torch.from_numpy(cap))
    np.testing.assert_array_equal(
        got.numpy(), _ref("fused", heard, mf, rx_ok, cap, 70, 6))


# -- the drop operand (a nemesis partition's per-leg drops) -------------------

def _nem_tail(name, sharded, S, N, rnd, seed):
    """The reference's ``fused_disseminate`` (Pallas, interpret mode)
    under scenario ``name``'s partition legs, single-device or on 8
    shards under ``shard_map``, and the port's tail on the same inputs:
    ``disseminate_ref`` / ``merge_shards_ref`` given the drop operand
    the port's round builds (``kernel._disseminate``)."""
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as Ps

    from consul_tpu.gossip import fused as j_fused
    from consul_tpu.gossip.nemesis import build as j_build
    from consul_tpu_torch.gossip.nemesis import build as t_build

    heard, mf, rx_ok, cap = _random_round_inputs(S, N, seed=seed)
    jp = JParams(n=N, slots=S, dissem="fused")
    tp = TParams(n=N, slots=S, dissem="fused")
    jnem, tnem = j_build(name, N).nem, t_build(name, N).nem
    k_gossip, k_nem = seed + 1, seed + 2
    args = [jax.numpy.asarray(a) for a in (heard, mf, rx_ok, cap)]
    if not sharded:
        want = j_fused.fused_disseminate(
            jp, rnd, jax.random.key(k_gossip), *args, nem=jnem,
            k_nem=jax.random.key(k_nem))
    else:
        sc = jk._ShardCtx(8, N // 8)

        def body(h, m, r, c):
            return j_fused.fused_disseminate(
                jp, rnd, jax.random.key(k_gossip), h, m, r, c, sc, jnem,
                jax.random.key(k_nem))

        fn = shard_map(body, mesh=jk._shard_mesh(8),
                       in_specs=(Ps(None, jk._SHARD_AXIS), Ps(), Ps(), Ps()),
                       out_specs=Ps(None, jk._SHARD_AXIS), check_rep=False)
        want = jax.jit(fn)(*args)
    offs = tk.gossip_offsets(prng.key(k_gossip), N, tp.fanout)
    drop = None
    if tk._nem_in_window(tnem, rnd):
        drop = tk._nem_edge_drops(tnem, N, torch.device("cpu"),
                                  [prng.fold_in(prng.key(k_nem), f)
                                   for f in range(tp.fanout)], offs)
    t = [torch.from_numpy(a) for a in (heard, mf, rx_ok, cap)]
    if not sharded:
        got = fused.disseminate_ref(tp, rnd, offs, *t, drop=drop)
    else:
        L = N // 8
        shards = tuple(t[0][:, i * L:(i + 1) * L].contiguous()
                       for i in range(8))
        got = torch.cat(fused.merge_shards_ref(
            tp, rnd, offs, shards, *t[1:], tk._ShardCtx(8, L), drop=drop),
            dim=1)
    return np.asarray(want), got.numpy(), drop


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("name, rnd, in_window", [
    ("partition_heal", 50, True), ("partition_heal", 170, False),
    ("asym_loss", 30, True), ("asym_loss", 10, False)])
def test_drop_operand_matches_reference(name, rnd, in_window, sharded):
    want, got, drop = _nem_tail(name, sharded, 8, 160, rnd, seed=rnd)
    np.testing.assert_array_equal(got, want)
    assert (drop is not None) == in_window
    if drop is not None:
        # Not vacuous: some cross-group leg dropped, and the drops change
        # the result.
        assert bool(drop.any())
        heard, mf, rx_ok, cap = _random_round_inputs(8, 160, seed=rnd)
        offs = tk.gossip_offsets(prng.key(rnd + 1), 160, 3)
        free = fused.disseminate_ref(TParams(n=160, slots=8), rnd, offs,
                                     *(torch.from_numpy(a) for a in
                                       (heard, mf, rx_ok, cap)))
        assert not np.array_equal(free.numpy(), got)


def test_drop_operand_takes_bool_and_u8():
    """The plain versions read any nonzero byte as a drop, and take bool
    or u8 alike; ``merge_ref`` takes a shard's columns of it."""
    S, N = 6, 40
    heard, mf, rx_ok, cap = (torch.from_numpy(a) for a in
                             _random_round_inputs(S, N, seed=4))
    p = TParams(n=N, slots=S)
    offs = [1, 7, 33]
    rng = np.random.default_rng(1)
    drop_b = torch.from_numpy(rng.random((3, N)) < 0.5)
    drop_u = drop_b.to(torch.uint8) * torch.from_numpy(
        rng.integers(1, 256, (3, N)).astype(np.uint8))
    a = fused.disseminate_ref(p, 50, offs, heard, mf, rx_ok, cap, drop_b)
    b = fused.disseminate_ref(p, 50, offs, heard, mf, rx_ok, cap, drop_u)
    assert torch.equal(a, b)
    src = torch.stack([torch.roll(mf, o) > 50 for o in offs])
    pins = torch.stack([torch.roll(heard, o, dims=1) for o in offs])
    c = fused.merge_ref(p, heard, pins, src, rx_ok, cap, drop_u)
    d = fused.merge_ref(p, heard, pins, src & ~drop_b, rx_ok, cap)
    assert torch.equal(a, c) and torch.equal(c, d)
