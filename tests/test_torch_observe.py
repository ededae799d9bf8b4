"""The round's observers (``consul_tpu_torch/gossip/observe.py`` and
where the round calls it) against the reference on the CPU, tolerance 0.

- the plain version ``heard_counts_ref`` against the reference's own
  expressions for the three observers (``consul_tpu/gossip/kernel.py``:
  the flight row's ``_tx_bytes``, the hist spread's ``n_hold``, the
  trace's holders), on one matrix and on column shards;
- whole runs: the flight ring, the hist banks and the trace of the port's
  ``run_rounds`` (the plain route) against the reference's jitted
  ``run_rounds`` in churn with joins, with the hot tier on, under
  ``partition_heal``, and sharded at ndev 2 and 8 against the reference's
  ``run_rounds_sharded`` (8-device CPU mesh), every field of every
  carry; the churn run's spread bank must be non-zero, so the rows the
  spread's ``want`` selects are read.

The reference runs its XLA SWAR tail; the port its plain torch tail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip import nemesis as j_nem
from consul_tpu.gossip.params import SwimParams as JParams
from consul_tpu.gossip.params import lan_profile as j_lan
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert, observe
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip.params import SwimParams as TParams
from consul_tpu_torch.gossip.params import lan_profile as t_lan
from consul_tpu_torch.obs.constants import FLIGHT_COLS

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


# -- the plain version against the reference's expressions -------------------

def _reference_counts(heard, member, budget, verdict, want):
    """The three observers as the reference spells them (kernel.py
    ``_tx_bytes`` without its fanout, the spread's ``n_hold``, the trace's
    ``n_heard_dead``/``n_heard_alive``), per row, in the form ``verdict``
    selects (with one, the holders alone; without, the others alone), and
    0 in every count of a row ``want`` leaves out."""
    h, mem = jnp.asarray(heard), jnp.asarray(member)[None, :]
    msg = h >> jk._MSG_SHIFT
    dead = jnp.sum((msg == jk.MSG_DEAD) & mem, axis=1, dtype=jnp.int32)
    alive = jnp.sum((msg == jk.MSG_REFUTE) & mem, axis=1, dtype=jnp.int32)
    live = jnp.sum(((h >> jk._MSG_SHIFT) > 0)
                   & ((h & jk._AGE_MASK) < budget), axis=1, dtype=jnp.int32)
    zero = jnp.zeros_like(dead)
    if verdict is None:
        hold = zero
    else:
        hold = jnp.sum(((h >> jk._MSG_SHIFT).astype(jnp.int32)
                        == jnp.asarray(verdict)[:, None]) & mem, axis=1,
                       dtype=jnp.int32)
        dead = alive = live = zero
    out = np.stack([np.asarray(x) for x in (dead, alive, live, hold)])
    return np.where(want[None, :], out, 0)


@pytest.mark.parametrize("R, N, ndev", [(16, 240, 1), (8, 1001, 1),
                                        (64, 640, 8), (5, 292, 2)])
def test_plain_counts_match_reference_expressions(R, N, ndev):
    rng = np.random.default_rng(R * N)
    heard = rng.integers(0, 256, (R, N)).astype(np.uint8)
    heard[0] = 0
    heard[1] = (jk.MSG_DEAD << jk._MSG_SHIFT) | rng.integers(0, 16, N)
    member = rng.random(N) < 0.7
    verdict = np.where(rng.random(R) < 0.5, jk.MSG_DEAD,
                       jk.MSG_REFUTE).astype(np.int32)
    L = N // ndev
    shards = tuple(torch.from_numpy(heard[:, i * L:(i + 1) * L].copy())
                   for i in range(ndev))
    for budget in (1, 3, 7, 14):
        for want in (np.ones(R, bool), rng.random(R) < 0.4):
            for v in (verdict, None):
                got = observe.count(shards if ndev > 1 else shards[0],
                                    torch.from_numpy(member), budget,
                                    None if v is None
                                    else torch.from_numpy(v),
                                    torch.from_numpy(want))
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(
                    got.numpy(), _reference_counts(heard, member, budget,
                                                   v, want),
                    err_msg=f"budget={budget}, verdict={v is not None}")


# -- whole runs ----------------------------------------------------------------

def _assert_fields_equal(ref, port, ctx):
    assert type(ref).__name__ == type(port).__name__, ctx
    got = convert.state_to_numpy(port)
    for f in ref._fields:
        x = np.asarray(getattr(ref, f))
        assert x.dtype == got[f].dtype and x.shape == got[f].shape, \
            f"{ctx}{f}: {x.dtype}{x.shape} vs {got[f].dtype}{got[f].shape}"
        if not np.array_equal(x, got[f]):
            bad = np.argwhere(x != got[f])[:3] if x.ndim else "scalar"
            raise AssertionError(f"{ctx}{type(ref).__name__}.{f} diverged "
                                 f"at {bad}")


def _schedule(n):
    """Failures and joins spread over the run, some on the 8-shard
    boundaries (L = n / 8)."""
    L = n // 8
    fail = np.full(n, NEVER, np.int32)
    for node, rnd in ((L - 1, 10), (L, 30), (2 * L + 5, 45), (n - 1, 60),
                      (3 * L + 7, 75)):
        fail[node] = rnd
    join = np.full(n, NEVER, np.int32)
    for node, rnd in ((4 * L, 20), (6 * L - 1, 40), (L + 3, 65)):
        join[node] = rnd
    return fail, join


CASES = {  # name -> (n, params, steps, ndev, nemesis scenario)
    "churn_joins": (240, dict(slots=16, probe_every=5), 200, None, None),
    "hot_tier": (240, dict(slots=16, probe_every=5, hot_slots=4,
                           loss_rate=0.02), 200, None, None),
    "partition_heal": (320, "lan", 200, None, "partition_heal"),
    "sharded_2": (640, "lan", 160, 2, None),
    "sharded_8": (640, "lan", 160, 8, None),
}


def _params(n, kw, lib):
    if kw == "lan":
        make = j_lan if lib == "jax" else t_lan
        return make(n, slots=16, loss_rate=0.02, pushpull_every=40)
    return (JParams if lib == "jax" else TParams)(n=n, **kw)


def _reference(name):
    n, kw, steps, ndev, scn = CASES[name]
    p = _params(n, kw, "jax")
    fail, join = _schedule(n)
    extra = dict(trace=True, unroll=UNROLL, flight=jk.init_flight(),
                 hist=jk.init_hist())
    st = jk.init_state(p)
    if scn is not None:
        sc = j_nem.build(scn, n)
        fail = np.minimum(fail, sc.fail_round)
        extra["nem"] = sc.nem
        extra["join_round"] = jnp.asarray(
            join if sc.join_round is None else sc.join_round)
    else:
        st = st._replace(member=jnp.asarray(join == NEVER))
        extra["join_round"] = jnp.asarray(join)
    key, fail = jax.random.PRNGKey(5), jnp.asarray(fail)
    if ndev is None:
        return jk.run_rounds(st, key, fail, p, steps, **extra)
    return jk.run_rounds_sharded(jk.shard_state(st, ndev), key, fail, p,
                                 steps, ndev=ndev, **extra)


def _port(name):
    n, kw, steps, ndev, scn = CASES[name]
    p = _params(n, kw, "torch")
    fail, join = _schedule(n)
    extra = dict(trace=True, flight=tk.init_flight(device="cpu"),
                 hist=tk.init_hist(device="cpu"), device="cpu")
    st = tk.init_state(p, device="cpu")
    if scn is not None:
        sc = t_nem.build(scn, n)
        fail = np.minimum(fail, sc.fail_round)
        extra["nem"] = sc.nem
        extra["join_round"] = join if sc.join_round is None \
            else sc.join_round
    else:
        st = st._replace(member=torch.from_numpy(join == NEVER))
        extra["join_round"] = join
    args = (st, prng.PRNGKey(5), fail, p, steps)
    if ndev is None:
        return tk.run_rounds(*args, **extra)
    return tk.run_rounds_sharded(*args, ndev=ndev, **extra)


@pytest.mark.parametrize("name", sorted(CASES))
def test_observers_match_reference(name):
    """The flight ring, the hist banks and the trace (and the state they
    are read from), every field, bit for bit."""
    (jst, jfl, jhb), jtr = _reference(name)
    (tst, tfl, thb), ttr = _port(name)
    _assert_fields_equal(jfl, tfl, f"{name} ")
    _assert_fields_equal(jhb, thb, f"{name} ")
    _assert_fields_equal(jtr, ttr, f"{name} trace ")
    _assert_fields_equal(jst, tst, f"{name} ")
    # Every observer saw something: rumors pushed (the flight row's
    # dissemination bytes), holders traced, and (churn) verdicts still held at GC.
    assert int(tfl.rows[:, FLIGHT_COLS.index("dissem_bytes")].sum()) > 0
    assert int(ttr.n_heard_dead.sum()) > 0
    assert int(ttr.n_heard_alive.sum()) > 0
    if name == "churn_joins":
        assert int(thb.spread.sum()) > 0, "no slot recycled with a verdict"


def test_wrapper_refuses_a_scratch_it_cannot_use(monkeypatch):
    """A scratch of the wrong type, shape or size, or on another device,
    is refused before the kernel is built or launched."""
    monkeypatch.setattr(observe, "require_cuda", lambda name, t: None)

    def no_build():
        raise AssertionError("built before the scratch was checked")

    monkeypatch.setattr(observe, "_lib", no_build)
    R, N = 6, 64
    heard = torch.zeros((R, N), dtype=torch.uint8, device="meta")
    member = torch.ones(N, dtype=torch.bool, device="meta")
    words = observe.scratch_words(R)
    before = observe.launches
    for bad in (torch.zeros(words - 1, dtype=torch.int32, device="meta"),
                torch.zeros(words, dtype=torch.int64, device="meta"),
                torch.zeros((1, words), dtype=torch.int32, device="meta"),
                torch.zeros(2 * words, dtype=torch.int32,
                            device="meta")[::2],
                torch.zeros(words, dtype=torch.int32)):
        with pytest.raises(ValueError, match="scratch must be"):
            observe.heard_counts(heard, member, 3, scratch=bad)
    assert observe.launches == before
