"""The port's round under the nemesis catalog (consul_tpu_torch/gossip/
nemesis.py) against the reference's (consul_tpu/gossip/nemesis.py and
the nemesis legs of consul_tpu/gossip/kernel.py) on the CPU, tolerance 0:
every field of ``SwimState``, ``HistBank``, ``NemState`` and the
``RoundTrace``.

- single-device: all six scenarios at ``lan_profile(n, slots=16)``, each
  run long enough to cover its fault window and rounds on both sides of
  it (the port draws nothing outside the window);
- sharded: ``degraded_observer`` and ``partition_heal`` at ndev 2 and 8
  against the reference's ``run_rounds_sharded`` (8-device CPU mesh) and
  against the port's own single-device run; the rest of the catalog
  sharded is ``slow``;
- the errors a scenario raises without ``nem_state`` or ``join_round``
  match the reference's.

The reference runs its XLA SWAR tail; the port its plain torch tail."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip import nemesis as j_nem
from consul_tpu.gossip.params import lan_profile as j_lan
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip.params import lan_profile as t_lan

pytestmark = pytest.mark.timeout_s(600)

UNROLL = 1  # as tests/test_torch_kernel.py: the results do not depend on it
SEED = 13

# name -> (n, steps): each run covers its scenario's window and rounds on
# both sides of it (partition_heal [40, 160), flapping [30, 310),
# asym_loss from 20, kills at 30 or 40).
SCENARIOS = {
    "block_kill": (320, 150),
    "zone_kill": (320, 150),
    "partition_heal": (320, 200),
    "asym_loss": (320, 150),
    "flapping": (320, 330),
    "degraded_observer": (160, 150),
}


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """Compile the reference with XLA's optimisations off (the same
    integers, about a third quicker), as tests/test_torch_kernel.py."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


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


def _reference(name, ndev=None):
    """The reference's carry (state, hist[, nem_state]) and trace."""
    n, steps = SCENARIOS[name]
    sc = j_nem.build(name, n)
    p = j_lan(n, slots=16)
    kw = dict(trace=True, unroll=UNROLL, hist=jk.init_hist(), nem=sc.nem)
    if sc.join_round is not None:
        kw["join_round"] = jnp.asarray(sc.join_round)
    if sc.nem.needs_state:
        kw["nem_state"] = jk.init_nem_state(n)
    st = jk.init_state(p)
    key, fail = jax.random.PRNGKey(SEED), jnp.asarray(sc.fail_round)
    if ndev is None:
        return jk.run_rounds(st, key, fail, p, steps, **kw)
    return jk.run_rounds_sharded(jk.shard_state(st, ndev), key, fail, p,
                                 steps, ndev=ndev, **kw)


def _port(name, ndev=None):
    n, steps = SCENARIOS[name]
    sc = t_nem.build(name, n)
    p = t_lan(n, slots=16)
    kw = dict(trace=True, hist=tk.init_hist(device="cpu"), nem=sc.nem,
              device="cpu")
    if sc.join_round is not None:
        kw["join_round"] = sc.join_round
    if sc.nem.needs_state:
        kw["nem_state"] = tk.init_nem_state(n, device="cpu")
    st = tk.init_state(p, device="cpu")
    args = (st, prng.PRNGKey(SEED), sc.fail_round, p, steps)
    if ndev is None:
        return tk.run_rounds(*args, **kw)
    return tk.run_rounds_sharded(*args, ndev=ndev, **kw)


_runs = {}


def _cached(side, name):
    if (side, name) not in _runs:
        _runs[side, name] = (_reference if side == "ref" else _port)(name)
    return _runs[side, name]


def _assert_runs_equal(ref, port, ctx):
    (rc, rtr), (pc, ptr) = ref, port
    assert len(rc) == len(pc), ctx
    for a, b in zip(rc, pc):
        _assert_fields_equal(a, b, ctx)
    _assert_fields_equal(rtr, ptr, f"{ctx}trace ")


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_matches_reference(name):
    ref, port = _cached("ref", name), _cached("port", name)
    _assert_runs_equal(ref, port, f"{name} ")
    st, hist = port[0][0], port[0][1]
    sc = t_nem.build(name, SCENARIOS[name][0])
    # Not vacuous: each scenario shows the fault it injects.
    if sc.killed.any():
        assert int(st.n_detected) > 0, name
    if name == "partition_heal":
        # Both halves declare members of the other dead; after the heal
        # they rejoin (an incarnation bump each).
        assert int(hist.dwell.sum()) > 0 and int(st.n_false_dead) > 0
        assert int((st.incarnation > 0).sum()) > 0
    if name == "flapping":
        # Two down phases detected, two rejoins (incarnation bumps) each.
        hi = sc.nem.flap_hi
        assert int(st.n_detected) >= 2 * hi
        assert int(st.incarnation[:hi].min()) == 2 and bool(st.member.all())
    if sc.nem.needs_state:
        assert int(port[0][2].lhm.max()) > 0, "LHM never rose"


@pytest.mark.parametrize("kind", ["contig", "hash"])
@pytest.mark.parametrize("n", [7, 320, 100_003])
def test_group_matches_reference(kind, n):
    """The round's group bit (the hash in int64) against the reference's
    (uint32 in jnp) and the catalog's numpy."""
    nem = t_nem.NemesisParams(part_kind=kind)
    got = tk._nem_group(nem, n, torch.device("cpu")).numpy()
    want = np.asarray(jk._nem_group(j_nem.NemesisParams(part_kind=kind), n))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(got, t_nem.group_of(nem, n))


@pytest.mark.parametrize("name", ["flapping", "partition_heal"])
def test_schedule_matches_reference(name):
    """``_nem_schedule`` on both sides of the window and across the flap
    square wave's edges."""
    n = 320
    a, b = j_nem.build(name, n), t_nem.build(name, n)
    rng = np.random.default_rng(3)
    fail = np.where(rng.random(n) < 0.1, rng.integers(0, 400, n),
                    int(j_nem.NEVER)).astype(np.int32)
    join = np.where(rng.random(n) < 0.1, rng.integers(0, 400, n),
                    int(j_nem.NEVER)).astype(np.int32)
    for rnd in (0, 29, 30, 89, 90, 91, 159, 160, 169, 170, 309, 310, 400):
        jf, jj = jk._nem_schedule(a.nem, jnp.int32(rnd), jnp.asarray(fail),
                                  jnp.asarray(join))
        tf, tj = tk._nem_schedule(b.nem, rnd, torch.from_numpy(fail),
                                  torch.from_numpy(join))
        assert np.array_equal(np.asarray(jf), tf.numpy()), rnd
        assert np.array_equal(np.asarray(jj), tj.numpy()), rnd


# -- sharded ------------------------------------------------------------------

SHARDED = ["degraded_observer", "partition_heal"]


@pytest.mark.parametrize("ndev", [2, 8])
@pytest.mark.parametrize("name", SHARDED)
def test_sharded_matches_reference_and_single_device(name, ndev):
    port = _port(name, ndev)
    assert len(port[0][0].heard) == ndev
    _assert_runs_equal(_reference(name, ndev), port,
                       f"{name} ndev={ndev} vs reference sharded ")
    single = _cached("port", name)
    _assert_runs_equal(_cached("ref", name), single, f"{name} ")
    for a, b in zip(single[0], port[0]):
        if isinstance(a, tk.SwimState):
            b = tk.unshard_state(b)
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), \
                f"{name} ndev={ndev}: {type(a).__name__}.{f}"


@pytest.mark.slow
@pytest.mark.parametrize("name", ["block_kill", "zone_kill", "asym_loss",
                                  "flapping"])
def test_sharded_rest_of_catalog(name):
    """The rest of the catalog on 8 shards, against the reference's
    sharded run and the port's single-device run."""
    port = _port(name, 8)
    _assert_runs_equal(_reference(name, 8), port, f"{name} ndev=8 ")
    _assert_runs_equal(_cached("ref", name), port, f"{name} ndev=8 vs "
                       "reference single ")


def test_swim_round_threads_nem_state():
    """``swim_round``/``swim_round_hist``/``swim_round_sharded`` with a
    scenario and ``nem_state`` return it, and equal ``run_rounds``."""
    name = "degraded_observer"
    n, _ = SCENARIOS[name]
    sc = t_nem.build(name, n)
    p = t_lan(n, slots=16)
    key = prng.key(SEED)
    (st0, _, ns0), _ = tk.run_rounds(
        tk.init_state(p, device="cpu"), key, sc.fail_round, p, 35,
        hist=tk.init_hist(device="cpu"), nem=sc.nem,
        nem_state=tk.init_nem_state(n, device="cpu"), device="cpu")
    (want, want_ns), _ = tk.run_rounds(st0, key, sc.fail_round, p, 3,
                                       nem=sc.nem, nem_state=ns0,
                                       device="cpu")
    st, ns = st0, ns0
    sh, sh_ns = tk.shard_state(st0, 2, device="cpu"), ns0
    for _ in range(3):
        st, _, ns = tk.swim_round_hist(st, key, sc.fail_round, p,
                                       tk.init_hist(device="cpu"),
                                       device="cpu", nem=sc.nem,
                                       nem_state=ns)
        sh, sh_ns = tk.swim_round_sharded(sh, key, sc.fail_round, p,
                                          device="cpu", nem=sc.nem,
                                          nem_state=sh_ns)
    for a, b in ((want, st), (want, tk.unshard_state(sh)), (want_ns, ns),
                 (want_ns, sh_ns)):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    one = tk.swim_round(st0, key, sc.fail_round, p, device="cpu",
                        nem=sc.nem, nem_state=ns0)
    assert isinstance(one, tuple) and isinstance(one[1], tk.NemState)


# -- errors -------------------------------------------------------------------

def _errors(name, drop):
    """The reference's and the port's error for a run (and a sharded run)
    of ``name`` without ``drop`` ("nem_state" or "join_round")."""
    n = 40
    sides = (
        (j_nem, jk, j_lan(n, slots=4), jax.random.PRNGKey(0), jnp.asarray,
         dict(unroll=UNROLL), {}),
        (t_nem, tk, t_lan(n, slots=4), prng.PRNGKey(0), np.asarray,
         dict(device="cpu"), dict(device="cpu")))
    msgs = []
    for nem_mod, k, p, key, arr, run_kw, dev in sides:
        sc = nem_mod.build(name, n)
        kw = dict(run_kw, nem=sc.nem)
        if sc.join_round is not None and drop != "join_round":
            kw["join_round"] = arr(sc.join_round)
        if sc.nem.needs_state and drop != "nem_state":
            kw["nem_state"] = k.init_nem_state(n, **dev)
        for run, extra in ((k.run_rounds, {}),
                           (k.run_rounds_sharded, dict(ndev=2))):
            with pytest.raises(ValueError) as err:
                run(k.init_state(p, **dev), key, arr(sc.fail_round), p, 2,
                    **kw, **extra)
            msgs.append(str(err.value))
    return msgs


@pytest.mark.parametrize("name, drop", [("degraded_observer", "nem_state"),
                                        ("partition_heal", "join_round"),
                                        ("flapping", "join_round")])
def test_errors_match_reference(name, drop):
    msgs = _errors(name, drop)
    assert len(set(msgs)) == 1, msgs
    assert drop in msgs[0]
