"""The round's belief-matrix passes outside the tail
(``consul_tpu_torch/gossip/finish.py`` and where the round calls it)
against the reference on the CPU, tolerance 0, and the copy-once rule of
the eager entry points.

- the plain versions against the reference's own expressions: the
  finish step's refutation max and timer fire (``consul_tpu/gossip/
  kernel.py:1529``, ``:1548-1565``) from the round's timer mask, and the
  row wipes (``:1629``, ``:734``, ``:478``), on one matrix and on column
  shards;
- whole runs: state, flight ring, hist banks and trace of the port's
  ``run_rounds`` (the plain route, which writes its matrix in place)
  against the reference's jitted ``run_rounds``: churn with joins from a
  state in which a rejoining node still holds a slot (the join tick's
  stale wipe), the hot tier, a pool whose prober block does not divide
  it (no refutation), ``partition_heal`` with the Lifeguard
  registers, and ``run_rounds_sharded`` at ndev 2 and 8; each run must
  fire timers, expire slots and wipe rows at the probe tick's rearm (the
  sharded runs and the hot tier at least the fire and the GC);
- no entry point writes its caller's tensors: ``swim_round``,
  ``swim_round_hist``, ``swim_round_sharded``, ``sharded_round_callable``,
  ``run_rounds`` (eager, and through the round program with its branches
  emulated), ``run_rounds_sharded`` (unsharded and sharded inputs, ndev
  1 and 2), ``run_multidc_rounds``/``multidc_round`` (LAN pools on 1 and
  2 shards) and ``run_event_rounds``/``event_round``: every input tensor
  bit-identical after the call;
- ``profile_round.py --functions`` names only functions the tree has, and
  its occupied time (``device_timeline``) is the union of the device's
  spans.
"""

import sys

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
from consul_tpu_torch.gossip import (convert, events, finish, probe,
                                     program)
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import multidc as tmd
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip.params import SwimParams as TParams
from consul_tpu_torch.gossip.params import lan_profile as t_lan

pytestmark = pytest.mark.timeout_s(600)

NEVER = 2**31 - 1
UNROLL = 1


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """Compile the reference with XLA's optimisations off (the same
    integers, about a third quicker), as tests/test_torch_kernel.py."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


# -- the plain versions against the reference's expressions -------------------

def _timer_inputs(R, N, seed, tmax):
    rng = np.random.default_rng(seed)
    heard = np.where(rng.random((R, N)) < 0.3,
                     rng.integers(0, 256, (R, N)),
                     rng.integers(0, 4, (R, N)) << 6
                     | rng.integers(0, 4, (R, N)) << 4
                     | rng.integers(0, 16, (R, N))).astype(np.uint8)
    rx = rng.random(N) < 0.8
    phase = rng.choice(np.asarray([tk.PHASE_SUSPECT, tk.PHASE_DEAD,
                                   tk.PHASE_REFUTED], np.int32), R)
    phase[0] = tk.PHASE_SUSPECT
    elapsed = rng.integers(0, 2 * tmax, R).astype(np.int32)
    cc = rng.integers(0, 4, R).astype(np.int32)
    col = rng.integers(0, N, R).astype(np.int32)
    refute_now = rng.random(R) < 0.3
    return heard, rx, phase, elapsed, cc, col, refute_now


@pytest.mark.parametrize("R, N, ndev", [(16, 240, 1), (8, 1001, 1),
                                        (12, 640, 8), (5, 292, 2)])
def test_fire_matches_reference_expressions(R, N, ndev):
    """The refutation's max and the fire as the reference spells them
    (its timeout table looked up per byte at ``min(conf, cc)``), against
    the round's 4-bit timer mask and ``finish.fire`` on the matrix or its
    shards."""
    p = JParams(n=N, slots=R)
    heard, rx, phase, elapsed, cc, col, refute_now = _timer_inputs(
        R, N, R * N, max(p.timeout_table()))
    rb = np.where(refute_now, jk._enc(jk.MSG_REFUTE), 0).astype(np.uint8)
    # The reference: refute max, then the fire (kernel.py:1529, 1548-1565).
    h = jnp.asarray(heard).at[jnp.arange(R), jnp.asarray(col)].max(
        jnp.asarray(rb))
    tbl = jnp.asarray(p.timeout_table())
    c_eff = jnp.minimum(((h >> jk._CONF_SHIFT) & jk._CONF_MASK)
                        .astype(jnp.int32), jnp.asarray(cc)[:, None])
    fire = ((jnp.asarray(phase) == jk.PHASE_SUSPECT)[:, None]
            & ((h >> jk._MSG_SHIFT) == jk.MSG_SUSPECT)
            & jnp.asarray(rx)[None, :]
            & (jnp.asarray(elapsed)[:, None] >= tbl[c_eff]))
    want = np.asarray(jnp.where(fire, jnp.uint8(jk._enc(jk.MSG_DEAD)), h))
    want_fired = np.asarray(jnp.any(fire, axis=1))
    # The port: the round's timer mask (kernel.py's _finish_round).
    ttbl = torch.as_tensor(TParams(n=N, slots=R).timeout_table())
    cs = torch.arange(4)
    ok = (torch.from_numpy(elapsed)[:, None]
          >= ttbl[torch.minimum(cs[None, :],
                                torch.from_numpy(cc)[:, None].long())])
    ok = ok & (torch.from_numpy(phase) == tk.PHASE_SUSPECT)[:, None]
    ok_mask = (ok.to(torch.uint8) << cs.to(torch.uint8)).sum(
        dim=1, dtype=torch.uint8)
    L = N // ndev
    shards = tuple(torch.from_numpy(heard[:, i * L:(i + 1) * L].copy())
                   for i in range(ndev))
    fired = finish.fire(shards if ndev > 1 else shards[0],
                        torch.from_numpy(rx), ok_mask,
                        (torch.from_numpy(col), torch.from_numpy(rb)))
    np.testing.assert_array_equal(torch.cat(shards, dim=1).numpy(), want)
    np.testing.assert_array_equal(fired.numpy(), want_fired)
    assert want_fired.any() and refute_now.any()


@pytest.mark.parametrize("ndev", [1, 2, 8])
def test_wipe_matches_reference_expression(ndev):
    rng = np.random.default_rng(ndev)
    R, N = 9, 8 * 146
    heard = rng.integers(1, 256, (R, N)).astype(np.uint8)
    for flags in (np.zeros(R, bool), np.ones(R, bool),
                  np.arange(R) == R - 1, rng.random(R) < 0.5):
        want = np.asarray(jnp.where(jnp.asarray(flags)[:, None],
                                    jnp.uint8(0), jnp.asarray(heard)))
        L = N // ndev
        shards = tuple(torch.from_numpy(heard[:, i * L:(i + 1) * L].copy())
                       for i in range(ndev))
        out = finish.wipe(shards if ndev > 1 else shards[0],
                          torch.from_numpy(flags))
        assert out is (shards if ndev > 1 else shards[0])
        np.testing.assert_array_equal(torch.cat(shards, dim=1).numpy(), want)


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


STALE_NODE, STALE_SLOT = 17, 3


def _schedule(n):
    """Failures and joins spread over the run, some on the 8-shard
    boundaries (L = n / 8); ``STALE_NODE`` rejoins at round 2; node L + 3
    fails 3 rounds after it joins, while its join episode is live (the
    probe tick rearms it)."""
    L = n // 8
    fail = np.full(n, NEVER, np.int32)
    for node, rnd in ((L - 1, 10), (L, 30), (2 * L + 5, 45), (n - 1, 60),
                      (3 * L + 7, 75), (L + 3, 68)):
        fail[node] = rnd
    join = np.full(n, NEVER, np.int32)
    for node, rnd in ((4 * L, 20), (6 * L - 1, 40), (L + 3, 65),
                      (STALE_NODE, 2)):
        join[node] = rnd
    return fail, join


def _start(p, join):
    """The first state, as numpy: the join-pending nodes are no members;
    with ``stale``, ``STALE_NODE`` (pending) still holds a DEAD episode in
    slot ``STALE_SLOT`` whose row the join tick must wipe."""
    S, N = p.slots, p.n
    rng = np.random.default_rng(N)
    st = {f: np.asarray(v) for f, v in
          convert.state_to_numpy(tk.init_state(p, device="cpu")).items()}
    st["member"] = join == NEVER
    st["slot_node"][STALE_SLOT] = STALE_NODE
    st["slot_phase"][STALE_SLOT] = tk.PHASE_DEAD
    st["slot_dead_round"][STALE_SLOT] = 0
    st["slot_of_node"][STALE_NODE] = STALE_SLOT
    st["heard"][STALE_SLOT] = np.where(
        rng.random(N) < 0.6, tk._enc(tk.MSG_DEAD, age=3), 0).astype(np.uint8)
    return st


CASES = {  # name -> (n, params, steps, ndev, nemesis scenario)
    "churn_joins_stale": (240, dict(slots=16, probe_every=5), 200, None,
                          None),
    "hot_tier": (240, dict(slots=16, probe_every=5, hot_slots=4,
                           loss_rate=0.02), 200, None, None),
    # n % probe_every != 0: the prober block's padding lanes share a
    # column, so the marks and seeds go through ``_put_points``' keep
    # mask; no refutation (the fire pass without its byte).
    "unaligned_no_refute": (243, dict(slots=16, probe_every=5,
                                      refute=False), 150, None, None),
    "partition_heal_lhm": (320, "lan", 200, None, "partition_heal"),
    "sharded_2": (640, "lan", 160, 2, None),
    "sharded_8": (640, "lan", 160, 8, None),
}


def _params(n, kw, lib):
    if kw == "lan":
        make = j_lan if lib == "jax" else t_lan
        return make(n, slots=16, loss_rate=0.02, pushpull_every=40)
    return (JParams if lib == "jax" else TParams)(n=n, **kw)


def _run(name, lib):
    n, kw, steps, ndev, scn = CASES[name]
    p = _params(n, kw, lib)
    fail, join = _schedule(n)
    st0 = _start(_params(n, kw, "torch"), join)
    if scn is not None:
        sc = (j_nem if lib == "jax" else t_nem).build(scn, n)
        fail = np.minimum(fail, sc.fail_round)
        if sc.join_round is not None:
            join = sc.join_round
    if lib == "jax":
        st = jk.init_state(p)._replace(**{f: jnp.asarray(v)
                                          for f, v in st0.items()})
        extra = dict(trace=True, unroll=UNROLL, flight=jk.init_flight(),
                     hist=jk.init_hist(), join_round=jnp.asarray(join))
        if scn is not None:
            extra["nem"] = sc.nem
            extra["nem_state"] = jk.init_nem_state(n)
        key, fail = jax.random.PRNGKey(5), jnp.asarray(fail)
        if ndev is None:
            return jk.run_rounds(st, key, fail, p, steps, **extra)
        return jk.run_rounds_sharded(jk.shard_state(st, ndev), key, fail, p,
                                     steps, ndev=ndev, **extra)
    st = convert.state_from_numpy(st0, device="cpu")
    extra = dict(trace=True, flight=tk.init_flight(device="cpu"),
                 hist=tk.init_hist(device="cpu"), device="cpu",
                 join_round=join)
    if scn is not None:
        extra["nem"] = sc.nem
        extra["nem_state"] = tk.init_nem_state(n, device="cpu")
    args = (st, prng.PRNGKey(5), fail, p, steps)
    if ndev is None:
        return tk.run_rounds(*args, **extra)
    return tk.run_rounds_sharded(*args, ndev=ndev, **extra)


def _watched(monkeypatch):
    """Record, by the round function that called it, whether each fire
    pass fired and each wipe wiped a row (the probe tick's, inside
    ``probe.rearm_and_marks``)."""
    seen = {"fired": 0, "_probe_tick": 0, "_join_tick": 0,
            "_finish_round": 0}
    fire, wipe = finish.fire, finish.wipe

    def watched_fire(*a, **kw):
        fired = fire(*a, **kw)
        seen["fired"] += int(fired.any())
        return fired

    def watched_wipe(heard, flags):
        seen[sys._getframe(1).f_code.co_name] += int(flags.any())
        return wipe(heard, flags)

    def watched_rearm(cfg, t, rearm):
        # The probe tick's rearm wipe runs inside its rearm_and_marks step.
        seen["_probe_tick"] += int(rearm.any())
        return rearm_and_marks(cfg, t, rearm)

    rearm_and_marks = probe.rearm_and_marks
    monkeypatch.setattr(finish, "fire", watched_fire)
    monkeypatch.setattr(finish, "wipe", watched_wipe)
    monkeypatch.setattr(probe, "rearm_and_marks", watched_rearm)
    return seen


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_matches_reference(name, monkeypatch):
    """State, flight ring, hist banks and trace (and NemState), every
    field, bit for bit; timers fired, slots expired and rows wiped."""
    ref_carry, ref_tr = _run(name, "jax")
    seen = _watched(monkeypatch)
    port_carry, port_tr = _run(name, "torch")
    assert len(ref_carry) == len(port_carry)
    for a, b in zip(ref_carry, port_carry):
        _assert_fields_equal(a, b, f"{name} ")
    _assert_fields_equal(ref_tr, port_tr, f"{name} trace ")
    assert seen["fired"] > 0 and seen["_finish_round"] > 0, seen
    if name in ("churn_joins_stale", "partition_heal_lhm"):
        assert seen["_probe_tick"] > 0, seen
    if name == "churn_joins_stale":
        assert seen["_join_tick"] > 0, seen
        st = port_carry[0]
        assert int(st.n_detected) > 0 and bool(st.member[STALE_NODE])


# -- the caller's tensors are never written ------------------------------------

def _snapshot(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        return type(tree)(*(_snapshot(x) for x in tree)) if hasattr(
            tree, "_fields") else tuple(_snapshot(x) for x in tree)
    return tree


def _assert_unchanged(before, after, ctx):
    if isinstance(before, torch.Tensor):
        assert torch.equal(before, after), ctx
        return
    if isinstance(before, tuple):
        for i, (a, b) in enumerate(zip(before, after)):
            _assert_unchanged(a, b, f"{ctx}[{i}]")


N_IN, S_IN = 240, 16


@pytest.fixture(scope="module")
def busy_state():
    """A state with live episodes of every phase (failures, a join, a
    rearm pending), reached by the port's own rounds."""
    p = TParams(n=N_IN, slots=S_IN, probe_every=5, loss_rate=0.05,
                pushpull_every=7)
    fail, join = _schedule(N_IN)
    fail[[5, 50, 90, 130]] = [3, 6, 9, 12]
    st = convert.state_from_numpy(_start(p, join), device="cpu")
    (st, hist), _ = tk.run_rounds(st, prng.key(3), fail, p, 18,
                                  join_round=join, device="cpu",
                                  hist=tk.init_hist(device="cpu"))
    assert int((st.slot_node >= 0).sum()) > 0
    return p, st, hist, fail, join


def _entry_calls(p, st, hist, fail, join):
    key = prng.key(9)
    sharded = tk.shard_state(st, 2, device="cpu")
    yield "swim_round", (st,), lambda s: tk.swim_round(
        s, key, fail, p, join, device="cpu")
    yield "swim_round_hist", (st, hist), lambda s, h: tk.swim_round_hist(
        s, key, fail, p, h, join, device="cpu")
    for label, s0, ndev in (("swim_round_sharded", st, 2),
                            ("swim_round_sharded/sharded", sharded, None)):
        yield label, (s0,), lambda s, ndev=ndev: tk.swim_round_sharded(
            s, key, fail, p, join, ndev=ndev, device="cpu")
    rnd = tk.sharded_round_callable(p, 2, has_join=True, device="cpu")
    yield "sharded_round_callable", (sharded,), lambda s: rnd(
        s, key, fail, join)
    yield "run_rounds", (st, hist), lambda s, h: tk.run_rounds(
        s, key, fail, p, 12, trace=True, join_round=join, hist=h,
        device="cpu")
    for label, s0, ndev in (("run_rounds_sharded/1", st, 1),
                            ("run_rounds_sharded/2", st, 2),
                            ("run_rounds_sharded/sharded", sharded, None)):
        yield label, (s0, hist), lambda s, h, ndev=ndev: \
            tk.run_rounds_sharded(s, key, fail, p, 12, join_round=join,
                                  hist=h, ndev=ndev, device="cpu")


def test_entry_points_leave_their_inputs(busy_state):
    p, st, hist, fail, join = busy_state
    for label, inputs, call in _entry_calls(p, st, hist, fail, join):
        before = _snapshot(inputs)
        call(*inputs)
        _assert_unchanged(before, inputs, label)


class _Emulate:
    """Conditional-node semantics on the CPU (as
    tests/test_torch_round_program.py): a body runs where its predicate
    holds and writes the program's buffers; the rounds are counted by
    branch on the host, as a replay's are on the device."""

    def when(self, pred, fn, operand):
        if bool(pred):
            tk.join_rounds += 1
            program._copy_leaves(operand, fn(operand))
        return operand

    def switch(self, choice, branches, names, dst):
        which, n_active = tk.choice_ref(choice)
        i = int(which)
        tk.tail_rounds[names[i]] += 1
        program._copy_leaves(dst, branches[i]())
        return dst, n_active


class _EmulatedGraph:
    def __init__(self, prog, v):
        self.prog, self.v = prog, v

    def launch(self):
        tk._recorder = _Emulate()
        try:
            self.prog._round(self.v, dst=self.prog.dst)
        finally:
            tk._recorder = None


@pytest.mark.parametrize("ndev", [None, 2])
def test_program_route_leaves_its_inputs(busy_state, monkeypatch, ndev):
    """The round program's route (its branches emulated) copies the state
    into its buffers and writes those: the caller's tensors stay as they
    were, the result equals the eager route's, and the belief matrix is
    copied once a call and once a full-tail round, never in a quiescent
    or hot round."""
    monkeypatch.setattr(program.RoundProgram, "_capture",
                        lambda self, v: _EmulatedGraph(self, v))
    monkeypatch.setattr(program, "_programs", type(program._programs)())
    p, st, hist, fail, join = busy_state
    key = prng.key(4)
    if ndev is not None:
        st = tk.shard_state(st, ndev, device="cpu")
    sc = None if ndev is None else tk._ShardCtx(ndev, p.n // ndev)
    before = _snapshot((st, hist))
    tails0 = dict(tk.tail_rounds)
    copied0 = program.copy_bytes
    out = program.run_rounds(st, key, tk._as_i32(fail, "cpu"), p, 30, False,
                             tk._as_i32(join, "cpu"), None, hist, sc, None,
                             None)
    _assert_unchanged(before, (st, hist), "program")
    program.settle_counts()
    full = tk.tail_rounds["full"] - tails0["full"]
    quiet = tk.tail_rounds["quiescent"] - tails0["quiescent"]
    assert program.copy_bytes - copied0 == p.slots * p.n * (1 + full)
    assert full > 0 and quiet >= 0
    runner = tk.run_rounds if ndev is None else tk.run_rounds_sharded
    kw = {} if ndev is None else {"ndev": ndev}
    eager = runner(st, key, fail, p, 30, join_round=join, hist=hist,
                   device="cpu", graphed=False, **kw)
    for a, b in zip(out[0], eager[0]):
        _assert_unchanged(a, b, "program vs eager")


def test_quiescent_program_round_copies_no_matrix(monkeypatch):
    """A healthy pool's rounds through the program: the matrix is copied
    in once a call and never in a round, and each round makes the probe
    tick's rearm wipe and marks step alone (no other wipe)."""
    monkeypatch.setattr(program.RoundProgram, "_capture",
                        lambda self, v: _EmulatedGraph(self, v))
    monkeypatch.setattr(program, "_programs", type(program._programs)())
    p = TParams(n=N_IN, slots=S_IN, probe_every=5)
    st = tk.init_state(p, device="cpu")
    fail = tk._as_i32(np.full(N_IN, NEVER, np.int32), "cpu")
    copied0, tails0 = program.copy_bytes, dict(tk.tail_rounds)
    calls = []
    wipe, rearm_and_marks = finish.wipe, probe.rearm_and_marks

    def counted(heard, flags):
        calls.append(sys._getframe(1).f_code.co_name)
        return wipe(heard, flags)

    def counted_rearm(cfg, t, rearm):
        calls.append("rearm_and_marks")
        return rearm_and_marks(cfg, t, rearm)

    monkeypatch.setattr(finish, "wipe", counted)
    monkeypatch.setattr(probe, "rearm_and_marks", counted_rearm)
    for _ in range(2):
        st = program.run_rounds(st, prng.key(1), fail, p, 10, False, None,
                                None, None, None, None, None)[0]
    program.settle_counts()
    assert tk.tail_rounds["quiescent"] - tails0["quiescent"] == 20
    assert program.copy_bytes - copied0 == 2 * p.slots * p.n
    assert calls == ["rearm_and_marks"] * 20


def test_multidc_and_events_leave_their_inputs():
    for lan_devices in (1, 2):
        p = tmd.make_params(2, 120, n_servers=3, event_slots=4, slots=8,
                            lan_devices=lan_devices)
        lan_fail = np.full((2, 120), NEVER, np.int32)
        lan_fail[:, 10:14] = 2
        wan_fail = np.full((6,), NEVER, np.int32)
        st = tmd.fire_in_dc(tmd.init_multidc(p, device="cpu"), 0, 7, p)
        st, _ = tmd.run_multidc_rounds(st, prng.key(2), lan_fail, wan_fail,
                                       p, 12, device="cpu")
        assert int(sum((s.slot_node >= 0).sum() for s in st.lan)) > 0
        before = _snapshot(st)
        tmd.run_multidc_rounds(st, prng.key(3), lan_fail, wan_fail, p, 8,
                               device="cpu")
        tmd.multidc_round(st, prng.key(4), lan_fail, wan_fail, p,
                          device="cpu")
        _assert_unchanged(before, st, f"multidc/{lan_devices}")
    p = TParams(n=N_IN, slots=S_IN)
    ev = events.fire_events(events.init_events(p, slots=4, device="cpu"),
                            [3, 7, 11])
    alive = torch.ones(N_IN, dtype=torch.bool)
    ev, _ = events.run_event_rounds(ev, prng.key(5), alive, p, 4)
    before = _snapshot(ev)
    events.run_event_rounds(ev, prng.key(6), alive, p, 6)
    events.event_round(ev, prng.key(7), alive, p)
    _assert_unchanged(before, ev, "events")


def test_profile_round_names_only_functions_the_tree_has():
    """``profile_round.py --functions`` attributes by the names of
    ``ROUND_FUNCTIONS`` and of ``--round-fn FN=NAME``: each must be a
    function of this tree, and a name the tree lacks is refused."""
    from consul_tpu_torch import profile_round as pr
    present = pr._kernel_functions() | {"_copy_leaves"}
    assert set(pr.ROUND_FUNCTIONS) <= present
    got = pr._named_functions(pr.ROUND_FUNCTIONS, ["_age_tick=age"],
                              "--round-fn", present)
    assert got["_age_tick"] == "age"
    with pytest.raises(SystemExit, match="_fire"):
        pr._named_functions(pr.ROUND_FUNCTIONS, ["_fire=fire"],
                            "--round-fn", present)
    with pytest.raises(SystemExit, match="FN=NAME"):
        pr._named_functions(pr.ROUND_FUNCTIONS, ["_fire"], "--round-fn",
                            present)


def test_profile_round_busy_is_the_union_of_device_spans():
    """A kernel launched programmatically behind another (decide behind
    the tail) overlaps it: the device's busy time counts the overlap once,
    each kernel keeps what no earlier one covers, and the observers'
    ranges and host events are not device work."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from consul_tpu_torch import profile_round as pr

    def ev(name, start, end, dev=DeviceType.CUDA):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=start, end=end))

    prof = NS(events=lambda: [
        ev("tail", 0.0, 100.0), ev("decide", 70.0, 102.0),
        ev("fire", 105.0, 107.0), ev("fire", 106.0, 108.0),
        ev(pr._LABEL + "spread", 0.0, 200.0), ev("phase", 0.0, 300.0),
        ev("aten::add", 0.0, 500.0, DeviceType.CPU)])
    busy, exclusive, duration = pr.device_timeline(prof, ("phase",))
    assert busy == 105.0
    assert exclusive == {"tail": 100.0, "decide": 2.0, "fire": 3.0}
    assert duration == {"tail": 100.0, "decide": 32.0, "fire": 4.0}
    rows = {"finish_round": {"decide": (32.0, 1)},
            "tail": {"tail": (100.0, 1)}}
    out = pr._by_function(rows, 1, (busy, exclusive, duration))
    assert out["finish_round"]["device_ms_per_round"] == 0.032
    assert out["finish_round"]["exclusive_ms_per_round"] == 0.002
    assert out["tail"]["exclusive_ms_per_round"] == 0.1
