"""The finish step's slot logic (``consul_tpu_torch/gossip/finish_slots.py``,
and ``_finish_round`` of ``gossip/kernel.py`` which runs its steps around
the matrix passes) against the reference on the CPU, tolerance 0.

- the step alone: the reference's ``_finish_round`` (under JAX, jitted) and
  the port's, from one numpy-seeded state and the same round, every output
  bit for bit (every ``SwimState`` field, the hist banks, NemState): the
  full ``idx`` and the hot tier's (its live rows padded with free slots),
  on 1, 2 and 8 column shards (the reference's step on the unsharded
  matrix: its sharded step equals it by construction, and whole sharded
  runs are held in tests/test_torch_finish.py and
  tests/test_torch_sharded.py), the hist banks, NemState and the
  refutation each on and off; states in which rows refute, fire, detect,
  declare false dead and expire, one in which every row fires, one in
  which every row expires, and one whose detections share a bucket (and
  clip into the top one) with the counters and banks near 2**31 (they
  wrap);
- Lifeguard's LHM: the port clamps only the refuters' bumped entries
  (the module docstring of ``finish_slots.py``); over whole runs under
  ``degraded_observer`` every state that reaches the step has LHM inside
  ``[0, lhm_max]``, where that is the reference's clamp of the whole
  vector, and refuters were bumped.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip import nemesis as j_nem
from consul_tpu.gossip.params import SwimParams as JParams
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert, finish_slots
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip.params import SwimParams as TParams

pytestmark = pytest.mark.timeout_s(600)

NEVER = 2**31 - 1
RND = 1000      # the round of the step-alone cases
LHM_MAX = 3
SUSPECT, DEAD, REFUTED, JOIN = (tk.PHASE_SUSPECT, tk.PHASE_DEAD,
                                tk.PHASE_REFUTED, tk.PHASE_JOIN)

# name -> (n, slots, hot rows or None (the full idx), shards, hist banks,
# LHM threaded, refutation, kind of state)
CASES = {
    "full_mixed": (240, 16, None, 1, True, True, True, "mixed"),
    "full_bare": (240, 16, None, 1, False, False, True, "mixed"),
    "no_refute": (243, 16, None, 1, True, False, False, "mixed"),
    "hot_padding": (240, 16, 10, 1, True, True, True, "mixed"),
    "sharded_2": (640, 16, None, 2, True, True, True, "mixed"),
    "sharded_8_hot": (640, 16, 10, 8, True, False, True, "mixed"),
    "sharded_8_bare": (640, 16, None, 8, False, True, True, "mixed"),
    "all_fire": (240, 16, None, 1, True, False, False, "all_fire"),
    "all_expire": (640, 16, None, 2, True, True, True, "all_expire"),
    "collide_wrap": (240, 32, None, 1, True, True, True, "collide_wrap"),
}


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """Compile the reference with XLA's optimisations off (the same
    integers, quicker), as tests/test_torch_finish.py."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _params(name, lib):
    n, S, _, _, _, _, refute, _ = CASES[name]
    return (JParams if lib == "jax" else TParams)(n=n, slots=S,
                                                  refute=refute)


def case_state(name: str, seed: int, spec: tuple | None = None) -> dict:
    """A numpy state for the step at round ``RND``: the live slots'
    subjects distinct, every phase, starts on both sides of the timers and
    the TTL and at their edges, dead rounds on both sides of the GC window
    and at its edge; the first live
    rows forced to refute (a live member that holds its own suspicion),
    to fire on a failed subject (a detection) and on a live one that
    cannot refute (a false dead), and to expire DEAD and REFUTED; every
    byte value in the matrix, SUSPECT bytes in every live row.  The hot
    cases leave some slots free and list them after the live ones
    (padding rows); ``idx`` is None on the full path.  ``spec``: the
    case's ``CASES`` entry (by default ``CASES[name]``)."""
    n, S, hot, _, _, lhm, _, kind = spec or CASES[name]
    p = TParams(n=n, slots=S)
    rng = np.random.default_rng(seed)
    ttl, gc = p.slot_ttl_rounds, 2 * p.spread_budget_rounds + 8
    top = int(p.timeout_table()[0])
    live = S if hot is None else hot - 3
    if kind == "all_expire":
        live = S
    subjects = rng.permutation(n)[:live].astype(np.int32)
    slots = np.sort(rng.permutation(S)[:live])
    slot_node = np.full(S, -1, np.int32)
    slot_node[slots] = subjects
    phase = np.zeros(S, np.int32)
    phase[slots] = rng.choice([SUSPECT, SUSPECT, DEAD, REFUTED, JOIN], live)
    # Half the starts and dead rounds on the edges of the timers, the
    # TTL and the GC window.
    edges = [ttl, ttl + 1] + [e for v in p.timeout_table()
                              for e in (int(v), int(v) - 1)]
    start = np.zeros(S, np.int32)
    start[slots] = RND - np.where(rng.random(live) < 0.5,
                                  rng.choice(edges, live),
                                  rng.integers(0, top + 120, live))
    dead = np.full(S, -1, np.int32)
    late = slots[(phase[slots] != SUSPECT) | (rng.random(live) < 0.2)]
    dead[late] = RND - np.where(rng.random(late.size) < 0.5,
                                rng.choice([gc, gc + 1], late.size),
                                rng.integers(0, 3 * gc, late.size))
    nsusp = rng.integers(0, 5, S).astype(np.int32)
    fail = rng.choice(np.asarray([NEVER, RND - 40, RND, RND + 3], np.int32),
                      n, p=[0.6, 0.2, 0.1, 0.1])
    member = rng.random(n) < 0.92
    heard = rng.integers(0, 256, (S, n)).astype(np.uint8)
    suspect = (rng.integers(0, 4, (S, n)) << 4 | rng.integers(0, 16, (S, n))
               | 1 << 6).astype(np.uint8)
    heard = np.where(rng.random((S, n)) < 0.3, suspect, heard)

    def own(s, msg):
        heard[s, slot_node[s]] = (msg << 6) | (heard[s, slot_node[s]] & 0x3F)

    if kind == "mixed":
        # Forced rows: a refuter, a detection, a false dead, two verdicts
        # whose window has passed.
        a, b, c, d, e = slots[:5]
        for s in (a, b, c):
            phase[s], start[s], dead[s] = SUSPECT, RND - top - 5, -1
        fail[slot_node[a]], member[slot_node[a]] = NEVER, True
        own(a, tk.MSG_DEAD)
        fail[slot_node[b]] = RND - 40
        fail[slot_node[c]], member[slot_node[c]] = NEVER, True
        own(c, 0)
        phase[d], dead[d] = DEAD, RND - gc - 3
        phase[e], dead[e] = REFUTED, RND - gc - 1
    elif kind == "all_fire":
        phase[slots], start[slots], dead[slots] = SUSPECT, RND - top - 1, -1
    elif kind == "all_expire":
        # Failed subjects: no row refutes, every DEAD one is dropped.
        phase[slots] = rng.choice([DEAD, REFUTED, JOIN], live)
        dead[slots] = RND - gc - 1 - rng.integers(0, 50, live)
        fail[subjects] = RND - 40
    elif kind == "collide_wrap":
        # Every failed subject failed in one round, long ago (the top
        # bucket), or all at RND - 7 (one bucket).
        phase[slots], start[slots], dead[slots] = SUSPECT, RND - top - 2, -1
        far = rng.random(live) < 0.5
        fail[subjects] = np.where(far, RND - 400, RND - 7)
        fail[subjects[: live // 4]] = NEVER  # false dead or refuters
        own(slots[0], tk.MSG_SUSPECT)
        member[subjects[0]] = True
        nsusp[:] = 1
    inc = rng.integers(0, 9, n).astype(np.int32)
    inc[subjects[0]] = NEVER  # a refuter's bump wraps
    edge = kind == "collide_wrap"
    st = dict(
        round=np.int32(RND), heard=heard, slot_node=slot_node,
        slot_phase=phase, slot_inc=rng.integers(0, 9, S).astype(np.int32),
        slot_start=start, slot_nsusp=nsusp, slot_dead_round=dead,
        slot_of_node=np.full(n, -1, np.int32), incarnation=inc,
        member=member, drops=np.int32(5),
        n_detected=np.int32(2**31 - 2 if edge else 17),
        sum_detect_rounds=np.int32(2**31 - 50 if edge else 400),
        n_false_dead=np.int32(2**31 - 1 if edge else 2),
        n_refuted=np.int32(2**31 - 1 if edge else 9))
    st["slot_of_node"][subjects] = slots
    hist = {f: rng.integers(0, 5, b).astype(np.int32) for f, b in (
        ("detect", 256), ("dwell", 256), ("refute", 256), ("spread", 32))}
    if edge:
        for f in hist:
            hist[f][:] = 2**31 - 1 - rng.integers(0, 3, hist[f].size)
    ns = None
    if lhm:
        ns = (rng.integers(0, LHM_MAX + 1, n).astype(np.int32),
              rng.integers(0, LHM_MAX + 2, n).astype(np.int32))
        ns[0][subjects[0]] = LHM_MAX  # a refuter at the ceiling
    idx = None
    if hot is not None:
        act = (slot_node >= 0).astype(np.int32)
        idx = np.argsort(-act, kind="stable")[:hot].astype(np.int32)
    return dict(st=st, fail=fail, hist=hist, ns=ns, idx=idx)


def _derived(p, st, fail, idx):
    """The round's inputs the step takes beside the state."""
    S = p.slots
    alive = fail > RND
    rx_ok = alive & st["member"]
    conf_cap = np.clip(st["slot_nsusp"] - 1, 0, p.max_confirmations)
    if idx is None:
        idx = np.arange(S, dtype=np.int32)
    return alive, rx_ok, conf_cap.astype(np.int32), idx


def _reference(name: str, c: dict) -> dict:
    p = _params(name, "jax")
    _, _, hot, _, has_hist, lhm, _, _ = CASES[name]
    st = jk.SwimState(**{f: jnp.asarray(v) for f, v in c["st"].items()})
    alive, rx_ok, cc, idx = _derived(p, c["st"], c["fail"], c["idx"])
    heard = st.heard
    full, sub = (None, heard) if hot is None else (heard, heard[idx])
    nem = ns = None
    if lhm:
        nem = j_nem.NemesisParams(scenario="probe", start=0, stop=10_000,
                                  lhm_max=LHM_MAX)
        ns = jk.NemState(*(jnp.asarray(x) for x in c["ns"]))
    hist = (jk.HistBank(**{f: jnp.asarray(v) for f, v in c["hist"].items()})
            if has_hist else None)
    fn = jax.jit(functools.partial(jk._finish_round, p, nem=nem))
    out = fn(st, jnp.int32(RND), jnp.asarray(c["fail"]), jnp.asarray(alive),
             st.member, sub, full, jnp.asarray(idx), st.slot_node,
             st.slot_phase, st.slot_inc, st.slot_start, st.slot_nsusp,
             st.slot_dead_round, st.slot_of_node, st.incarnation, st.drops,
             jnp.asarray(cc), jnp.asarray(rx_ok), hist=hist, nem_state=ns)
    out = (out,) if isinstance(out, jk.SwimState) else out
    res = {f"state.{f}": np.asarray(x) for f, x in zip(jk.SwimState._fields,
                                                       out[0])}
    rest = list(out[1:])
    if has_hist:
        res.update({f"hist.{f}": np.asarray(x)
                    for f, x in zip(jk.HistBank._fields, rest.pop(0))})
    if lhm:
        res.update({f"nem.{f}": np.asarray(x)
                    for f, x in zip(jk.NemState._fields, rest.pop(0))})
    return res


def _port(name: str, c: dict, check_in_place: bool = True) -> dict:
    """The port's step on the CPU (the plain versions) from copies of the
    numpy state; the registers, counters, NemState and banks must be
    written in place."""
    p = _params(name, "torch")
    _, _, hot, ndev, has_hist, lhm, _, _ = CASES[name]
    st = tk.SwimState(**{f: torch.from_numpy(np.array(v))
                         for f, v in c["st"].items()})
    alive, rx_ok, cc, idx = _derived(p, c["st"], c["fail"], c["idx"])
    L = p.n // ndev
    heard = st.heard
    sc = None
    if ndev > 1:
        heard = tuple(heard[:, i * L:(i + 1) * L].clone()
                      for i in range(ndev))
        sc = tk._ShardCtx(ndev, L)
    idx_t = torch.from_numpy(idx)
    if hot is None:
        full, sub = None, heard
    else:
        il = idx_t.long()
        full = heard
        sub = tuple(h[il] for h in heard) if sc else heard[il]
    nem = ns = None
    if lhm:
        nem = t_nem.NemesisParams(scenario="probe", start=0, stop=10_000,
                                  lhm_max=LHM_MAX)
        ns = tk.NemState(*(torch.from_numpy(x.copy()) for x in c["ns"]))
    hist = (tk.HistBank(**{f: torch.from_numpy(v.copy())
                           for f, v in c["hist"].items()})
            if has_hist else None)
    out, hb, ns_out = tk._finish_round(
        p, st, torch.tensor(RND, dtype=torch.int32),
        torch.from_numpy(c["fail"]), torch.from_numpy(alive), st.member,
        sub, full, idx_t, st.slot_node, st.slot_phase, st.slot_inc,
        st.slot_start, st.slot_nsusp, st.slot_dead_round, st.slot_of_node,
        st.incarnation, st.drops, torch.from_numpy(cc),
        torch.from_numpy(rx_ok), sc, hist, nem, ns)
    if check_in_place:
        for f in tk._IN_PLACE:
            assert getattr(out, f) is getattr(st, f), f"{f} not in place"
        assert hb is hist and ns_out is ns
        if ns is not None:
            assert ns_out.lhm is ns.lhm
        if hist is not None:
            assert all(a is b for a, b in zip(hb, hist))
    res = {f"state.{f}": v for f, v in convert.state_to_numpy(out).items()}
    if has_hist:
        res.update({f"hist.{f}": x.numpy() for f, x in zip(hb._fields, hb)})
    if lhm:
        res.update({f"nem.{f}": x.numpy()
                    for f, x in zip(ns_out._fields, ns_out)})
    return res


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_matches_reference(name):
    c = case_state(name, 11 + len(name))
    want = _reference(name, c)
    got = _port(name, c)
    assert sorted(want) == sorted(got)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{name} {f}")
    # The state did what the case is for.
    st0 = c["st"]
    expired = (st0["slot_node"] >= 0) & (want["state.slot_node"] < 0)
    fired = (want["state.slot_phase"] == DEAD) & (st0["slot_phase"]
                                                  == SUSPECT)
    n_new = ((want["state.n_detected"].astype(np.int64)
              - st0["n_detected"]) % 2**32
             + (want["state.n_false_dead"].astype(np.int64)
                - st0["n_false_dead"]) % 2**32)
    refuted = (want["state.n_refuted"].astype(np.int64)
               - st0["n_refuted"]) % 2**32
    kind, refute = CASES[name][7], CASES[name][6]
    if kind == "all_fire":
        assert fired[st0["slot_node"] >= 0].all() and n_new == 16, name
    elif kind == "all_expire":
        assert expired[st0["slot_node"] >= 0].all(), name
    else:
        assert fired.any() and n_new > 0 and (
            kind == "collide_wrap" or expired.any()), name
    if refute and kind != "all_expire":
        assert refuted > 0, name
    if kind == "collide_wrap":
        # Wrapped past 2**31, and detections shared their bucket.
        assert want["state.n_detected"] < 0 and want["state.n_refuted"] < 0
        assert (want["hist.detect"] < 0).any()


def test_kernels_refuse_the_cpu():
    """A kernel wrapper given CPU tensors refuses them (the dispatchers
    take the plain versions there)."""
    name = "full_bare"
    c = case_state(name, 3)
    p = _params(name, "torch")
    alive, _, cc, idx = _derived(p, c["st"], c["fail"], c["idx"])
    st = {f: torch.from_numpy(np.array(v)) for f, v in c["st"].items()}
    t = finish_slots.Step(
        st["heard"], torch.tensor(RND, dtype=torch.int32),
        torch.from_numpy(idx), (st["slot_node"], st["slot_phase"],
                                st["slot_start"], st["slot_dead_round"]),
        torch.from_numpy(cc), torch.from_numpy(alive), st["member"],
        torch.from_numpy(c["fail"]), st["slot_of_node"], st["incarnation"],
        (st["n_detected"], st["sum_detect_rounds"], st["n_false_dead"],
         st["n_refuted"]), None, None)
    cfg = finish_slots.config(p)
    n0 = finish_slots.launches
    with pytest.raises(ValueError, match="CUDA"):
        finish_slots.finish_decide(cfg, t)
    assert finish_slots.launches == n0
    dec = finish_slots.decide(cfg, t)
    assert dec.ok_mask.dtype == torch.uint8 and finish_slots.launches == n0


def test_lhm_inside_its_ceiling_over_whole_runs(monkeypatch):
    """Every state that reaches the step under ``degraded_observer`` has
    LHM in [0, lhm_max] (so clamping the bumped entries is the reference's
    whole-vector clamp), and refuters were bumped."""
    n = 240
    sc = t_nem.build("degraded_observer", n)
    p = TParams(n=n, slots=12, probe_every=5, loss_rate=0.02)
    seen = {"steps": 0, "bumps": 0}
    decide = finish_slots.decide

    def watched(cfg, t):
        assert t.lhm is not None
        lhm0 = t.lhm.clone()
        assert int(lhm0.min()) >= 0 and int(lhm0.max()) <= cfg.lhm_max
        inc0 = t.incarnation.clone()
        dec = decide(cfg, t)
        bumped = t.incarnation != inc0
        seen["steps"] += 1
        seen["bumps"] += int(bumped.sum())
        assert int(t.lhm.max()) <= cfg.lhm_max
        return dec

    monkeypatch.setattr(finish_slots, "decide", watched)
    fail = np.minimum(np.full(n, NEVER, np.int32), sc.fail_round)
    join = (np.full(n, NEVER, np.int32) if sc.join_round is None
            else sc.join_round)
    (_, ns), _ = tk.run_rounds(tk.init_state(p, device="cpu"),
                                prng.PRNGKey(7), fail, p, 160,
                                join_round=join, device="cpu", nem=sc.nem,
                                nem_state=tk.init_nem_state(n, device="cpu"))
    assert seen["steps"] > 0 and seen["bumps"] > 0, seen
    assert int(ns.lhm.max()) <= sc.nem.lhm_max
