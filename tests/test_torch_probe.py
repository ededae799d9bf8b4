"""The round's probe tick (``consul_tpu_torch/gossip/probe.py``, and
``_probe_tick`` of ``gossip/kernel.py`` which runs its steps) against the
reference on the CPU, tolerance 0.

- the tick alone: the reference's ``_probe_tick`` (under JAX, jitted)
  and the port's, from one numpy-seeded state and the same round row,
  every output bit for bit (the matrix, the slot registers,
  ``slot_of_node``, ``drops``, ``probe_stats``, NemState) at an aligned
  and an unaligned N (padding lanes), K = 0 and 3, the partition legs by
  hash and by halves at 0 < p < 1 and at p = 1, degraded observers,
  Lifeguard's registers threaded, the WAN pool's one-lane block, a slot
  table with more needy targets than free slots, and on 2 and 8 column
  shards (the reference's tick on the unsharded matrix: its sharded tick
  equals it by construction, and whole sharded runs are held below and
  in tests/test_torch_sharded.py); each state is built so that rearms,
  allocations, drops and marks happen, and the scratch is left as found;
- whole runs: the port's ``run_rounds`` / ``run_rounds_sharded`` against
  the reference's, every field of the carry and the trace, with a
  watcher on the tick's steps that shows rearms, drops and LHM
  suppression (a prober whose miss would have initiated without its LHM)
  really occurred.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip import nemesis as j_nem
from consul_tpu.gossip.params import SwimParams as JParams
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip import probe, round_args
from consul_tpu_torch.gossip.params import SwimParams as TParams
from tests.test_torch_finish import (_assert_fields_equal, _schedule,
                                     _start)

pytestmark = pytest.mark.timeout_s(600)

NEVER = 2**31 - 1
RND = 52  # the round of the tick-alone cases
_PART_HASH = dict(part_kind="hash", p_ab=0.6, p_ba=0.0)
_PART_HALVES = dict(part_kind="contig", p_ab=0.3, p_ba=0.45)

# name -> (n, slots, probe_every, indirect_k, loss_rate, nemesis fields
# or None, LHM threaded, shards, free slots)
CASES = {
    "aligned_k3": (240, 16, 5, 3, 0.1, None, False, 1, 5),
    "aligned_k0": (240, 16, 5, 0, 0.1, None, False, 1, 5),
    "unaligned": (243, 16, 5, 3, 0.05, None, False, 1, 6),
    "hash": (240, 16, 5, 3, 0.05, _PART_HASH, False, 1, 5),
    "hash_p1": (240, 16, 5, 3, 0.0, dict(part_kind="hash", p_ab=1.0,
                                         p_ba=1.0), False, 1, 5),
    "halves": (240, 16, 5, 3, 0.05, _PART_HALVES, False, 1, 5),
    "halves_p1": (243, 16, 5, 3, 0.0, dict(part_kind="contig", p_ab=1.0,
                                           p_ba=0.0), False, 1, 5),
    "degraded": (240, 16, 5, 3, 0.05, dict(obs_lo=0, obs_hi=240,
                                           p_obs_miss=0.3), False, 1, 5),
    "degraded_lhm": (240, 16, 5, 3, 0.05, dict(
        obs_lo=30, obs_hi=200, p_obs_miss=0.4, lhm_max=3), True, 1, 5),
    "all_legs_lhm": (243, 16, 5, 3, 0.1, dict(
        _PART_HASH, obs_lo=0, obs_hi=243, p_obs_miss=0.3, lhm_max=2),
        True, 1, 5),
    "wan_one_lane": (9, 8, 10, 3, 0.2, None, False, 1, 4),
    "drops": (240, 6, 5, 3, 0.1, None, False, 1, 2),
    "sharded_2": (640, 16, 5, 3, 0.05, dict(
        _PART_HASH, obs_lo=0, obs_hi=640, p_obs_miss=0.3, lhm_max=3), True,
        2, 5),
    "sharded_8": (640, 16, 5, 3, 0.05, dict(
        _PART_HALVES, obs_lo=100, obs_hi=600, p_obs_miss=0.5, lhm_max=3),
        True, 8, 5),
}


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """Compile the reference with XLA's optimisations off (the same
    integers, quicker), as tests/test_torch_finish.py."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _nem(fields, lib):
    if fields is None:
        return None
    return (j_nem if lib == "jax" else t_nem).NemesisParams(
        scenario="probe", start=0, stop=10_000, **fields)


def _row(p, seed):
    """The round ``RND``'s row under ``prng.key(seed)``, and its prober
    block and target offset as host ints."""
    tbl = round_args.build(p, prng.key(seed), RND, 1)
    ra = round_args.row_args(round_args.layout(p.fanout, p.indirect_k),
                             torch.from_numpy(tbl[0]))
    return ra, int(ra.blk), int(ra.probe[0])


def case_state(p, blk: int, o_t: int, seed: int, free: int,
               lhm_max: int = 0):
    """A numpy state for the tick: mf with non-members, dead and live
    nodes; ``S - free`` live slots whose subjects are mostly this round's
    targets, half of them REFUTED or JOIN (rearms); the other targets
    dead members with live probers (initiators, needy where they hold no
    slot: more than the free slots); every byte value in the matrix;
    ``drops`` near the int32 edge; NemState's registers around the LHM
    ceiling (half the initiators past it)."""
    rng = np.random.default_rng(seed)
    N, S = p.n, p.slots
    B = max(1, -(-N // p.probe_every))
    mf = rng.choice(np.asarray([-1, 10, RND, RND + 1, NEVER], np.int32), N,
                    p=[0.1, 0.15, 0.1, 0.15, 0.5])
    pids = [blk + i for i in rng.permutation(B) if blk + i < N]
    targets = [(q + o_t) % N for q in pids]
    half = max(1, len(pids) // 2)
    for q, t in zip(pids[:half], targets[:half]):
        mf[q] = NEVER            # a live prober
        mf[t] = rng.choice([10, RND])  # of a dead member
    live = S - free
    # The first target keeps no slot (a needy one even at one lane).
    subjects = list(dict.fromkeys(
        targets[1:max(2, live)] + list(rng.permutation(N)[:live])))[:live]
    slot_node = np.full(S, -1, np.int32)
    slots = rng.permutation(S)[:len(subjects)]
    slot_node[slots] = subjects
    phases = np.asarray([tk.PHASE_SUSPECT, tk.PHASE_DEAD, tk.PHASE_REFUTED,
                         tk.PHASE_JOIN], np.int32)
    slot_phase = np.where(slot_node >= 0, rng.choice(phases, S),
                          tk.PHASE_FREE).astype(np.int32)
    slot_of_node = np.full(N, -1, np.int32)
    slot_of_node[slot_node[slots]] = slots
    st = dict(
        heard=rng.integers(0, 256, (S, N)).astype(np.uint8),
        slot_node=slot_node, slot_phase=slot_phase,
        slot_inc=rng.integers(0, 9, S).astype(np.int32),
        slot_start=rng.integers(0, RND, S).astype(np.int32),
        slot_nsusp=rng.integers(0, 4, S).astype(np.int32),
        slot_dead_round=np.where(rng.random(S) < 0.5, -1,
                                 rng.integers(0, RND, S)).astype(np.int32),
        slot_of_node=slot_of_node,
        incarnation=rng.integers(0, 9, N).astype(np.int32),
        member=mf >= 0,
        drops=np.int32(2**31 - 2))
    nem_state = None
    if lhm_max:
        nem_state = (rng.integers(0, lhm_max + 1, N).astype(np.int32),
                     rng.integers(0, lhm_max + 2, N).astype(np.int32))
        # Half the initiators have missed enough probes in a row to pass
        # their LHM; the others may be held back.
        nem_state[1][pids[:max(1, half // 2)]] = lhm_max + 1
    return st, mf, nem_state


_CARRY = ("heard", "slot_node", "slot_phase", "slot_inc", "slot_start",
          "slot_nsusp", "slot_dead_round", "slot_of_node", "incarnation",
          "member", "drops")


def _params(name, lib):
    n, S, pe, K, loss = CASES[name][:5]
    return (JParams if lib == "jax" else TParams)(
        n=n, slots=S, probe_every=pe, indirect_k=K, loss_rate=loss)


def _reference_tick(name, st, mf, nem_state, seed):
    p = _params(name, "jax")
    nem = _nem(CASES[name][5], "jax")
    key = jax.random.fold_in(jax.random.wrap_key_data(
        jnp.asarray(prng.key(seed))), RND)
    keys = jax.random.split(jax.random.fold_in(key, 1), 4)
    carry = tuple(jnp.asarray(st[f]) for f in _CARRY)
    ns = None if nem_state is None else jk.NemState(
        *(jnp.asarray(x) for x in nem_state))
    fn = jax.jit(jk._probe_tick, static_argnums=(0,),
                 static_argnames=("nem",))
    out = fn(p, jnp.int32(RND), keys, jnp.asarray(mf), carry, nem=nem,
             nem_state=ns)
    carry, stats = out[0], out[1]
    res = {f: np.asarray(x) for f, x in zip(_CARRY, carry)}
    res["stats"] = np.asarray([int(x) for x in stats], np.int32)
    if ns is not None:
        res["lhm"], res["streak"] = (np.asarray(x) for x in out[2])
    return res


def _port_tick(name, st, mf, nem_state, seed, scratch=None):
    """The port's tick on the CPU (the plain versions) from copies of
    the numpy state; returns the outputs and the scratch."""
    p = _params(name, "torch")
    nem = _nem(CASES[name][5], "torch")
    ndev = CASES[name][7]
    ra, _, _ = _row(p, seed)
    t = {f: torch.from_numpy(np.array(st[f])) for f in _CARRY}
    heard = t["heard"]
    if ndev > 1:
        L = p.n // ndev
        heard = tuple(t["heard"][:, i * L:(i + 1) * L].clone()
                      for i in range(ndev))
    carry = (heard,) + tuple(t[f] for f in _CARRY[1:])
    ns = None if nem_state is None else tk.NemState(
        *(torch.from_numpy(x.copy()) for x in nem_state))
    if scratch is None:
        scratch = probe.scratch(p, "cpu")
    v = tk.round_variant(p, nem, RND)
    out, stats, ns_out = tk._probe_tick(p, ra, v, torch.from_numpy(mf),
                                        carry, scratch, nem, ns)
    assert all(a is b for a, b in zip(out, carry)), "not in place"
    res = {f: (torch.cat(x, dim=1) if isinstance(x, tuple) else x).numpy()
           for f, x in zip(_CARRY, out)}
    res["stats"] = torch.stack(stats).numpy()
    if ns is not None:
        assert ns_out is ns
        res["lhm"], res["streak"] = (x.numpy() for x in ns_out)
    return res, scratch


@pytest.mark.parametrize("name", sorted(CASES))
def test_tick_matches_reference(name):
    n, S, pe, K, loss, nem_f, lhm, ndev, free = CASES[name]
    p = _params(name, "torch")
    seed = 7 + n + S
    _, blk, o_t = _row(p, seed)
    st, mf, nem_state = case_state(
        p, blk, o_t, seed, free, (nem_f or {}).get("lhm_max", 0) if lhm
        else 0)
    want = _reference_tick(name, st, mf, nem_state, seed)
    got, sp = _port_tick(name, st, mf, nem_state, seed)
    assert sorted(want) == sorted(got)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{name} {f}")
    # The scratch as every round leaves it: minima at N, counts at 0.
    cfg = probe.config(p, tk.round_variant(p, _nem(nem_f, "torch"), RND),
                       _nem(nem_f, "torch"))
    minima, counts, _ = probe._views(cfg, sp)
    assert bool((minima == p.n).all()) and int(counts.abs().sum()) == 0
    # The state did something: initiators, an allocation or a drop, and
    # (with live probers of REFUTED / JOIN subjects) a rearm.
    assert want["stats"][3] > 0, name
    served = int((want["slot_node"] >= 0).sum() - (st["slot_node"]
                                                   >= 0).sum())
    dropped = (int(want["drops"]) - int(st["drops"])) % 2**32
    assert served > 0 or dropped > 0, name
    if name == "drops":
        assert dropped > 0 and served == free
    rearmed = ((st["slot_phase"] == tk.PHASE_REFUTED)
               | (st["slot_phase"] == tk.PHASE_JOIN)) & (
                   want["slot_phase"] == tk.PHASE_SUSPECT)
    if name not in ("wan_one_lane",):
        assert rearmed.any(), name


def test_scratch_serves_again_and_kernels_refuse_the_cpu():
    """A scratch that one tick left serves the next as a fresh one, and
    a kernel wrapper given CPU tensors refuses them (the dispatchers take
    the plain versions there)."""
    p = _params("aligned_k3", "torch")
    ra, blk, o_t = _row(p, 3)
    st, mf, _ = case_state(p, blk, o_t, 3, 5)
    got, sp = _port_tick("aligned_k3", st, mf, None, 3)
    again, _ = _port_tick("aligned_k3", st, mf, None, 3, scratch=sp)
    for f in got:
        np.testing.assert_array_equal(got[f], again[f], err_msg=f)
    cfg = probe.config(p, tk.round_variant(p, None, RND))
    t = probe.Tick(torch.zeros((p.slots, p.n), dtype=torch.uint8), ra,
                   torch.from_numpy(mf), torch.full((p.n,), -1,
                                                    dtype=torch.int32),
                   None, tuple(torch.zeros(p.slots, dtype=torch.int32)
                               for _ in range(6)),
                   torch.zeros(p.n, dtype=torch.int32),
                   torch.zeros((), dtype=torch.int32), sp)
    with pytest.raises(ValueError, match="CUDA"):
        probe.probe_lanes_slots(cfg, t)


# -- whole runs -------------------------------------------------------------------

RUNS = {  # name -> (n, params, steps, ndev, nemesis scenario, what the
    # watcher must see)
    "churn_rearm_drops": (240, dict(slots=8, probe_every=5, loss_rate=0.05),
                          100, None, None, ("rearm", "drops")),
    "degraded_lhm_sharded": (320, dict(slots=12, probe_every=5,
                                       loss_rate=0.02), 110, 2,
                             "degraded_observer",
                             ("drops", "lhm_suppressed")),
}


def _run(name, lib):
    n, kw, steps, ndev, scn, _ = RUNS[name]
    p = (JParams if lib == "jax" else TParams)(n=n, **kw)
    fail, join = _schedule(n)
    # A burst of failures, two a round from round 80, that the slots
    # cannot all take (drops); the schedule's node L + 3 fails while its
    # join episode is live (a rearm).
    burst = 12 if scn is None else 20
    fail[40:40 + burst] = np.arange(burst, dtype=np.int32) // 2 + 80
    st0 = _start(TParams(n=n, **kw), join)
    nem = None
    if scn is not None:
        sc = (j_nem if lib == "jax" else t_nem).build(scn, n)
        nem = sc.nem
        fail = np.minimum(fail, sc.fail_round)
    if lib == "jax":
        from consul_tpu.gossip import kernel as jkm
        st = jkm.init_state(p)._replace(**{f: jnp.asarray(v)
                                           for f, v in st0.items()})
        extra = dict(trace=True, unroll=1, join_round=jnp.asarray(join),
                     hist=jkm.init_hist())
        if nem is not None:
            extra.update(nem=nem, nem_state=jkm.init_nem_state(n))
        key, fail = jax.random.PRNGKey(5), jnp.asarray(fail)
        if ndev is None:
            return jkm.run_rounds(st, key, fail, p, steps, **extra)
        return jkm.run_rounds_sharded(jkm.shard_state(st, ndev), key, fail,
                                      p, steps, ndev=ndev, **extra)
    from consul_tpu_torch.gossip import convert
    st = convert.state_from_numpy(st0, device="cpu")
    extra = dict(trace=True, device="cpu", join_round=join,
                 hist=tk.init_hist(device="cpu"))
    if nem is not None:
        extra.update(nem=nem, nem_state=tk.init_nem_state(n, device="cpu"))
    args = (st, prng.PRNGKey(5), fail, p, steps)
    if ndev is None:
        return tk.run_rounds(*args, **extra)
    return tk.run_rounds_sharded(*args, ndev=ndev, **extra)


def _watched(monkeypatch):
    """Count the rounds whose slot step rearmed a slot or dropped a needy
    target, and the lanes whose LHM held back a suspicion (the lanes step
    run once more without the registers, on a copy of the scratch)."""
    seen = {"rearm": 0, "drops": 0, "lhm_suppressed": 0}
    lanes, slots = probe.lanes, probe.slots

    def watched_lanes(cfg, t):
        if t.nem_state is not None:
            sp = t.sp.clone()
            probe.probe_lanes_ref(cfg, t.ra, t.mf, t.heard, t.slot_of_node,
                                  None, sp)
            without = int(probe._views(cfg, sp)[2].sum())
        lanes(cfg, t)
        if t.nem_state is not None:
            seen["lhm_suppressed"] += without - int(
                probe._views(cfg, t.sp)[2].sum())

    def watched_slots(cfg, t):
        d0 = int(t.drops)
        rearm, stats = slots(cfg, t)
        seen["rearm"] += int(rearm.any())
        seen["drops"] += int(int(t.drops) != d0)
        return rearm, stats

    monkeypatch.setattr(probe, "lanes", watched_lanes)
    monkeypatch.setattr(probe, "slots", watched_slots)
    return seen


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runs_match_reference(name, monkeypatch):
    ref_carry, ref_tr = _run(name, "jax")
    seen = _watched(monkeypatch)
    port_carry, port_tr = _run(name, "torch")
    assert len(ref_carry) == len(port_carry)
    for a, b in zip(ref_carry, port_carry):
        _assert_fields_equal(a, b, f"{name} ")
    _assert_fields_equal(ref_tr, port_tr, f"{name} trace ")
    assert all(seen[k] > 0 for k in RUNS[name][5]), seen
