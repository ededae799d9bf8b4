"""Cross-validation of the port's round against the discrete-event SWIM
oracle (port of ``consul_tpu/gossip/crossval.py``, which produces
``CROSSVAL.json``).

Definitions, as there:
  latency        = dead_declared_round - fail_round (both models)
  relative_error = |kernel - refmodel| / refmodel, per statistic
  completeness   = detected events / injected failures, per model

The kernel side runs the port's ``run_rounds`` / ``run_rounds_sharded``
with ``trace=True`` on ``device`` (None = the CUDA card); the oracle side
is ``gossip/refmodel.py``, a seeded pure-Python model.  Each row has the
reference's keys, and under the same seeds the reference's values
(``tests/test_torch_crossval.py``): only ``wall_s`` differs.  The trace
comes back to the host once per run, and percentiles are numpy's, as
there.

``executor`` (optional on ``run_config``, ``run_join_config`` and
``run_event_config``; any ``concurrent.futures.Executor``): the oracle's
seeds are submitted to it, one task each, before the kernel side starts,
so both sides run at once; ``wall_s`` of the oracle is then the wait for
its results after the kernel side.  Without one the oracle runs here,
after the kernel side, as in the reference.  ``chip_smoke.py`` is the
one caller that passes an executor: its time limit needs the oracle to
run on the CPU while the card runs the kernel side.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from consul_tpu_torch import prng
from consul_tpu_torch._device import resolve_device
from consul_tpu_torch.gossip import nemesis
from consul_tpu_torch.gossip.events import (fire_events, init_events,
                                            run_event_rounds)
from consul_tpu_torch.gossip.kernel import (NEVER, PHASE_DEAD, PHASE_JOIN,
                                            init_nem_state, init_state,
                                            run_rounds, run_rounds_sharded)
from consul_tpu_torch.gossip.params import SwimParams
from consul_tpu_torch.gossip.refmodel import RefModel


def _oracle(executor, fn, args: list):
    """The oracle's per-seed results, in seed order: submitted to
    ``executor`` now, or computed here when iterated."""
    if executor is None:
        return (fn(*a) for a in args)
    futures = [executor.submit(fn, *a) for a in args]
    return (f.result() for f in futures)


def _trace_np(trace) -> tuple:
    """(slot_node, slot_dead_round, slot_phase) of a trace as numpy."""
    return (trace.slot_node.cpu().numpy(),
            trace.slot_dead_round.cpu().numpy(),
            trace.slot_phase.cpu().numpy())


def _pct(a, q):
    return float(np.percentile(a, q)) if len(a) else None


def _rel(kv, rv):
    if kv is None or rv is None or not rv:
        return None
    return round(abs(kv - rv) / rv, 4)


def _mean(a):
    return round(float(a.mean()), 2) if len(a) else None


def kernel_event_latencies(p: SwimParams, fail_at: dict, steps: int,
                           seed: int, ndev: int = 0, device=None):
    """Per-event detection latencies from the round trace (reference
    ``kernel_event_latencies``): a victim's episode slot records its
    verdict round in ``slot_dead_round``; latency = dead_round -
    fail_round, true DEAD verdicts at or after the fail round only.
    Returns ``(latencies, n_false_dead, n_refuted, drops)``.  ``ndev >
    1`` runs the round on ``ndev`` column shards."""
    dev = resolve_device(device)
    fail = np.full(p.n, NEVER, np.int32)
    for v, t in fail_at.items():
        fail[v] = t
    if ndev > 1:
        st, trace = run_rounds_sharded(init_state(p, device=dev),
                                       prng.key(seed), fail, p, steps,
                                       trace=True, ndev=ndev, device=dev)
    else:
        st, trace = run_rounds(init_state(p, device=dev), prng.key(seed),
                               fail, p, steps, trace=True, device=dev)
    slot_node, slot_dead, slot_phase = _trace_np(trace)
    lats = []
    for v, t_fail in fail_at.items():
        mask = ((slot_node == v) & (slot_dead >= t_fail)
                & (slot_phase == PHASE_DEAD))
        if mask.any():
            lats.append(int(slot_dead[mask].min()) - t_fail)
    return lats, int(st.n_false_dead), int(st.n_refuted), int(st.drops)


def refmodel_event_latencies(p: SwimParams, fail_at: dict, steps: int,
                             seed: int):
    m = RefModel(p, dict(fail_at), seed=seed)
    m.run(steps)
    return m.detection_latencies(), m.n_false_dead, m.n_refuted


def loss_sized_slots(n: int, loss: float, base: int = 64) -> int:
    """Slot provisioning for a lossy regime (reference
    ``loss_sized_slots``): expected concurrent spurious suspicion
    episodes x 1.5, rounded up to a power of two, at least ``base``."""
    p = SwimParams(n=n, loss_rate=loss)
    p_no_rescue = p.p_indirect_fail_alive ** p.indirect_k if p.indirect_k else 1.0
    p_spur = p.p_direct_fail_alive * p_no_rescue
    per_round = (n / p.probe_every) * p_spur
    hold = 4 + 2 * p.spread_budget_rounds + 8
    need = int(per_round * hold * 1.5)
    return max(base, 1 << (need - 1).bit_length()) if need else base


def config_inputs(n: int, n_victims: int, loss: float = 0.0,
                  slots: int | None = None, pushpull: bool = False,
                  dissem: str = "swar"):
    """``(p, fail_at, steps)`` of ``run_config``'s matched config."""
    if slots is None:
        slots = loss_sized_slots(n, loss)
    p = SwimParams(n=n, slots=slots, probe_every=5, loss_rate=loss,
                   pushpull_every=150 if pushpull else 0, dissem=dissem)
    first_fail = 30
    spacing = max(5, p.suspicion_min_rounds // 4)
    fail_at = {(n // (n_victims + 1)) * (i + 1): first_fail + i * spacing
               for i in range(n_victims)}
    steps = (first_fail + n_victims * spacing
             + p.slot_ttl_rounds + 8 * p.probe_every)
    return p, fail_at, steps


def run_config(n: int, n_victims: int, seeds: int, loss: float = 0.0,
               slots: int | None = None, pushpull: bool = False,
               oracle: bool = True, ndev: int = 0, dissem: str = "swar",
               device=None, executor=None) -> dict:
    """One matched kernel-vs-oracle config; returns the report row
    (reference ``run_config``: ``pushpull`` arms anti-entropy in both
    models, ``oracle=False`` gates on the Lifeguard envelope only)."""
    p, fail_at, steps = config_inputs(n, n_victims, loss, slots, pushpull,
                                      dissem)
    slots = p.slots
    runs = _oracle(executor, refmodel_event_latencies,
                   [(p, fail_at, steps, 1000 + s)
                    for s in range(seeds if oracle else 0)])

    k_lats, r_lats = [], []
    k_fp = r_fp = k_ref = r_ref = k_drops = 0
    t0 = time.time()
    for s in range(seeds):
        kl, kf, kr, kd = kernel_event_latencies(p, fail_at, steps, seed=s,
                                                ndev=ndev, device=device)
        k_lats += kl
        k_fp += kf
        k_ref += kr
        k_drops += kd
    t_kernel = time.time() - t0
    t0 = time.time()
    for rl, rf, rr in runs:
        r_lats += rl
        r_fp += rf
        r_ref += rr
    t_ref = time.time() - t0

    k = np.asarray(k_lats, float)
    r = np.asarray(r_lats, float)
    expected = n_victims * seeds
    return {
        "n": n,
        "loss_rate": loss,
        "slots": slots,
        "dissem": dissem,
        "pushpull_every": p.pushpull_every,
        "oracle": oracle if oracle else "skipped (pure-Python oracle "
                  "intractable at this n; envelope gate only)",
        "victims_per_run": n_victims,
        "seeds": seeds,
        "samples": {"kernel": len(k),
                    "refmodel": len(r) if oracle else None},
        "expected_events": expected,
        "completeness": {
            "kernel": round(len(k) / expected, 4) if expected else None,
            "refmodel": (round(len(r) / expected, 4)
                         if oracle and expected else None),
        },
        "kernel_slot_drops": k_drops,
        "detection_latency_rounds": {
            "kernel": {"mean": _mean(k), "p50": _pct(k, 50),
                       "p99": _pct(k, 99)},
            "refmodel": {"mean": _mean(r), "p50": _pct(r, 50),
                         "p99": _pct(r, 99)},
        },
        "relative_error": {
            "mean": _rel(float(k.mean()) if len(k) else None,
                         float(r.mean()) if len(r) else None),
            "p50": _rel(_pct(k, 50), _pct(r, 50)),
            "p99": _rel(_pct(k, 99), _pct(r, 99)),
        },
        "false_dead": {"kernel": k_fp, "refmodel": r_fp},
        "refutes": {"kernel": k_ref, "refmodel": r_ref},
        "lifeguard_envelope_rounds": [p.suspicion_min_rounds,
                                      p.suspicion_max_rounds],
        "wall_s": {"kernel": round(t_kernel, 1), "refmodel": round(t_ref, 1)},
    }


# -- nemesis scenarios (gossip/nemesis.py; the oracle models the same
# injection schedule) ---------------------------------------------------------


def _flap_down_windows(nem) -> list:
    """[(down_start, down_end)] for a flapping schedule: the rounds a flap
    node is dead (detections are attributed to the window they fired
    in)."""
    out = []
    td = nem.start + nem.flap_up
    while td < nem.stop:
        out.append((td, min(td + nem.flap_period - nem.flap_up, nem.stop)))
        td += nem.flap_period
    return out


def kernel_nemesis_stats(p: SwimParams, sc, steps: int, seed: int,
                         ndev: int = 0, device=None):
    """One run of the round under a nemesis scenario (reference
    ``kernel_nemesis_stats``).  Returns ``(latencies, n_false_dead,
    n_refuted, drops, member_frac_end)``: static kills, and for flapping
    the first dead verdict per flap node in its down window."""
    dev = resolve_device(device)
    nem = sc.nem
    active = (nem.has_partition or nem.has_flap or nem.has_degraded
              or nem.heal_rejoin)
    kw = dict(
        trace=True,
        join_round=sc.join_round,
        nem=nem if active else None,
        nem_state=(init_nem_state(p.n, device=dev)
                   if active and nem.needs_state else None),
        device=dev,
    )
    if ndev > 1:
        out, trace = run_rounds_sharded(init_state(p, device=dev),
                                        prng.key(seed), sc.fail_round, p,
                                        steps, ndev=ndev, **kw)
    else:
        out, trace = run_rounds(init_state(p, device=dev), prng.key(seed),
                                sc.fail_round, p, steps, **kw)
    # The carry is (state[, hist][, nem_state]) when extras are threaded;
    # SwimState is itself a tuple, so sniff the field.
    st = out if hasattr(out, "member") else out[0]
    slot_node, slot_dead, slot_phase = _trace_np(trace)
    lats = []
    for v in np.nonzero(sc.killed)[0]:
        t_fail = int(sc.fail_round[v])
        mask = ((slot_node == v) & (slot_dead >= t_fail)
                & (slot_phase == PHASE_DEAD))
        if mask.any():
            lats.append(int(slot_dead[mask].min()) - t_fail)
    if nem.has_flap:
        wins = _flap_down_windows(nem)
        for v in range(nem.flap_lo, min(nem.flap_hi, p.n)):
            for td, te in wins:
                mask = ((slot_node == v) & (slot_phase == PHASE_DEAD)
                        & (slot_dead >= td) & (slot_dead < te))
                if mask.any():
                    lats.append(int(slot_dead[mask].min()) - td)
                    break
    member_frac = float(st.member.cpu().numpy().mean())
    return (lats, int(st.n_false_dead), int(st.n_refuted), int(st.drops),
            member_frac)


def nemesis_oracle(p: SwimParams, fail_at: dict, nem, steps: int,
                   seed: int):
    """One oracle run under a nemesis schedule: ``(latencies,
    n_false_dead, n_refuted, member_frac_end)``."""
    n = p.n
    m = RefModel(p, dict(fail_at), seed=seed, nemesis=nem)
    m.run(steps)
    alive = [i for i in range(n) if m._alive_truth(i)]
    mem = (float(np.mean([m._member_count(i) / (n - 1) for i in alive]))
           if alive else 0.0)
    return m.detection_latencies(), m.n_false_dead, m.n_refuted, mem


def run_nemesis_config(name: str, n: int, seeds: int, ndev: int = 0,
                       slots: int | None = None, steps: int | None = None,
                       oracle: bool = True, device=None) -> dict:
    """One nemesis scenario, kernel vs oracle, both under the same
    schedule (reference ``run_nemesis_config``; slots default to
    ``max(64, n)`` rounded up to a power of two).  ``oracle=False``
    runs the kernel side only, as ``run_config``'s does: the oracle's
    samples, completeness and membership are then None."""
    sc = nemesis.build(name, n)
    nem = sc.nem
    if slots is None:
        slots = max(64, 1 << (n - 1).bit_length())
    if steps is None:
        steps = sc.steps
    p = SwimParams(n=n, slots=slots, probe_every=5)
    fail_at = {int(v): int(sc.fail_round[v])
               for v in np.nonzero(sc.killed)[0]}
    expected = (len(fail_at)
                + (nem.flap_hi - nem.flap_lo if nem.has_flap else 0)) * seeds
    runs = (nemesis_oracle(p, fail_at, nem, steps, 1000 + s)
            for s in range(seeds if oracle else 0))

    k_lats, r_lats = [], []
    k_fp = r_fp = k_ref = r_ref = k_drops = 0
    k_mem, r_mem = [], []
    t0 = time.time()
    for s in range(seeds):
        kl, kf, kr, kd, km = kernel_nemesis_stats(p, sc, steps, seed=s,
                                                  ndev=ndev, device=device)
        k_lats += kl
        k_fp += kf
        k_ref += kr
        k_drops += kd
        k_mem.append(km)
    t_kernel = time.time() - t0
    t0 = time.time()
    for rl, rf, rr, rm in runs:
        r_lats += rl
        r_fp += rf
        r_ref += rr
        r_mem.append(rm)
    t_ref = time.time() - t0

    k = np.asarray(k_lats, float)
    r = np.asarray(r_lats, float)
    return {
        "scenario": name,
        "description": sc.description,
        "n": n,
        "slots": slots,
        "seeds": seeds,
        "steps": steps,
        "samples": {"kernel": len(k), "refmodel": len(r) if oracle else None},
        "expected_events": expected,
        "completeness": {
            "kernel": round(len(k) / expected, 4) if expected else None,
            "refmodel": (round(len(r) / expected, 4)
                         if oracle and expected else None),
        },
        "kernel_slot_drops": k_drops,
        "detection_latency_rounds": {
            "kernel": {"mean": _mean(k), "p50": _pct(k, 50),
                       "p99": _pct(k, 99)},
            "refmodel": {"mean": _mean(r), "p50": _pct(r, 50),
                         "p99": _pct(r, 99)},
        },
        "relative_error": {
            "mean": _rel(float(k.mean()) if len(k) else None,
                         float(r.mean()) if len(r) else None),
            "p50": _rel(_pct(k, 50), _pct(r, 50)),
            "p99": _rel(_pct(k, 99), _pct(r, 99)),
        },
        "false_dead": {"kernel": k_fp, "refmodel": r_fp},
        "refutes": {"kernel": k_ref, "refmodel": r_ref},
        "member_frac_end": {
            "kernel": round(float(np.mean(k_mem)), 4),
            "refmodel": round(float(np.mean(r_mem)), 4) if oracle else None,
        },
        "lifeguard_envelope_rounds": [p.suspicion_min_rounds,
                                      p.suspicion_max_rounds],
        "wall_s": {"kernel": round(t_kernel, 1), "refmodel": round(t_ref, 1)},
    }


# -- join churn: joins propagate as gossiped alive messages ---------------------


def join_oracle(p: SwimParams, fail_at: dict, join_at: dict, steps: int,
                target: float, seed: int):
    """One oracle run with joins: ``(latencies, n_false_dead,
    join_rounds_to_target)``."""
    m = RefModel(p, dict(fail_at), seed=seed, join_tick=dict(join_at))
    m.run(steps)
    joins = []
    for j, t_join in join_at.items():
        hits = [t for t, c in m.join_curve[j] if c >= target]
        if hits:
            joins.append(hits[0] + 1 - t_join)
    return m.detection_latencies(), m.n_false_dead, joins


def run_join_config(n: int, n_joiners: int, n_victims: int, seeds: int,
                    loss: float = 0.0, device=None, executor=None) -> dict:
    """Concurrent joins + failures, kernel vs oracle (reference
    ``run_join_config``): detection latency and completeness for the
    victims, and rounds from each join until 95% of the eventual
    membership holds its alive@inc announcement."""
    dev = resolve_device(device)
    slots = max(64, loss_sized_slots(n, loss))
    p = SwimParams(n=n, slots=slots, probe_every=5, loss_rate=loss)
    spacing = max(5, p.suspicion_min_rounds // 4)
    # Joiners are the top ids (they start outside the pool); victims are
    # spread through the standing membership; the windows interleave.
    joiners = [n - 1 - i for i in range(n_joiners)]
    join_at = {j: 20 + i * spacing for i, j in enumerate(joiners)}
    victims = [(n // (n_victims + 1)) * (i + 1) for i in range(n_victims)]
    fail_at = {v: 30 + i * spacing for i, v in enumerate(victims)}
    steps = (max(max(join_at.values()), max(fail_at.values()))
             + p.slot_ttl_rounds + 8 * p.probe_every)
    target = 0.95 * (n - n_victims)

    fail = np.full(n, NEVER, np.int32)
    for v, t in fail_at.items():
        fail[v] = t
    join = np.full(n, NEVER, np.int32)
    for j, t in join_at.items():
        join[j] = t
    runs = _oracle(executor, join_oracle,
                   [(p, fail_at, join_at, steps, target, 1000 + s)
                    for s in range(seeds)])

    k_lats, r_lats, k_join, r_join = [], [], [], []
    k_fp = r_fp = k_drops = 0
    t0 = time.time()
    for s in range(seeds):
        st = init_state(p, device=dev)._replace(
            member=torch.from_numpy(join == NEVER).to(dev))
        st, trace = run_rounds(st, prng.key(s), fail, p, steps, trace=True,
                               join_round=join, device=dev)
        slot_node, slot_dead, slot_phase = _trace_np(trace)
        heard_alive = trace.n_heard_alive.cpu().numpy()
        for v, t_fail in fail_at.items():
            mask = ((slot_node == v) & (slot_dead >= t_fail)
                    & (slot_phase == PHASE_DEAD))
            if mask.any():
                k_lats.append(int(slot_dead[mask].min()) - t_fail)
        for j, t_join in join_at.items():
            jm = (slot_node == j) & (slot_phase == PHASE_JOIN)
            curve = np.where(jm, heard_alive, 0).max(axis=1)
            hit = np.nonzero(curve >= target)[0]
            if hit.size:
                k_join.append(int(hit[0]) + 1 - t_join)
        k_fp += int(st.n_false_dead)
        k_drops += int(st.drops)
    t_kernel = time.time() - t0
    t0 = time.time()
    for rl, rf, rj in runs:
        r_lats += rl
        r_fp += rf
        r_join += rj
    t_ref = time.time() - t0

    k = np.asarray(k_lats, float)
    r = np.asarray(r_lats, float)

    def m_(a):
        return round(float(np.mean(a)), 2) if len(a) else None

    expected = n_victims * seeds
    expected_joins = n_joiners * seeds
    return {
        "n": n,
        "loss_rate": loss,
        "slots": slots,
        "joiners_per_run": n_joiners,
        "victims_per_run": n_victims,
        "seeds": seeds,
        "completeness": {
            "kernel": round(len(k) / expected, 4) if expected else None,
            "refmodel": round(len(r) / expected, 4) if expected else None,
        },
        "kernel_slot_drops": k_drops,
        "detection_latency_rounds": {
            "kernel": {"mean": m_(k), "p50": _pct(k, 50), "p99": _pct(k, 99)},
            "refmodel": {"mean": m_(r), "p50": _pct(r, 50),
                         "p99": _pct(r, 99)},
        },
        "relative_error": {
            "mean": _rel(m_(k), m_(r)),
            "p50": _rel(_pct(k, 50), _pct(r, 50)),
            "p99": _rel(_pct(k, 99), _pct(r, 99)),
        },
        "false_dead": {"kernel": k_fp, "refmodel": r_fp},
        "join_spread_rounds_to_95pct": {
            "kernel": m_(k_join), "refmodel": m_(r_join),
            "relative_error": _rel(m_(k_join), m_(r_join)),
            "completed": {"kernel": len(k_join), "refmodel": len(r_join),
                          "expected": expected_joins},
        },
        "wall_s": {"kernel": round(t_kernel, 1), "refmodel": round(t_ref, 1)},
    }


# -- event convergence: the kernel's circulant flood vs an iid-target flood ----


def event_oracle_curve(n: int, fanout: int, budget: int, steps: int,
                       seed: int) -> np.ndarray:
    """Per-node discrete-event flood with stock-gossip semantics (every
    holder pushes to ``fanout`` uniform random peers per round while its
    copy's age is within the budget).  Returns the coverage per round
    [T]."""
    rng = np.random.default_rng(seed)
    receipt = np.full(n, -1, np.int64)
    receipt[rng.integers(n)] = 0  # origin fired before round 1
    out = np.empty(steps, np.float64)
    for t in range(1, steps + 1):
        senders = np.nonzero((receipt >= 0) & (t - 1 - receipt < budget))[0]
        if senders.size:
            tgt = rng.integers(0, n - 1, size=(senders.size, fanout))
            # shift to skip self (uniform over the other n-1 nodes)
            tgt = tgt + (tgt >= senders[:, None])
            fresh = tgt[receipt[tgt] < 0]
            receipt[fresh] = t
        out[t - 1] = np.count_nonzero(receipt >= 0) / n
    return out


def kernel_event_curve(p: SwimParams, steps: int, seed: int,
                       device=None) -> np.ndarray:
    """Coverage curve [T] of one flooded event (slot 0)."""
    dev = resolve_device(device)
    st = init_events(p, slots=4, device=dev)
    origin = int(prng.randint(prng.key(seed ^ 0x5EED), (), 0, p.n))
    st = fire_events(st, torch.tensor([origin], dtype=torch.int32))
    alive = torch.ones((p.n,), dtype=torch.bool, device=dev)
    _, cov = run_event_rounds(st, prng.key(seed), alive, p, steps)
    return cov.cpu().numpy()[:, 0]


def _rounds_to(curve: np.ndarray, frac: float) -> float:
    hit = np.nonzero(curve >= frac)[0]
    return float(hit[0] + 1) if hit.size else float("inf")


def run_event_config(n: int, seeds: int, device=None,
                     executor=None) -> dict:
    """Event convergence, the port's flood vs the iid-target oracle
    (reference ``run_event_config``): rounds to 50% / 99% coverage."""
    p = SwimParams(n=n, slots=4, pushpull_every=0)
    budget = p.spread_budget_rounds
    # Flood completes in O(log_fanout n) + budget tail; 8x margin.
    steps = int(8 * (np.log(max(n, 2)) / np.log(p.fanout + 1) + budget))
    curves = _oracle(executor, event_oracle_curve,
                     [(n, p.fanout, budget, steps, 1000 + s)
                      for s in range(seeds)])

    t0 = time.time()
    k50, k99, r50, r99 = [], [], [], []
    for s in range(seeds):
        kc = kernel_event_curve(p, steps, seed=s, device=device)
        k50.append(_rounds_to(kc, 0.5))
        k99.append(_rounds_to(kc, 0.99))
    t_kernel = time.time() - t0
    t0 = time.time()
    for oc in curves:
        r50.append(_rounds_to(oc, 0.5))
        r99.append(_rounds_to(oc, 0.99))
    t_ref = time.time() - t0

    def m(a):
        a = [x for x in a if np.isfinite(x)]
        return round(float(np.mean(a)), 2) if a else None

    return {
        "n": n,
        "seeds": seeds,
        "fanout": p.fanout,
        "transmit_budget_rounds": budget,
        "completed": {"kernel": int(np.sum(np.isfinite(k99))),
                      "oracle": int(np.sum(np.isfinite(r99)))},
        "rounds_to_50pct": {"kernel": m(k50), "oracle": m(r50),
                            "relative_error": _rel(m(k50), m(r50))},
        "rounds_to_99pct": {"kernel": m(k99), "oracle": m(r99),
                            "relative_error": _rel(m(k99), m(r99))},
        "wall_s": {"kernel": round(t_kernel, 1),
                   "oracle": round(t_ref, 1)},
    }
