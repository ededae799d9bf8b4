"""The port's cross-validation functions (consul_tpu_torch/gossip/crossval.py)
and its copy of the SWIM oracle (gossip/refmodel.py) against the
reference's (consul_tpu/gossip/crossval.py, refmodel.py) on the CPU,
tolerance 0: every field of every report row but ``wall_s``, and the
oracle's detection events, false-dead and refute counts on the same
seeds.

The rows are bit-equal because the port's round is (tests/
test_torch_kernel.py): a row here is a summary of traces that must match
sample for sample.  Sizes are small (n of 100-256, one or two seeds);
each distinct (params, steps) compiles one reference scan."""

import dataclasses

import numpy as np
import pytest

from consul_tpu.gossip import crossval as jc
from consul_tpu.gossip import nemesis as j_nem
from consul_tpu.gossip import refmodel as j_ref
from consul_tpu.gossip.params import SwimParams as JParams
from consul_tpu_torch.gossip import crossval as tc
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip import refmodel as t_ref
from consul_tpu_torch.gossip.params import SwimParams as TParams

pytestmark = pytest.mark.timeout_s(600)


def _same_row(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if k != "wall_s":
            assert a[k] == b[k], (k, a[k], b[k])
    assert set(a["wall_s"]) == set(b["wall_s"])


def _oracle_outcome(mod, p, fail_at, seed, steps, **kw):
    m = mod.RefModel(p, dict(fail_at), seed=seed, **kw)
    m.run(steps)
    return {"latencies": m.detection_latencies(),
            "events": [dataclasses.astuple(e) for e in m.events],
            "n_false_dead": m.n_false_dead, "n_refuted": m.n_refuted,
            "join_curve": {j: list(c) for j, c in m.join_curve.items()},
            "members": [m._member_count(i) for i in range(p.n)]}


# (n, params, fail_at, extra): failures, loss, push/pull, joins.
ORACLE_CASES = {
    "failures": (96, dict(slots=16, probe_every=5),
                 {10: 20, 50: 35, 90: 50}, {}),
    "loss_pushpull": (100, dict(slots=32, probe_every=5, loss_rate=0.2,
                                pushpull_every=30),
                      {7: 25, 60: 40}, {}),
    "joins": (128, dict(slots=32, probe_every=5), {40: 30},
              {"join_tick": {127: 20, 126: 35}}),
}


@pytest.mark.parametrize("case", sorted(ORACLE_CASES))
def test_refmodel_copy_runs_as_the_original(case):
    n, kw, fail_at, extra = ORACLE_CASES[case]
    steps = 260
    for seed in (3, 1001):
        a = _oracle_outcome(j_ref, JParams(n=n, **kw), fail_at, seed, steps,
                            **extra)
        b = _oracle_outcome(t_ref, TParams(n=n, **kw), fail_at, seed, steps,
                            **extra)
        assert a == b, seed
        assert a["events"] or case == "loss_pushpull"


@pytest.mark.parametrize("name", ["partition_heal", "degraded_observer"])
def test_refmodel_copy_under_nemesis(name):
    n = 128
    ja, ta = j_nem.build(name, n), t_nem.build(name, n)
    fail_at = {int(v): int(ja.fail_round[v]) for v in np.nonzero(ja.killed)[0]}
    steps = min(ja.steps, 220)
    kw = dict(slots=128, probe_every=5)
    a = _oracle_outcome(j_ref, JParams(n=n, **kw), fail_at, 1000, steps,
                        nemesis=ja.nem)
    b = _oracle_outcome(t_ref, TParams(n=n, **kw), fail_at, 1000, steps,
                        nemesis=ta.nem)
    assert a == b


@pytest.mark.parametrize("n", [64, 500, 1000, 100_000])
@pytest.mark.parametrize("loss", [0.0, 0.05, 0.25, 0.5])
def test_loss_sized_slots(n, loss):
    assert tc.loss_sized_slots(n, loss) == jc.loss_sized_slots(n, loss)
    assert tc.loss_sized_slots(n, loss, base=8) == jc.loss_sized_slots(
        n, loss, base=8)


@pytest.mark.parametrize("kw", [
    dict(n=120, n_victims=4, seeds=2),
    dict(n=100, n_victims=3, seeds=1, loss=0.25, pushpull=True),
], ids=["lossless", "loss_pushpull"])
def test_run_config_row(kw):
    _same_row(jc.run_config(**kw), tc.run_config(**kw, device="cpu"))


@pytest.mark.parametrize("name", ["partition_heal", "flapping"])
def test_run_nemesis_config_row(name):
    a = jc.run_nemesis_config(name, 128, seeds=1)
    b = tc.run_nemesis_config(name, 128, seeds=1, device="cpu")
    _same_row(a, b)
    # partition_heal kills no one: its row is its false dead verdicts.
    assert b["samples"]["kernel"] > 0 or b["false_dead"]["kernel"] > 0
    # Without the oracle: the same kernel side, the oracle's fields None.
    c = tc.run_nemesis_config(name, 128, seeds=1, oracle=False, device="cpu")
    for k in ("samples", "completeness", "member_frac_end"):
        assert c[k] == {**b[k], "refmodel": None}, k
    for k in ("kernel_slot_drops", "expected_events", "steps"):
        assert c[k] == b[k], k
    assert c["false_dead"]["kernel"] == b["false_dead"]["kernel"]
    assert (c["detection_latency_rounds"]["kernel"]
            == b["detection_latency_rounds"]["kernel"])


def test_run_join_config_row():
    kw = dict(n=128, n_joiners=3, n_victims=2, seeds=1)
    b = tc.run_join_config(**kw, device="cpu")
    _same_row(jc.run_join_config(**kw), b)
    assert b["join_spread_rounds_to_95pct"]["completed"]["kernel"] == 3


@pytest.mark.parametrize("n", [256, 1000])
def test_run_event_config_row(n):
    _same_row(jc.run_event_config(n, seeds=2),
              tc.run_event_config(n, seeds=2, device="cpu"))


def test_kernel_event_latencies_sharded():
    """ndev = 2 on both sides (the reference on two of the 8 CPU mesh
    devices), and the port's sharded run equal to its single-device one."""
    p_kw = dict(n=120, slots=16, probe_every=5)
    fail_at = {13: 25, 70: 40, 101: 55}
    steps = 240
    a = jc.kernel_event_latencies(JParams(**p_kw), fail_at, steps, seed=4,
                                  ndev=2)
    b = tc.kernel_event_latencies(TParams(**p_kw), fail_at, steps, seed=4,
                                  ndev=2, device="cpu")
    c = tc.kernel_event_latencies(TParams(**p_kw), fail_at, steps, seed=4,
                                  device="cpu")
    assert a == b == c
    assert len(a[0]) == len(fail_at)


def test_executor_gives_the_same_row():
    """With an executor the oracle's seeds run as its tasks: same row."""
    from concurrent.futures import ThreadPoolExecutor
    kw = dict(n=60, n_victims=2, seeds=2, device="cpu")
    with ThreadPoolExecutor(2) as pool:
        b = tc.run_config(**kw, executor=pool)
    _same_row(tc.run_config(**kw), b)
