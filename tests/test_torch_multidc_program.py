"""The multi-DC round as one device program (``gossip/multidc.py``'s
``MultiDCProgram``), checked on the CPU.

- The pools' tables (``round_args.build_pools``: the D LAN pools under
  ``split(fold_in(key, 11), D)``, the WAN pool under ``fold_in(key,
  13)``, their round rows and event rows): columns against
  ``jax.random`` per pool and round.
- ``MultiDCProgram`` with its captures replaced by an emulation (each
  replay runs the captured body on the buffers; the round programs'
  branches as conditional nodes would take them), in table chunks,
  against the reference's ``run_multidc_rounds`` (JAX on the CPU): every
  field of every pool, the hist banks and the [steps, D, E] coverage
  trace, bit-identical, through ``convert.multidc_to_numpy``; D 2-3, hot
  tier 0/8, ``lan_devices`` 1/2.  One host read a call, 2 D + 3 replays
  a round.
- The replay check: every program of a multi-DC round logs the same ops
  and by-value kernel arguments in every round of the same variant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from consul_tpu.gossip import multidc as jm
from consul_tpu.gossip.kernel import NEVER
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert, fused, program, round_args
from consul_tpu_torch.gossip import events as te
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import multidc as tm

pytestmark = pytest.mark.timeout_s(400)

STEPS = 40  # per half


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """The reference compiled with XLA's optimisations off (the same
    integers, quicker)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _kd(k):
    return np.asarray(jax.random.key_data(k))


def test_pool_tables_match_jax_random():
    D, n, steps, seed = 3, 1000, 4, 21
    p = tm.make_params(D, n, slots=16)
    rounds = [5, 5, 9, 6, 6, 2, 5, 7]   # lan x 3, lan events x 3, wan, wev
    lan, lan_ev, wan, wan_ev = tm._tables(p, prng.key(seed), rounds, steps)
    jbase = jax.random.PRNGKey(seed)
    jkeys = jax.random.split(jax.random.fold_in(jbase, 11), D)
    jwan = jax.random.fold_in(jbase, 13)
    pools = [(p.lan, jkeys[d], lan[d], lan_ev[d], rounds[d], rounds[D + d])
             for d in range(D)] + [(p.wan, jwan, wan, wan_ev, rounds[2 * D],
                                    rounds[2 * D + 1])]
    for q, jkey, tbl, ev, r0, e0 in pools:
        lay = round_args.layout(q.fanout, q.indirect_k)
        for k in range(steps):
            key = jax.random.fold_in(jkey, r0 + k)
            assert tbl[k, round_args.RND] == r0 + k
            assert np.array_equal(
                tbl[k, 1:1 + q.fanout],
                np.asarray(jax.random.randint(jax.random.fold_in(key, 2),
                                              (q.fanout,), 1, q.n)))
            o = int(jax.random.randint(jax.random.fold_in(key, 3), (), 1,
                                       q.n))
            assert tuple(tbl[k, lay.pp:lay.pp + 2]) == (o, -o)
            _, j_dl, _, _ = jax.random.split(jax.random.fold_in(key, 1), 4)
            assert np.array_equal(tbl[k, lay.k_dl:lay.k_dl + 2]
                                  .view(np.uint32), _kd(j_dl))
            ekey = jax.random.fold_in(jax.random.fold_in(jkey, 7), e0 + k)
            assert ev[k, 0] == e0 + k
            assert np.array_equal(ev[k, 1:1 + q.fanout], np.asarray(
                jax.random.randint(ekey, (q.fanout,), 1, q.n)))
            o = int(jax.random.randint(jax.random.fold_in(ekey, 9), (), 1,
                                       q.n))
            assert tuple(ev[k, 1 + q.fanout:3 + q.fanout]) == (o, -o)


# -- MultiDCProgram against the reference ----------------------------------------

class _Emulate:
    """Conditional-node semantics on the CPU: a body runs where its
    predicate holds and writes the program's buffers."""

    def when(self, pred, fn, operand):
        if bool(pred):
            program._copy_leaves(operand, fn(operand))
        return operand

    def switch(self, choice, branches, names, dst):
        which, n_active = tk.choice_ref(choice)
        program._copy_leaves(dst, branches[int(which)]())
        return dst, n_active


class _EmulatedGraph:
    def __init__(self, prog, v):
        self.prog, self.v = prog, v

    def launch(self):
        tk._recorder = _Emulate()
        try:
            self.prog._body(self.v)
        finally:
            tk._recorder = None
        program.launches += 1

    def close(self):
        pass


@pytest.fixture
def emulated(monkeypatch):
    """The graphed route on the CPU: ``run_multidc_rounds`` takes the
    program (its captures emulated) where it would take the eager loop."""
    monkeypatch.setattr(program._Program, "_capture",
                        lambda self, v: _EmulatedGraph(self, v))
    monkeypatch.setattr(program, "TABLE_ROWS", 9)  # chunks of a call
    monkeypatch.setattr(tm, "_programs", type(tm._programs)())
    monkeypatch.setattr(tm, "_run_eager", tm._run_graphed)
    yield
    tm.close_programs()


def _fail_rounds(D: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    lan = np.full((D, n), NEVER, np.int32)
    for d in range(D):
        # Servers (ids 0-2) fail too in the last DC.
        ids = rng.choice(np.arange(1 if d == D - 1 else 3, n), 4, False)
        lan[d, ids] = rng.integers(5, 2 * STEPS - 20, 4)
    wan = np.full((D * 3,), NEVER, np.int32)
    wan[4] = 15
    return lan, wan


def _ref_np(st) -> dict:
    return {pool: {f: np.asarray(getattr(getattr(st, pool), f))
                   for f in getattr(st, pool)._fields}
            for pool in ("lan", "lan_events", "wan", "wan_events")}


def _diff(a: dict, b: dict, where: str) -> list:
    out = []
    for k in a:
        if isinstance(a[k], dict):
            out += _diff(a[k], b[k], f"{where}.{k}")
        elif a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]):
            out.append(f"{where}.{k}")
    return out


# (D, n_lan, hot_slots, lan_devices); hist banks on, push/pull every 5.
CASES = [(3, 160, 8, 1), (2, 160, 0, 2)]


@pytest.mark.parametrize("D,n,hot,ndev", CASES)
def test_multidc_program_matches_reference(D, n, hot, ndev, emulated):
    kw = dict(event_slots=2, lan_devices=ndev, slots=8, hot_slots=hot,
              pushpull_every=5)
    jp, tp = jm.make_params(D, n, **kw), tm.make_params(D, n, **kw)
    lan_fail, wan_fail = _fail_rounds(D, n, seed=D * n + hot)
    jl, jw = jnp.asarray(lan_fail), jnp.asarray(wan_fail)
    js, ts = jm.init_multidc(jp), tm.init_multidc(tp, device="cpu")
    jh, th = jm.init_multidc_hist(jp), tm.init_multidc_hist(tp,
                                                             device="cpu")
    fires = [[(0, n // 2)], [(D - 1, 1), (0, 7)]]
    covs = []
    for half in fires:
        for dc, node in half:
            js = jm.fire_in_dc(js, dc, node, jp)
            ts = tm.fire_in_dc(ts, dc, node, tp)
        (js, jh), jc = jm.run_multidc_rounds(js, jax.random.key(7), jl, jw,
                                             jp, STEPS, lan_hist=jh)
        syncs, graphs = tk.host_syncs, program.launches
        (ts, th), tc = tm.run_multidc_rounds(ts, prng.key(7), lan_fail,
                                             wan_fail, tp, STEPS,
                                             lan_hist=th, device="cpu")
        assert tk.host_syncs - syncs == 1
        assert program.launches - graphs == (2 * D + 3) * STEPS
        covs.append((np.asarray(jc), tc.numpy()))
    bad = _diff(_ref_np(js), convert.multidc_to_numpy(ts), "state")
    bad += _diff({f: np.asarray(getattr(jh, f)) for f in jh._fields},
                 convert.hist_banks_to_numpy(th), "hist")
    bad += [f"coverage[{i}]" for i, (a, b) in enumerate(covs)
            if a.shape != b.shape or a.dtype != b.dtype
            or not np.array_equal(a, b)]
    assert not bad, bad
    assert all(int(st.n_detected) > 0 for st in ts.lan)
    assert all(int(ev.drops) == 1 for ev in ts.lan_events)
    assert (covs[0][1][-1, :, 0] > 0).all()
    if ndev > 1:
        assert all(len(st.heard) == ndev for st in ts.lan)


def test_multidc_round_is_one_program_step(emulated):
    """``multidc_round`` is one step of the program: the same state as
    one round of ``run_multidc_rounds``, one host read."""
    p = tm.make_params(2, 160, event_slots=2, slots=8)
    lan_fail, wan_fail = _fail_rounds(2, 160, seed=3)
    st = tm.fire_in_dc(tm.init_multidc(p, device="cpu"), 1, 20, p)
    syncs = tk.host_syncs
    one = tm.multidc_round(st, prng.key(2), lan_fail, wan_fail, p,
                           device="cpu")
    assert tk.host_syncs - syncs == 1
    run, _ = tm.run_multidc_rounds(st, prng.key(2), lan_fail, wan_fail, p,
                                   1, device="cpu")
    assert not _diff(convert.multidc_to_numpy(one),
                     convert.multidc_to_numpy(run), "state")
    assert int(one.wan.round) == 1


# -- the replay check ------------------------------------------------------------

class _OpLog(TorchDispatchMode):
    """Every op with its non-tensor arguments (tensors as dtype and
    shape): what a captured graph would freeze."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        def desc(x):
            if isinstance(x, torch.Tensor):
                return ("T", str(x.dtype), tuple(x.shape))
            if isinstance(x, (list, tuple)):
                return tuple(desc(y) for y in x)
            return repr(x)

        self.ops.append((str(func), desc(args),
                         tuple(sorted((k, desc(v))
                                      for k, v in kwargs.items()))))
        return func(*args, **kwargs)


@pytest.mark.parametrize("ndev", [0, 2])
def test_replay_logs_do_not_depend_on_the_round(ndev, emulated,
                                                monkeypatch):
    """Per replay of each of a multi-DC round's 2 D + 3 programs: the
    branches it took, its variant and its op log with the kernel
    wrappers' by-value logs.  Replays of one program, variant and
    branches log the same, whatever the round."""
    logs = []
    launch = _EmulatedGraph.launch

    def logged(self):
        reads = []
        when, switch = _Emulate.when, _Emulate.switch

        def r_when(em, pred, fn, operand):
            reads.append(("when", bool(pred)))
            return when(em, pred, fn, operand)

        def r_switch(em, choice, branches, names, dst):
            reads.append(("switch", int(tk.choice_ref(choice)[0])))
            return switch(em, choice, branches, names, dst)

        monkeypatch.setattr(_Emulate, "when", r_when)
        monkeypatch.setattr(_Emulate, "switch", r_switch)
        te.launch_log, fused.launch_log, prng.launch_log = [], [], []
        try:
            with _OpLog() as log:
                launch(self)
        finally:
            monkeypatch.setattr(_Emulate, "when", when)
            monkeypatch.setattr(_Emulate, "switch", switch)
        logs.append((id(self.prog), self.v, tuple(reads),
                     log.ops + te.launch_log + fused.launch_log
                     + prng.launch_log))
        te.launch_log = fused.launch_log = prng.launch_log = None

    monkeypatch.setattr(_EmulatedGraph, "launch", logged)
    D, n, steps = 2, 160, 24
    p = tm.make_params(D, n, event_slots=2, slots=8, hot_slots=4,
                       lan_devices=ndev, pushpull_every=5)
    lan_fail, wan_fail = _fail_rounds(D, n, seed=8)
    st = tm.fire_in_dc(tm.init_multidc(p, device="cpu"), 0, 40, p)
    # The run is made once before it is logged, so the round's caches are
    # warm (the program warms a variant up before it captures it).
    tm.run_multidc_rounds(st, prng.key(5), lan_fail, wan_fail, p, steps,
                          device="cpu")
    logs.clear()
    tm.run_multidc_rounds(st, prng.key(5), lan_fail, wan_fail, p, steps,
                          device="cpu")
    assert len(logs) == (2 * D + 3) * steps
    groups = {}
    for i, (prog, v, reads, log) in enumerate(logs):
        groups.setdefault((prog, v, reads), []).append((i, log))
    compared = 0
    for key, members in groups.items():
        first_i, first = members[0]
        for i, log in members[1:]:
            assert log == first, f"replays {first_i} and {i} of {key[1:]}"
            compared += 1
    assert compared >= len(logs) // 2
    floods = sum(1 for *_, log in logs for e in log if e[0] == "event_flood")
    assert floods == (D + 1) * steps
