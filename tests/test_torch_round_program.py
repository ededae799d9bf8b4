"""The round as one device program (``consul_tpu_torch/gossip/program.py``,
``round_args.py``), checked on the CPU.

- The argument table: every column of ``round_args.build`` against
  ``jax.random`` and against the port's scalar twin (``prng``), for a
  run of rounds.
- The device-row round (the eager round, which reads every scalar from
  its table row and branches through ``_when``/``_switch``) against the
  reference's ``run_rounds`` (JAX on the CPU): every field of the carry
  and the trace, bit-identical, in churn with joins, push/pull every 3
  rounds, the hot tier, the flight ring, hist banks and trace; healthy
  with quiescent rounds; ``partition_heal``, ``asym_loss``,
  ``degraded_observer`` with NemState, ``flapping``; 2 and 4 shards.
- The replay check: every op a round runs is logged with its non-tensor
  arguments (a ``TorchDispatchMode``), and the kernel wrappers log what
  they would take by value; two rounds of one variant that take the same
  branches log the same, whatever their round numbers.  That is what lets
  one capture serve every round.
- ``RoundProgram``'s buffers on the CPU: its captures replaced by an
  emulation of the conditional nodes (each branch group's chooser node by
  its plain version, ``program.choose``; the body taken writes the
  program's buffers), its runs equal the eager round's, in table chunks,
  and ``kernel.host_syncs`` moves by the round counter and flight cursor
  reads of a call, not by its rounds; the runs the emulated choosers
  count (``branch_runs``, settled) equal the eager round's
  ``tail_rounds`` and ``join_rounds``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from consul_tpu.gossip import kernel as jk
from consul_tpu.gossip import nemesis as j_nem
from consul_tpu.gossip.params import lan_profile as j_lan
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import convert, fused, program, round_args
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import nemesis as t_nem
from consul_tpu_torch.gossip.params import lan_profile as t_lan

NEVER = 2**31 - 1
N = 80  # divisible by probe_every 5 and by 2 and 4 shards
SEED = 5


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """The reference compiled with XLA's optimisations off (the same
    integers, quicker), as tests/test_torch_kernel.py."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def _kd(k):
    return np.asarray(jax.random.key_data(k))


# -- the table -----------------------------------------------------------------

def test_table_columns_match_jax_random():
    p = t_lan(1000, slots=16)
    rnd0, steps, cur, R = 149, 4, 250, 256
    tbl = round_args.build(p, prng.key(SEED), rnd0, steps, cur, R)
    lay = round_args.layout(p.fanout, p.indirect_k)
    assert tbl.shape == (steps, lay.width) and tbl.dtype == np.int32
    B = 1000 // p.probe_every

    def words(at):
        return tbl[k, at:at + 2].view(np.uint32)

    for k in range(steps):
        rnd = rnd0 + k
        jkey = jax.random.fold_in(jax.random.PRNGKey(SEED), rnd)
        tkey = prng.fold_in(prng.key(SEED), rnd)
        j_t, j_dl, j_h, j_hl = jax.random.split(jax.random.fold_in(jkey, 1), 4)
        t_t, t_dl, t_h, t_hl = prng.split(prng.fold_in(tkey, 1), 4)
        assert tbl[k, round_args.RND] == rnd
        assert tbl[k, lay.blk] == (rnd % p.probe_every) * B
        assert tbl[k, lay.flight] == (cur + k) % R
        gossip = tbl[k, round_args.GOSSIP:round_args.GOSSIP + p.fanout]
        want = np.asarray(jax.random.randint(jax.random.fold_in(jkey, 2),
                                             (p.fanout,), 1, 1000))
        assert np.array_equal(gossip, want)
        assert np.array_equal(gossip, tk.gossip_offsets(
            prng.fold_in(tkey, 2), 1000, p.fanout))
        probe = tbl[k, lay.probe:lay.probe + 1 + p.indirect_k]
        assert np.array_equal(probe, np.asarray(jax.random.randint(
            j_t, (1 + p.indirect_k,), 1, 1000)))
        assert np.array_equal(probe, prng.randint(t_t, (1 + p.indirect_k,),
                                                  1, 1000))
        o = int(jax.random.randint(jax.random.fold_in(jkey, 3), (), 1, 1000))
        assert tuple(tbl[k, lay.pp:lay.pp + 2]) == (o, -o)
        assert o == int(prng.randint(prng.fold_in(tkey, 3), (), 1, 1000))
        for at, jkk, tkk in ((lay.k_dl, j_dl, t_dl), (lay.k_hl, j_hl, t_hl)):
            assert np.array_equal(words(at), _kd(jkk))
            assert np.array_equal(words(at), tkk)
        for j, (jkk, tkk) in enumerate(zip(jax.random.split(j_h, 4),
                                           prng.split(t_h, 4))):
            assert np.array_equal(words(lay.k_nem + 2 * j), _kd(jkk))
            assert np.array_equal(words(lay.k_nem + 2 * j), tkk)
        for f in range(p.fanout):
            want = jax.random.fold_in(jax.random.fold_in(jkey, 4), f)
            assert np.array_equal(words(lay.k_legs + 2 * f), _kd(want))
        for j in range(2):
            want = jax.random.fold_in(jax.random.fold_in(jkey, 5), j)
            assert np.array_equal(words(lay.k_pp + 2 * j), _kd(want))
            assert np.array_equal(words(lay.k_pp + 2 * j), prng.fold_in(
                prng.fold_in(tkey, 5), j))


def test_device_keys_draw_as_host_keys():
    """A draw from a key in a table row (a device key) equals the draw
    from the same key on the host, and ``jax.random``'s."""
    p = t_lan(1000, slots=16)
    lay = round_args.layout(p.fanout, p.indirect_k)
    row = torch.from_numpy(round_args.build(p, prng.key(SEED), 77, 1)[0])
    ra = round_args.row_args(lay, row)
    host = ra.k_hl.numpy().view(np.uint32)
    got = prng.uniform_tensor(ra.k_hl, (40, 3), "cpu")
    assert torch.equal(got, prng.uniform_tensor(host, (40, 3), "cpu"))
    assert np.array_equal(got.numpy(), np.asarray(jax.random.uniform(
        jax.random.wrap_key_data(jnp.asarray(host)), (40, 3))))
    legs = [row_key.numpy().view(np.uint32) for row_key in ra.k_legs]
    grp = (torch.arange(1000) >= 500).to(torch.int32)
    assert torch.equal(
        prng.edge_drops(ra.k_legs, grp, ra.gossip, 0.6, 0.3),
        prng.edge_drops(legs, grp, ra.gossip.tolist(), 0.6, 0.3))


# -- the device-row round against the reference --------------------------------

def _churn(n):
    fail = np.full(n, NEVER, np.int32)
    fail[[3, 17, 41, 66]] = [5, 12, 20, 31]
    join = np.full(n, NEVER, np.int32)
    join[[9, 50, 71]] = [4, 15, 27]
    return fail, join


# name -> (params, steps, first round, nemesis scenario or None, ndev).
CASES = {
    "churn_joins_pushpull_hot": (dict(slots=8, pushpull_every=3,
                                      hot_slots=4, loss_rate=0.05), 60, 0,
                                 None, None),
    "healthy_quiescent": (dict(slots=8, hot_slots=0), 20, 0, None, None),
    "partition_heal": (dict(slots=16), 50, 30, "partition_heal", None),
    "asym_loss": (dict(slots=16), 40, 15, "asym_loss", None),
    "degraded_observer": (dict(slots=16), 40, 35, "degraded_observer",
                          None),
    "flapping": (dict(slots=16), 60, 25, "flapping", None),
    "churn_2_shards": (dict(slots=8, pushpull_every=3, hot_slots=4,
                            loss_rate=0.05), 60, 0, None, 2),
    "churn_4_shards": (dict(slots=8, pushpull_every=3, loss_rate=0.05), 60,
                       0, None, 4),
}


def _inputs(name):
    kw, steps, rnd0, scen, ndev = CASES[name]
    fail, join = _churn(N)
    nem = None
    if scen is not None:
        sc = t_nem.build(scen, N)
        fail = np.minimum(fail, sc.fail_round)
        if sc.join_round is not None:
            join = np.minimum(join, sc.join_round)
        nem = scen
    if name == "healthy_quiescent":
        fail[:], join[:] = NEVER, NEVER
    return kw, steps, rnd0, nem, ndev, fail, join


def _reference(name):
    kw, steps, rnd0, scen, _, fail, join = _inputs(name)
    p = j_lan(N, **kw)
    st = jk.init_state(p)
    st = st._replace(round=jnp.int32(rnd0),
                     member=jnp.asarray(join == NEVER))
    extra = dict(join_round=jnp.asarray(join), flight=jk.init_flight(),
                 hist=jk.init_hist())
    if scen is not None:
        extra["nem"] = j_nem.build(scen, N).nem
        if extra["nem"].needs_state:
            extra["nem_state"] = jk.init_nem_state(N)
    return jk.run_rounds(st, jax.random.PRNGKey(SEED), jnp.asarray(fail), p,
                         steps, trace=True, unroll=1, **extra)


def _port(name, **run_kw):
    kw, steps, rnd0, scen, ndev, fail, join = _inputs(name)
    p = t_lan(N, **kw)
    st = tk.init_state(p, device="cpu")
    st = st._replace(round=torch.tensor(rnd0, dtype=torch.int32),
                     member=torch.from_numpy(join == NEVER))
    extra = dict(join_round=join, flight=tk.init_flight(device="cpu"),
                 hist=tk.init_hist(device="cpu"), device="cpu", **run_kw)
    if scen is not None:
        extra["nem"] = t_nem.build(scen, N).nem
        if extra["nem"].needs_state:
            extra["nem_state"] = tk.init_nem_state(N, device="cpu")
    args = (st, prng.PRNGKey(SEED), fail, p, steps)
    if ndev is None:
        return tk.run_rounds(*args, trace=True, **extra)
    return tk.run_rounds_sharded(*args, trace=True, ndev=ndev, **extra)


def _assert_same(ref, port, ctx):
    (rc, rtr), (pc, ptr) = ref, port
    assert len(rc) == len(pc), ctx
    for a, b in list(zip(rc, pc)) + [(rtr, ptr)]:
        if isinstance(b, tk.SwimState):
            b = tk.unshard_state(b)
        got = convert.state_to_numpy(b)
        for f in a._fields:
            x = np.asarray(getattr(a, f))
            assert x.dtype == got[f].dtype and x.shape == got[f].shape, \
                f"{ctx}{type(a).__name__}.{f}"
            assert np.array_equal(x, got[f]), f"{ctx}{type(a).__name__}.{f}"


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_row_round_matches_reference(name):
    port = _port(name)
    _assert_same(_reference(name), port, f"{name}: ")
    st, fl = port[0][0], port[0][1]
    if name.startswith("churn"):
        # Not vacuous: detections, joins, push/pull rounds and both tails.
        assert int(st.n_detected) > 0 and int(st.incarnation.sum()) > 0
    if name == "healthy_quiescent":
        assert int((fl.rows[:20, 8]).sum()) == 0  # no live slot, ever


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


def _logged_rounds(name, monkeypatch):
    """Per round of ``name``'s eager run: (variant, the branches it read,
    its op log with the kernel wrappers' by-value logs).  The run is made
    once before it is logged, so the round's caches are warm (the program
    warms a variant up before it captures it)."""
    _port(name)
    rounds = []
    reads = []
    inner = tk._round_once
    host_int = tk._host_int

    def logged(p, table, step, state, v, *a, **kw):
        reads.clear()
        prng.launch_log, fused.launch_log = [], []
        with _OpLog() as log:
            out = inner(p, table, step, state, v, *a, **kw)
        rounds.append((v, tuple(reads), log.ops + prng.launch_log
                       + fused.launch_log))
        prng.launch_log = fused.launch_log = None
        return out

    def read(t):
        reads.append(int(t))
        return host_int(t)

    monkeypatch.setattr(tk, "_round_once", logged)
    monkeypatch.setattr(tk, "_host_int", read)
    _port(name)
    return rounds


@pytest.mark.parametrize("name", ["churn_joins_pushpull_hot",
                                  "partition_heal", "churn_2_shards"])
def test_replay_logs_do_not_depend_on_the_round(name, monkeypatch):
    rounds = _logged_rounds(name, monkeypatch)
    groups = {}
    for i, (v, reads, log) in enumerate(rounds):
        groups.setdefault((v, reads), []).append((i, log))
    compared = 0
    for key, members in groups.items():
        first_i, first = members[0]
        for i, log in members[1:]:
            assert log == first, f"{name}: rounds {first_i} and {i} of {key}"
            compared += 1
    # Every variant the run met is a variant the program captures, and
    # the run compared rounds across most of its groups.
    variants = {v for v, _, _ in rounds}
    assert len(variants) <= tk.MAX_VARIANTS
    assert compared >= len(rounds) // 2, groups.keys()
    # No by-value key or shift reached a draw (the tail takes its round
    # and shifts only from device memory).
    for _, _, log in rounds:
        for entry in log:
            if entry[0] in ("uniform", "below"):
                assert entry[-1] == "dev", entry
            if entry[0] == "edge_drops":
                assert entry[-2:] == ("dev", "dev"), entry


# -- the program's buffers, its branches emulated ------------------------------

class _Emulate:
    """Conditional-node semantics on the CPU: each branch group's chooser
    node runs its plain version (``program.choose``: the group's choice,
    one added to the taken branch's run in the program's
    ``branch_runs``, the tail's live slots into the program's
    ``n_active``), then the body taken writes the program's buffers.  A
    group's branches get their run indices at the graph's first launch,
    as a capture gives them."""

    def __init__(self, graph):
        self.graph, self.groups = graph, 0

    def _bids(self, names):
        key = self.groups
        self.groups += 1
        if key not in self.graph.bids:
            self.graph.bids[key] = [self.graph.prog.new_branch(n)
                                    for n in names]
        return self.graph.bids[key]

    def when(self, pred, fn, operand):
        ran = program.choose(tk.Choice(pred, 1), self.graph.prog.branch_runs,
                             self._bids(["join"]))
        if int(ran[0]):
            program._copy_leaves(operand, fn(operand))
        return operand

    def switch(self, choice, branches, names, dst):
        prog = self.graph.prog
        ran = program.choose(choice, prog.branch_runs, self._bids(names),
                             prog.n_active)
        assert int(ran.sum()) == 1  # exactly one body runs
        program._copy_leaves(dst, branches[int(ran.argmax())]())
        return dst, prog.n_active


class _EmulatedGraph:
    def __init__(self, prog, v):
        self.prog, self.v = prog, v
        self.bids, self.branch = {}, {}  # no captured launches to count

    def launch(self):
        tk._recorder = _Emulate(self)
        try:
            self.prog._round(self.v, dst=self.prog.dst)
        finally:
            tk._recorder = None


@pytest.mark.parametrize("name", ["churn_joins_pushpull_hot",
                                  "degraded_observer", "churn_4_shards"])
def test_program_buffers_match_eager(name, monkeypatch):
    monkeypatch.setattr(program.RoundProgram, "_capture",
                        lambda self, v: _EmulatedGraph(self, v))
    monkeypatch.setattr(program, "TABLE_ROWS", 7)  # chunks of a call
    monkeypatch.setattr(program, "_programs", type(program._programs)())
    eager = _port(name, graphed=False)

    def via_program(state, base_key, fail, p, steps, trace, join, flight,
                    hist, dev, sc=None, nem=None, nem_state=None,
                    graphed=None):
        # The program's path, as a card takes it, on CPU tensors.
        return program.run_rounds(
            state, base_key, tk._as_i32(fail, dev), p, steps, trace,
            tk._as_i32(join, dev), flight, hist, sc, nem, nem_state)

    monkeypatch.setattr(tk, "_run_rounds_impl", via_program)
    syncs = tk.host_syncs
    graphed = _port(name)
    assert tk.host_syncs - syncs == 2  # the round counter and the cursor
    (ec, etr), (gc, gtr) = eager, graphed
    for a, b in list(zip(ec, gc)) + [(etr, gtr)]:
        if isinstance(a, tk.SwimState):
            a, b = tk.unshard_state(a), tk.unshard_state(b)
        x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
        for f in x:
            assert x[f].dtype == y[f].dtype and np.array_equal(x[f], y[f]), \
                f"{name}: {type(a).__name__}.{f}"


def _counts():
    return dict(tk.tail_rounds), tk.join_rounds


def _zero_counts():
    for k in tk.tail_rounds:
        tk.tail_rounds[k] = 0
    tk.join_rounds = 0


@pytest.mark.parametrize("name", ["churn_joins_pushpull_hot",
                                  "healthy_quiescent", "churn_2_shards"])
def test_emulated_branch_runs_match_eager_counts(name, monkeypatch):
    """The runs the choosers count on the device (``branch_runs``, read
    by ``program.settle_counts``) equal the eager round's host counts of
    each tail and of the join ticks: churn with joins and the hot tier,
    healthy with quiescent rounds, 2 shards.  No body adds to a counter
    of its own: the choosers alone count."""
    monkeypatch.setattr(program.RoundProgram, "_capture",
                        lambda self, v: _EmulatedGraph(self, v))
    monkeypatch.setattr(program, "TABLE_ROWS", 7)
    monkeypatch.setattr(program, "_programs", type(program._programs)())
    saved = _counts()
    try:
        _zero_counts()
        _port(name, graphed=False)
        eager = _counts()

        def via_program(state, base_key, fail, p, steps, trace, join,
                        flight, hist, dev, sc=None, nem=None,
                        nem_state=None, graphed=None):
            return program.run_rounds(
                state, base_key, tk._as_i32(fail, dev), p, steps, trace,
                tk._as_i32(join, dev), flight, hist, sc, nem, nem_state)

        monkeypatch.setattr(tk, "_run_rounds_impl", via_program)
        _zero_counts()
        _port(name)
        assert _counts() == ({"quiescent": 0, "hot": 0, "full": 0}, 0)
        program.settle_counts()
        graphed = _counts()
    finally:
        tk.tail_rounds.update(saved[0])
        tk.join_rounds = saved[1]
    assert graphed == eager, name
    tails, joins = eager
    assert sum(tails.values()) == CASES[name][1]  # one tail a round
    if name == "healthy_quiescent":
        assert tails["quiescent"] == CASES[name][1] and joins == 0
    else:
        assert tails["full"] > 0 and joins > 0
        assert tails["hot"] > 0 and tails["quiescent"] > 0


@pytest.mark.parametrize("S, hot", [(1, 0), (63, 0), (64, 0), (1024, 0),
                                    (64, 8), (1024, 8)])
def test_choose_ref_follows_the_tail_rule(S, hot):
    """``program.choose_ref`` (the chooser node's plain version) against
    the rule written out, at n_active 0, hot, hot + 1 and S: the branch
    taken, one run added at its index and none elsewhere, the count."""
    k = 3 if hot else 2
    bids = [5, 2, 9][:k]
    for n in sorted({0, hot, hot + 1, S} & set(range(S + 1))):
        node = torch.full((S,), -1, dtype=torch.int32)
        node[torch.randperm(S, generator=torch.Generator().manual_seed(n))
             [:n]] = 7
        runs = torch.zeros(16, dtype=torch.int64)
        n_active = torch.full((), -5, dtype=torch.int32)
        ran = program.choose_ref(tk.Choice(node, k, hot), runs, bids,
                                 n_active)
        want = 0 if n == 0 else (1 if hot and n <= hot else k - 1)
        assert ran.tolist() == [int(b == want) for b in range(k)], (S, n)
        expect = torch.zeros(16, dtype=torch.int64)
        expect[bids[want]] = 1
        assert torch.equal(runs, expect) and int(n_active) == n, (S, n)


def test_choose_ref_of_a_cond():
    """A cond's group: its one branch runs, and is counted, where the
    bool holds; nothing is counted where it does not."""
    runs = torch.zeros(4, dtype=torch.int64)
    for b, want in ((True, [1]), (False, [0])):
        ran = program.choose_ref(tk.Choice(torch.tensor(b), 1), runs, [3])
        assert ran.tolist() == want
    assert runs.tolist() == [0, 0, 0, 1]
