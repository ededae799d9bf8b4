"""The event flood as one device program (``gossip/program.py``'s
``EventProgram``, ``gossip/events.py``, ``round_args.build_events``),
checked on the CPU.

- The event table: every column of ``build_events`` (the F gossip shifts
  and the push/pull partner under ``fold_in(fold_in(key, 7), rnd)``)
  against ``jax.random``, over rounds and widths; the one-row scalar
  builds (``build``, ``build_events`` at one row, ``build_pools`` at one
  step) equal to the vectorised builds bit for bit.
- The device-row event round (the eager loop, which reads its round and
  shifts from a table row and floods through ``event_flood_ref``)
  against the reference's ``run_event_rounds`` (JAX on the CPU) over 160
  rounds: every field and the coverage trace, bit-identical, with
  push/pull rounds, slot GC and reuse and fires past the last free slot.
- ``EventProgram``'s buffers with its captures replaced by an emulation
  (each replay runs the captured body on the buffers), in table chunks:
  equal to the eager route, one host read a call.
- The replay check: every op a replayed event round runs is logged with
  its non-tensor arguments, and the flood's by-value arguments; rounds of
  one variant log the same, whatever their round numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from consul_tpu.gossip import events as je
from consul_tpu.gossip import params as j_params
from consul_tpu_torch import prng
from consul_tpu_torch.gossip import events as te
from consul_tpu_torch.gossip import kernel as tk
from consul_tpu_torch.gossip import params as t_params
from consul_tpu_torch.gossip import program, round_args


@pytest.fixture(autouse=True, scope="module")
def _quick_reference_compiles():
    """The reference compiled with XLA's optimisations off (the same
    integers, quicker)."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


# -- the table -----------------------------------------------------------------

@pytest.mark.parametrize("profile, n", [("lan_profile", 1000),
                                        ("lan_profile", 4001),
                                        ("wan_profile", 12)])
def test_event_columns_match_jax_random(profile, n):
    p = getattr(t_params, profile)(n)
    rnd0, steps, seed = 147, 5, 9
    tbl = round_args.build_events(p, prng.key(seed), rnd0, steps)
    lay = round_args.event_layout(p.fanout)
    assert tbl.shape == (steps, lay.width) and tbl.dtype == np.int32
    for k in range(steps):
        rnd = rnd0 + k
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), 7), rnd)
        offs = np.asarray(jax.random.randint(key, (p.fanout,), 1, n,
                                             dtype=jnp.int32))
        o = int(jax.random.randint(jax.random.fold_in(key, 9), (), 1, n,
                                   dtype=jnp.int32))
        assert tbl[k, round_args.RND] == rnd
        assert np.array_equal(tbl[k, 1:1 + p.fanout], offs)
        assert tuple(tbl[k, lay.pp:lay.pp + 2]) == (o, -o)
        ea = round_args.event_args(p.fanout, torch.from_numpy(tbl[k]))
        assert ea.gossip.tolist() == offs.tolist() and int(ea.rnd) == rnd


@pytest.mark.parametrize("profile, n, kw", [
    ("lan_profile", 250_000, {}), ("lan_profile", 1000, {"slots": 16}),
    ("wan_profile", 12, {}), ("lan_profile", 77, {"pushpull_every": 3})])
def test_scalar_rows_equal_vectorised_rows(profile, n, kw):
    """A one-row build takes the scalar path on Python ints; it equals
    the vectorised build's row, for round rows (with a flight ring),
    event rows and the pools' rows, across int32's top."""
    p = getattr(t_params, profile)(n, **kw)
    for seed in (0, 5, 2**31 - 1):
        key = prng.key(seed)
        for rnd0 in (0, 149, 2**31 - 6):
            vec = round_args.build(p, key, rnd0, 5, 250, 256)
            ev = round_args.build_events(p, key, rnd0, 5)
            for k in range(5):
                assert np.array_equal(vec[k], round_args.build(
                    p, key, rnd0 + k, 1, 250 + k, 256)[0])
                assert np.array_equal(ev[k], round_args.build_events(
                    p, key, rnd0 + k, 1)[0])
    keys = prng.split(prng.key(3), 3)
    for events in (False, True):
        pools = round_args.build_pools(p, keys, [3, 40, 7], 6, events)
        build = round_args.build_events if events else round_args.build
        for j, r0 in enumerate([3, 40, 7]):
            assert np.array_equal(pools[j], build(p, keys[j], r0, 6))
            for k in range(6):
                assert np.array_equal(pools[j, k],
                                      build(p, keys[j], r0 + k, 1)[0])
    with pytest.raises(OverflowError):
        round_args.build_events(p, prng.key(0), 2**31 - 2, 3)


# -- the device-row event round against the reference --------------------------

# name -> (profile, n, slots, params, dead fraction, {chunk: fires}).
# Four chunks of 40 rounds; fires with -1 entries, repeated nodes and
# more events than slots (drops), slots freed by their TTL and fired
# into again.
CHUNK, CHUNKS = 40, 4
CASES = {
    "pushpull_E8": ("lan_profile", 3000, 8, dict(pushpull_every=4), 0.1,
                    {0: [5, 900, 17, 17, -1, 2999], 2: list(range(10, 22))}),
    "no_pushpull_E64": ("lan_profile", 2048, 64, dict(pushpull_every=0),
                        0.0, {0: list(range(0, 2048, 29)),
                              3: [1, 2, 3]}),
    "odd_n_E16": ("lan_profile", 4001, 16, dict(pushpull_every=7), 0.05,
                  {0: [4000, 0, 7], 1: [2000], 3: list(range(30))}),
    "wan_E16": ("wan_profile", 500, 16, dict(pushpull_every=5), 0.1,
                {0: [3, 499], 2: [250, -1, 3]}),
}


def _event_inputs(case):
    profile, n, E, kw, dead, fires = CASES[case]
    rng = np.random.default_rng(len(case) + n)
    alive = rng.random(n) >= dead
    for nodes in fires.values():
        alive[[i for i in nodes if i >= 0][:1]] = True
    return profile, n, E, kw, alive, fires


def _port_events(case, graphed_program=False):
    profile, n, E, kw, alive, fires = _event_inputs(case)
    p = getattr(t_params, profile)(n, **kw)
    st = te.init_events(p, slots=E, device="cpu")
    al = torch.from_numpy(alive)
    covs = []
    for c in range(CHUNKS):
        if c in fires:
            st = te.fire_events(st, torch.tensor(fires[c], dtype=torch.int32))
        if graphed_program:
            st, cov = program.run_event_rounds(st, prng.key(11), al, p, CHUNK)
        else:
            st, cov = te.run_event_rounds(st, prng.key(11), al, p, CHUNK,
                                          graphed=False)
        covs.append(cov)
    return st, torch.cat(covs)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_row_event_round_matches_reference(case):
    profile, n, E, kw, alive, fires = _event_inputs(case)
    jp = getattr(j_params, profile)(n, **kw)
    js = je.init_events(jp, slots=E)
    ja = jnp.asarray(alive)
    jcovs = []
    for c in range(CHUNKS):
        if c in fires:
            js = je.fire_events(js, jnp.asarray(fires[c], jnp.int32))
        js, cov = je.run_event_rounds(js, jax.random.PRNGKey(11), ja, jp,
                                      CHUNK)
        jcovs.append(np.asarray(cov))
    ts, tcov = _port_events(case)
    for f in je.EventState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), (case, f)
    jc = np.concatenate(jcovs)
    assert jc.dtype == tcov.numpy().dtype
    assert np.array_equal(jc, tcov.numpy()), case
    # Not vacuous: drops, GC'd slots, coverage that rose.
    tp = getattr(t_params, profile)(n, **kw)
    assert CHUNK * CHUNKS > tp.event_ttl_rounds
    assert tcov.max() > 0.9
    if case == "no_pushpull_E64":
        assert int(ts.drops) > 0


@pytest.mark.parametrize("pushpull", [False, True])
def test_event_round_writes_into_dst(pushpull):
    """The one event-round body (``events._event_round``) with ``dst`` and
    ``held``, as the event program runs it: the written fields of ``dst``
    (``ROUND_WRITES``) and ``held`` hold the round in place, equal to the
    round into new tensors; the fields it only reads are the source's."""
    profile, n, E, kw, alive, fires = _event_inputs("pushpull_E8")
    p = getattr(t_params, profile)(n, **kw)
    src = te.fire_events(te.init_events(p, slots=E, device="cpu"),
                         torch.tensor(fires[0], dtype=torch.int32))
    row = torch.from_numpy(round_args.build_events(
        p, prng.key(5), int(src.round), 1)[0])
    al = torch.from_numpy(alive)
    want, want_held = te._event_round(src, row, al, p, pushpull)
    dst = src._replace(**{f: torch.empty_like(getattr(src, f))
                          for f in te.ROUND_WRITES})
    held = torch.empty(E, dtype=torch.int32)
    got, got_held = te._event_round(src, row, al, p, pushpull, dst=dst,
                                    held=held)
    assert got_held is held and torch.equal(held, want_held)
    for f in te.EventState._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
        same = getattr(dst if f in te.ROUND_WRITES else src, f)
        assert getattr(got, f).data_ptr() == same.data_ptr(), f
    assert int(got.round) == int(src.round) + 1


# -- the program's buffers, its captures emulated ------------------------------

class _EmulatedGraph:
    """A replay on the CPU: the captured body runs on the buffers."""

    def __init__(self, prog, v):
        self.prog, self.v = prog, v

    def launch(self):
        self.prog._body(self.v)
        program.launches += 1

    def close(self):
        pass


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(program._Program, "_capture",
                        lambda self, v: _EmulatedGraph(self, v))
    monkeypatch.setattr(program, "TABLE_ROWS", 7)  # chunks of a call
    monkeypatch.setattr(program, "_programs", type(program._programs)())


@pytest.mark.parametrize("case", ["pushpull_E8", "wan_E16"])
def test_program_buffers_match_eager(case, emulated):
    eager = _port_events(case)
    syncs, launches, floods = tk.host_syncs, program.launches, te.launches
    graphed = _port_events(case, graphed_program=True)
    assert tk.host_syncs - syncs == CHUNKS       # one read a call
    assert program.launches - launches == CHUNK * CHUNKS
    (a, ca), (b, cb) = eager, graphed
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), (case, f)
    assert torch.equal(ca, cb)
    assert te.launches == floods  # CPU tensors: the plain version


@pytest.mark.parametrize("steps", [[7, 8, 1, 10], [2, 9, 9, 3]])
def test_program_buffer_sets_after_odd_and_even_steps(steps, emulated):
    """Calls of odd and even round counts (within and across the table's
    chunks of 7): the state a call returns and its coverage trace equal the
    eager route's and the reference's after every call, whichever buffer
    set holds it; each call starts from set 0."""
    profile, n, E, kw, alive, fires = _event_inputs("pushpull_E8")
    p = getattr(t_params, profile)(n, **kw)
    jp = getattr(j_params, profile)(n, **kw)
    al = torch.from_numpy(alive)
    st = te.fire_events(te.init_events(p, slots=E, device="cpu"),
                        torch.tensor(fires[0], dtype=torch.int32))
    eager = graphed = st
    js = je.fire_events(je.init_events(jp, slots=E),
                        jnp.asarray(fires[0], jnp.int32))
    prog = None
    for k in steps:
        eager, ce = te.run_event_rounds(eager, prng.key(3), al, p, k,
                                        graphed=False)
        graphed, cg = program.run_event_rounds(graphed, prng.key(3), al, p, k)
        js, cj = je.run_event_rounds(js, jax.random.PRNGKey(3),
                                     jnp.asarray(alive), jp, k)
        prog = prog or next(iter(program._programs.values()))
        assert prog.cur == k % 2
        assert torch.equal(ce, cg) and np.array_equal(np.asarray(cj),
                                                      cg.numpy())
        for f in te.EventState._fields:
            assert torch.equal(getattr(eager, f), getattr(graphed, f)), (k, f)
            assert np.array_equal(np.asarray(getattr(js, f)),
                                  getattr(graphed, f).numpy()), (k, f)
    assert len(program._programs) == 1


def test_replay_copies_no_event_matrix(emulated, monkeypatch):
    """No replayed event round copies an [E, N] tensor: the flood writes
    the other set's ``has`` itself, and the two sets' matrices alternate
    as the round's source and destination."""
    rounds = []
    body = program.EventProgram._body

    def logged(self, v):
        src, dst = self.sets[v[1]].has, self.sets[1 - v[1]].has
        with _OpLog() as log:
            body(self, v)
        rounds.append((v, src.data_ptr(), dst.data_ptr(), log.ops))

    monkeypatch.setattr(program.EventProgram, "_body", logged)
    profile, n, E, kw, alive, fires = _event_inputs("wan_E16")
    p = getattr(t_params, profile)(n, **kw)
    st = te.fire_events(te.init_events(p, slots=E, device="cpu"),
                        torch.tensor(fires[0], dtype=torch.int32))
    program.run_event_rounds(st, prng.key(1), torch.from_numpy(alive), p, 9)
    assert len(rounds) == 9
    big = ("T", "torch.uint8", (E, n))
    for i, (v, src, dst, ops) in enumerate(rounds):
        assert v[1] == i % 2 and src != dst
        copies = [op for op in ops if "copy" in op[0] and big in op[1]]
        assert not copies, (i, copies)
        # The flood's last op on the matrix writes the destination set.
        assert (("out", big),) in [op[2] for op in ops
                                   if "where" in op[0]], i
    assert {r[1] for r in rounds} == {r[2] for r in rounds}


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


def test_replay_logs_do_not_depend_on_the_round(emulated, monkeypatch):
    """Per replayed event round: its variant (push/pull and the parity of
    the buffer set it reads) and its op log (with the flood's by-value
    arguments).  Rounds of one variant log the same."""
    rounds = []
    body = program.EventProgram._body

    def logged(self, v):
        te.launch_log = []
        with _OpLog() as log:
            body(self, v)
        rounds.append((v, log.ops + te.launch_log))
        te.launch_log = None

    monkeypatch.setattr(program.EventProgram, "_body", logged)
    _port_events("pushpull_E8", graphed_program=True)
    groups = {}
    for i, (v, log) in enumerate(rounds):
        groups.setdefault(v, []).append((i, log))
    # Push/pull every 4 rounds from round 0 of a call: its rounds read
    # set 1 (the 4th, 8th, ...), the others either set.
    assert set(groups) == {(False, 0), (False, 1), (True, 1)}
    for v, members in groups.items():
        first_i, first = members[0]
        for i, log in members[1:]:
            assert log == first, f"rounds {first_i} and {i} of {v}"
    assert len(rounds) == CHUNK * CHUNKS
    for _, log in rounds:
        floods = [e for e in log if e[0] == "event_flood"]
        assert len(floods) == 1
