"""The SWIM round as replayed CUDA graphs: ``RoundProgram``, the
counterpart of the reference's ``jax.jit(run_rounds)``.

The reference runs ``steps`` rounds as one device program: a ``lax.scan``
whose round counter is traced, with every branch a ``lax.cond`` on the
device (``consul_tpu/gossip/kernel.py``: the join tick, the quiescent /
hot / full tail).  Here one round is captured once per ``Variant`` (the
branches on the round number alone; at most ``kernel.MAX_VARIANTS``), and
a call runs each chunk of up to ``TABLE_ROWS`` rounds as two launches:

- The table kernel (``round_table.py``, ``csrc/round_table.cu``) writes
  the chunk's argument table into the program's buffer: every scalar a
  round derives from its number (``round_args.py``'s layout) and its
  variant's code (``kernel.variant_code``), a row a round; it also sets
  the chunk's rounds left (``left``) and the row counter ``step`` to 0.
  The round reads row ``step``, which the round advances.
- One launch of the loop graph (``_Loop``, ``csrc/round_graph.cu``): a
  WHILE node whose body is the loop kernel and then ``LOOP_ROUNDS`` round
  slots (U), each one SWITCH node whose bodies are the captured variants'
  joined rounds.  The slot rule: an iteration's loop kernel takes m =
  min(U, ``left``) rounds and gives slot u < m the body of the variant
  that the table's column names at row ``step`` + u (the rounds advance
  ``step``), the slots past m none, and keeps the loop going while rounds
  are left; so a chunk of n rounds runs ceil(n / U) loop kernels
  (``loop_kernels``).  The fault rule: a code the loop was not built with
  ends it at that slot (the slots before it run, ``left`` goes to 0, the
  code is counted), and ``settle`` raises.  The host mirrors the chunk's
  variants (numpy on the round numbers, ``kernel.variant_codes``): a
  variant the chunk needs is captured first, and the loop built again when
  the set grows.  With ``replays`` (a check's plain version of the loop) a
  chunk is a replay a round of the variant's joined graph instead;
  ``loop_ref`` is the plain version of one launch of the loop itself.
- The round's ``lax.cond``s are conditional graph nodes
  (``csrc/round_graph.cu``): the capture is cut into segments at each
  branch (``_Recorder``), each a graph captured by PyTorch into one shared
  memory pool, and the segments are joined in capture order, each branch
  body under an IF node.  The IF nodes of one branch group (the tail's
  switch, the join tick's cond: ``_Group``) follow one chooser node, which
  makes the group's choice on the card (``kernel.Choice``; for the tail
  from ``slot_node``, writing the live slots' count into the program's
  ``n_active``), sets the group's conditions and counts the taken branch's
  run.  A branch writes its result into the program's buffers, so what
  follows reads the same memory whichever branch ran.
- The program owns static buffers for everything the round reads and
  writes: the state, the ground-truth rounds, the banks, NemState, the
  flight ring, the trace rows and the table.  A round updates them in
  place (the tail's branches write the new state straight into them), so
  replays chain with no copy between rounds; a call copies its inputs in
  and clones the results out, once each.
- Before a variant is captured, one eager round of it runs on copies of
  the buffers with every branch taken (``_Warm``), so each kernel has been
  built, loaded and launched once and the capture only records.

Counting.  The kernel wrappers count a launch when they are called, which
under capture is once per captured launch.  The program keeps those counts
per segment and puts the counters back as they were; each replay, or each
chunk of a loop for each variant times its rounds, then adds the
unconditional segments' launches (and the chooser nodes,
``choose_launches``, and the loop kernels, ``loop_launches``) on the host;
each group's chooser node adds one to the taken branch's device counter
(``branch_runs``) and the loop kernel one a round to its variant's and
one to its own (``loop_runs``).  ``settle_counts()`` reads those counters
(one read, outside any round), adds the branch bodies' launches and
``kernel.tail_rounds`` to the host counters, and raises if the loop ran
other rounds, or another number of loop kernels, than the host sent it.

The event round (``EventProgram``, the counterpart of
``jax.jit(run_event_rounds)``) is the same machinery with no branch: a
round that reads its row of the call's event table and floods through
``csrc/event_flood.cu`` from one set of state buffers into the other, one
capture per push/pull variant and parity.  Programs are
cached by configuration (``program_for``, at most ``MAX_PROGRAMS``); a
caller that runs several pools at once (``multidc.MultiDCProgram``) owns
its programs instead, outside that cache (``own``/``disown``), so that
each pool keeps its state in its own buffers.

A capture, a loop build or a launch that fails raises; on a card there
is no fallback to per-round replays or to the eager round.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import sys
import time
import warnings

import numpy as np
import torch

from consul_tpu_torch import _build, prng
from consul_tpu_torch.gossip import (events, finish, finish_slots, fused,
                                     kernel, observe, probe, round_args,
                                     round_table)
from consul_tpu_torch.gossip.kernel import (RoundTrace, _I32, _leaves,
                                            _round_once, round_variant)

TABLE_ROWS = 512     # rounds of argument table on the card: a call's chunk
MAX_BRANCHES = 64    # branch bodies a program counts (4 a variant at most)
MAX_PROGRAMS = 8     # programs kept (each holds its buffers and its pool)
# The loop's device counters: rounds run a variant code, then its faults,
# the last faulty code and the loop kernel's runs (csrc/round_graph.cu's
# Loop::runs).
LOOP_WORDS = kernel.VARIANT_CODES + 3
# Round slots a WHILE iteration of the program's loop (PERF.md: at 4
# slots the toy loop's round is faster than at 8 over the plane's 4-round
# chunk and 3-25% slower over 512 rounds, real rounds run as fast on the
# card as at 8, and the host's launch of the loop graph grows with slots
# times variants), and the most the loop's form takes
# (csrc/round_graph.cu's kMaxSlots).
LOOP_ROUNDS = 4
MAX_SLOTS = 8

# Graph launches (a chunk's loop, or one replayed round), captures, their
# seconds and the memory the captures reserved.
launches = 0
captures = 0
capture_s = 0.0
pool_bytes = 0
# Bytes of u8 matrices (a round's belief matrix or its shards; an event
# program's ``has``) that ``_copy_leaves`` copied: a call's load of the
# state, and in a replayed round the branch bodies' results that are not
# already the buffers (the full tail's matrix; the quiescent and hot
# branches and the join tick write the buffers in place and copy none).
copy_bytes = 0
# Chooser-node runs (``csrc/round_graph.cu``'s choose_kernel): one a branch
# group a replay, and one a ``choose`` on a card.  Replays of a round
# program, and of those the ones with a join group: every replayed round
# runs its tail's chooser, and its join tick's where it has one.
choose_launches = 0
round_replays = 0
join_replays = 0
# The loop (csrc/round_graph.cu): loop_kernel nodes run (one a WHILE
# iteration: ``loop_kernels(n)`` for a chunk of n rounds), loop graphs
# built (one a program, again each time a call meets a variant it had not
# captured) and the builds' seconds.
loop_launches = 0
loop_builds = 0
loop_build_s = 0.0
# Rounds run through the loop (of ``round_replays``, which counts every
# replayed or looped round).
looped_rounds = 0

# Host counters the kernel wrappers (and ``_copy_leaves``) keep,
# attributed per captured segment.
_COUNTERS = ((prng, "launches"), (prng, "calls"), (fused, "launches"),
             (fused, "merge_launches"), (fused, "drop_launches"),
             (fused, "merge_drop_launches"), (events, "launches"),
             (observe, "launches"), (finish, "launches"),
             (finish, "fire_launches"), (finish, "wipe_launches"),
             (probe, "launches"), (probe, "lanes_slots_launches"),
             (probe, "rearm_marks_launches"),
             (finish_slots, "launches"), (finish_slots, "decide_launches"),
             (finish_slots, "settle_launches"),
             (finish_slots, "record_launches"),
             (sys.modules[__name__], "copy_bytes"))

_VP = ctypes.c_void_p
MAX_GROUP = 3  # kMaxBranches: a group's branches


class _Choice(ctypes.Structure):
    """``round_graph::Choice``: a chooser node's arguments (the handles
    are made by the build)."""
    _fields_ = [("operand", _VP), ("n_active", _VP), ("runs", _VP),
                ("s", ctypes.c_int), ("hot", ctypes.c_int),
                ("k", ctypes.c_int), ("bid", ctypes.c_int * MAX_GROUP),
                ("handle", ctypes.c_uint64 * MAX_GROUP)]


class _Join(ctypes.Structure):
    """``RoundJoin``: one variant's joined round inside the loop."""
    _fields_ = [("segs", ctypes.POINTER(_VP)),
                ("group_of", ctypes.POINTER(ctypes.c_int)),
                ("n", ctypes.c_int), ("choices", _VP),
                ("n_groups", ctypes.c_int), ("code", ctypes.c_int)]


class _LoopArgs(ctypes.Structure):
    """``round_graph::Loop``: the loop node's arguments (the build fills
    the lookup and makes the handles; ``round_graph_loop_build`` also the
    variants, form and codes)."""
    _fields_ = [("left", _VP), ("step", _VP), ("variant", _VP),
                ("runs", _VP), ("rows", ctypes.c_int), ("n", ctypes.c_int),
                ("u", ctypes.c_int), ("ifs", ctypes.c_int),
                ("code", ctypes.c_int * kernel.VARIANT_CODES),
                ("body", ctypes.c_int * kernel.VARIANT_CODES),
                ("handle", (ctypes.c_uint64 * kernel.VARIANT_CODES)
                 * MAX_SLOTS),
                ("loop", ctypes.c_uint64)]


def set_argtypes(lib):
    """Types ``csrc/round_graph.cu``'s entry points in ``lib`` (the card's
    build, or a host build of the same source)."""
    out = [ctypes.POINTER(_VP), ctypes.POINTER(_VP)]
    ci = ctypes.c_int
    lib.round_graph_build.argtypes = [ctypes.POINTER(_VP),
                                      ctypes.POINTER(ci), ci, _VP, ci, *out]
    lib.round_graph_loop_build.argtypes = [_VP, ci, _VP, *out]
    lib.round_graph_loop_toy.argtypes = [_VP, _VP, *out]
    lib.round_graph_nest.argtypes = [_VP, ci, *out]
    lib.round_graph_launch.argtypes = [_VP, _VP]
    lib.round_graph_destroy.argtypes = [_VP, _VP]
    lib.round_graph_edges.argtypes = [_VP, _VP, _VP, ctypes.POINTER(ci),
                                      *out]
    lib.round_graph_choice.argtypes = [_VP, _VP, *out]
    lib.round_graph_dot.argtypes = [_VP, ctypes.c_char_p]
    for fn in (lib.round_graph_build, lib.round_graph_loop_build,
               lib.round_graph_loop_toy, lib.round_graph_nest,
               lib.round_graph_launch,
               lib.round_graph_destroy, lib.round_graph_edges,
               lib.round_graph_choice, lib.round_graph_dot):
        fn.restype = ci
    lib.round_graph_error.argtypes = [ci]
    lib.round_graph_error.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib():
    return set_argtypes(_build.load("round_graph"))


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{_lib().round_graph_error(rc).decode()}")


def _counts() -> tuple:
    return tuple(getattr(m, a) for m, a in _COUNTERS)


def _set_counts(values) -> None:
    for (m, a), v in zip(_COUNTERS, values):
        setattr(m, a, v)


def _add_counts(deltas, times: int = 1) -> None:
    _set_counts(c + d * times for c, d in zip(_counts(), deltas))


def _copy_leaves(dst, src) -> None:
    """Each tensor of ``src`` into its buffer of ``dst``, but for those
    that are the buffer already (a result written in place)."""
    global copy_bytes
    d, s = _leaves(dst), _leaves(src)
    if len(d) != len(s):
        raise RuntimeError(f"a branch gave {len(s)} tensors for {len(d)} "
                           f"buffers")
    for a, b in zip(d, s):
        if a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride()):
            continue
        a.copy_(b)
        if a.dtype == torch.uint8 and a.dim() == 2:
            copy_bytes += a.numel()


class _Warm:
    """``kernel._recorder`` during the warm-up round: every branch runs
    (on copies of the buffers), the last one's result goes on."""

    def when(self, pred, fn, operand):
        return fn(operand)

    def switch(self, choice, branches, names, dst):
        out = None
        for fn in branches:
            out = fn()
        return out, kernel.choice_ref(choice)[1]


class _Group:
    """One branch group of a captured round: its choice
    (``kernel.Choice``), the buffer its chooser writes the live slots'
    count into (a switch's; None for a cond) and the branches' indices
    into the program's ``branch_runs``, in order."""

    def __init__(self, choice, n_active=None):
        op = choice.operand
        want = torch.bool if choice.k == 1 else _I32
        if op.dtype != want or not op.is_contiguous() or (
                choice.k == 1 and op.numel() != 1):
            raise ValueError(f"a group of {choice.k} branches takes a "
                             f"contiguous {want} operand, got "
                             f"{op.dtype}{list(op.shape)}")
        if not 1 <= choice.k <= MAX_GROUP:
            raise ValueError(f"a group has 1 to {MAX_GROUP} branches")
        self.choice, self.n_active = choice, n_active
        self.bids: list = []

    def args(self, runs) -> _Choice:
        """The chooser node's arguments, counting into ``runs``."""
        c = self.choice
        return _Choice(c.operand.data_ptr(),
                       None if self.n_active is None
                       else self.n_active.data_ptr(),
                       None if runs is None else runs.data_ptr(),
                       c.operand.numel() if c.k > 1 else 0, c.hot, c.k,
                       (ctypes.c_int * MAX_GROUP)(*self.bids))


class _Recorder:
    """``kernel._recorder`` during a capture: the round as segment graphs,
    cut at each branch (see the module docstring)."""

    def __init__(self, program):
        self.program = program
        self.segs = []    # (graph, group or None, branch id, deltas)
        self._open = None

    def begin(self, group=None, bid=None) -> None:
        g = torch.cuda.CUDAGraph(keep_graph=True)
        # Thread-local: another thread's CUDA calls (the plane's server)
        # neither break this capture nor are refused by it.
        g.capture_begin(pool=self.program.pool,
                        capture_error_mode="thread_local")
        self._open = (g, group, bid, _counts())

    def end(self) -> None:
        g, group, bid, c0 = self._open
        self._open = None
        with warnings.catch_warnings():
            # A segment between two branches may hold nothing: joined as
            # an empty node (csrc/round_graph.cu).
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            g.capture_end()
        self.segs.append((g, group, bid,
                          tuple(b - a for a, b in zip(c0, _counts()))))

    def abort(self) -> None:
        """End an open capture after a failure (its graph is dropped)."""
        if self._open is not None:
            g, self._open = self._open[0], None
            try:
                g.capture_end()
            except RuntimeError:
                pass

    def _body(self, group, name, fn, dst) -> None:
        bid = self.program.new_branch(name)
        group.bids.append(bid)
        self.end()
        self.begin(group, bid)
        _copy_leaves(dst, fn())
        self.end()
        self.begin()

    def when(self, pred, fn, operand):
        self._body(_Group(kernel.Choice(pred, 1)), "join",
                   lambda: fn(operand), operand)
        return operand

    def switch(self, choice, branches, names, dst):
        group = _Group(choice, self.program.n_active)
        for fn, name in zip(branches, names):
            self._body(group, name, fn, dst)
        return dst, self.program.n_active


class _Graph:
    """One variant's joined graph and what its launches count.  ``segs``:
    ``(segment graph, group or None, branch id, counter deltas)`` in
    capture order; ``runs``: the branch counters the chooser nodes add
    to."""

    def __init__(self, segs, runs=None):
        self.segs = segs  # keeps the segment graphs (their pool), operands
        self.groups = []
        for _, grp, _, _ in segs:
            if grp is not None and all(grp is not q for q in self.groups):
                self.groups.append(grp)
        at = {id(q): i for i, q in enumerate(self.groups)}
        # The build's arguments, kept for the loop's (``join``).
        self._segs = (_VP * len(segs))(*(g.raw_cuda_graph()
                                         for g, *_ in segs))
        self._group_of = (ctypes.c_int * len(segs))(*(
            -1 if grp is None else at[id(grp)] for _, grp, _, _ in segs))
        self._choices = (_Choice * max(1, len(self.groups)))(
            *(q.args(runs) for q in self.groups))
        self.graph, self.exec = _VP(), _VP()
        _check(_lib().round_graph_build(self._segs, self._group_of,
                                        len(segs),
                                        ctypes.cast(self._choices, _VP),
                                        len(self.groups),
                                        ctypes.byref(self.graph),
                                        ctypes.byref(self.exec)),
               "joining the round's graph")
        self.plain = tuple(map(sum, zip(*(d for _, grp, _, d in segs
                                          if grp is None))))
        self.branch = {bid: d for _, grp, bid, d in segs if grp is not None}

    def launch(self) -> None:
        global launches, choose_launches
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().round_graph_launch(self.exec, stream),
               "launching the round's graph")
        _add_counts(self.plain)
        choose_launches += len(self.groups)
        launches += 1

    def join(self, code: int) -> _Join:
        """This round as the loop joins it, under variant code ``code``."""
        return _Join(self._segs, self._group_of, len(self.segs),
                     ctypes.cast(self._choices, _VP), len(self.groups), code)

    def described(self, path) -> dict:
        """The joined graph's own nodes as the runtime describes them
        (``round_graph_dot``, written to ``path``: its first cluster is the
        graph itself, the others its child graphs): kernel nodes, those of
        ``choose_kernel`` and conditional nodes; and whether
        ``set_condition`` appears anywhere.  (The card's runtime reads no
        conditional node's type through ``cudaGraphNodeGetType``: error
        999.)"""
        _check(_lib().round_graph_dot(self.graph, str(path).encode()),
               "describing the round's graph")
        with open(path) as f:
            text = f.read()
        own = text.split("subgraph cluster_")[1]
        return {"kernel": own.count("{KERNEL"),
                "chooser": own.count("choose_kernel"),
                "conditional": own.count("CONDITIONAL"),
                "set_condition": "set_condition" in text}

    def close(self) -> None:
        if self.exec:
            _check(_lib().round_graph_destroy(self.graph, self.exec),
                   "destroying the round's graph")
            self.graph, self.exec = _VP(), _VP()


class _Loop:
    """A program's loop graph (``csrc/round_graph.cu``): its captured
    variants' joined rounds ``graphs`` (``{code: _Graph}``), each in every
    one of the ``LOOP_ROUNDS`` round slots' SWITCH nodes, under one WHILE
    node, the loop kernel reading the program's rounds left (``left``), row
    counter (``step``) and variant column (``variant``) and counting into
    ``runs`` (``LOOP_WORDS`` int64)."""

    def __init__(self, graphs: dict, left, step, variant, runs):
        global loop_builds, loop_build_s
        t0 = time.perf_counter()
        codes = sorted(graphs)
        joins = (_Join * len(codes))(*(graphs[c].join(c) for c in codes))
        # The loop node's arguments, its handles written back by the build.
        self.args = _LoopArgs(left.data_ptr(), step.data_ptr(),
                              variant.data_ptr(), runs.data_ptr(),
                              variant.numel(), 0, LOOP_ROUNDS)
        self.codes = frozenset(codes)
        self.graph, self.exec = _VP(), _VP()
        _check(_lib().round_graph_loop_build(
            ctypes.cast(joins, _VP), len(codes),
            ctypes.addressof(self.args), ctypes.byref(self.graph),
            ctypes.byref(self.exec)),
            "building the round's loop")
        loop_builds += 1
        loop_build_s += time.perf_counter() - t0

    def launch(self) -> None:
        """One chunk's rounds (one graph launch, counted in ``launches``)."""
        global launches
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().round_graph_launch(self.exec, stream),
               "launching the round's loop")
        launches += 1

    def close(self) -> None:
        if self.exec:
            _check(_lib().round_graph_destroy(self.graph, self.exec),
                   "destroying the round's loop")
            self.graph, self.exec = _VP(), _VP()


def loop_kernels(steps: int, u: int = LOOP_ROUNDS) -> int:
    """Loop kernels a looped call of ``steps`` rounds runs: one a WHILE
    iteration of ``u`` round slots, ceil(n / u) for each chunk of n
    rounds (chunks of ``TABLE_ROWS``; a call of none launches no loop)."""
    full, last = divmod(steps, TABLE_ROWS)
    return full * -(-TABLE_ROWS // u) + -(-last // u)


def loop_ref(codes, variant, left, step, runs=None,
             u: int = LOOP_ROUNDS) -> list:
    """The plain version of one launch of the loop (``_Loop``; its loop
    kernel, ``csrc/round_graph.cu``), ``u`` round slots an iteration: each
    iteration takes m = min(u, ``left``) rounds (``left`` int32 [1]), slot
    k < m running the body of the code that the column ``variant`` names
    at ``step`` + k (``step`` int64 [1]), its run counted in ``runs``
    (``LOOP_WORDS`` int64, or None) and ``step`` advanced as the round
    advances it; the loop goes on while rounds are left.  A code not among
    ``codes`` ends the loop at its slot: the slots before it run, it and
    those after it do not, ``left`` goes to 0 and the fault and the code
    are counted.  Every iteration counts its loop kernel, the first one
    too when ``left`` holds none.  Returns the indices into ``codes`` of
    the bodies taken, a list an iteration (a host read a round: a check's
    plain version)."""
    V = kernel.VARIANT_CODES
    iterations = []
    while True:
        n, s = int(left), int(step)
        taken, fault = [], False
        for k in range(min(u, max(n, 0))):
            r = s + k
            code = int(variant[r]) if 0 <= r < variant.numel() else -1
            if code not in codes:
                fault = True
                if runs is not None:
                    runs[V] += 1
                    runs[V + 1] = code
                break
            taken.append(codes.index(code))
            if runs is not None:
                runs[code] += 1
        if n > 0:
            left.fill_(0 if fault else n - len(taken))
        if runs is not None:
            runs[V + 2] += 1
        step.add_(len(taken))
        iterations.append(taken)
        if fault or int(left) <= 0:
            return iterations


class Chooser:
    """One group's chooser node alone, on a card, as the round's graph
    places it (``round_graph_choice``): the node, then the group's k IF
    nodes, branch b's body adding one to ``ran[b]``.  ``launch()`` chooses
    on the operand as it then is (and counts in ``choose_launches``)."""

    def __init__(self, choice, runs, bids, n_active=None):
        group = _Group(choice, n_active)
        group.bids = list(bids)
        if len(group.bids) != choice.k:
            raise ValueError(f"{choice.k} branches need as many run indices")
        dev = choice.operand.device
        self.ran = torch.zeros(choice.k, dtype=_I32, device=dev)
        self.group, args = group, group.args(runs)
        self.graph, self.exec = _VP(), _VP()
        _check(_lib().round_graph_choice(ctypes.byref(args),
                                         self.ran.data_ptr(),
                                         ctypes.byref(self.graph),
                                         ctypes.byref(self.exec)),
               "building a chooser's graph")

    def launch(self) -> None:
        global choose_launches
        stream = torch.cuda.current_stream().cuda_stream
        _check(_lib().round_graph_launch(self.exec, stream),
               "launching a chooser")
        choose_launches += 1

    def close(self) -> None:
        if self.exec:
            _check(_lib().round_graph_destroy(self.graph, self.exec),
                   "destroying a chooser's graph")
            self.graph, self.exec = _VP(), _VP()


def choose_ref(choice, runs, bids, n_active=None) -> torch.Tensor:
    """The plain version of a group's chooser node: the choice
    (``kernel.choice_ref``), one added to ``runs[bids[which]]`` where a
    branch is taken, the live slots' count into ``n_active`` where given
    (a switch's).  Returns the runs of the group's branches, int32 [k]:
    one 1 at the branch taken, or none."""
    which, n = kernel.choice_ref(choice)
    ran = (torch.arange(choice.k, device=which.device) == which).to(_I32)
    if runs is not None:
        for b, bid in enumerate(bids):
            runs[bid:bid + 1].add_(ran[b:b + 1])
    if n_active is not None and n is not None:
        n_active.copy_(n)
    return ran


def choose(choice, runs, bids, n_active=None) -> torch.Tensor:
    """A group's choice, as the round's chooser node makes it: on a card
    one launch of the node (``Chooser``: its graph built, launched once and
    freed), its plain version ``choose_ref`` on CPU tensors.  ``runs``: an
    int64 counter vector (None: not counted), ``bids`` the branches' indices
    into it, ``n_active`` an int32 word for a switch's count (or None).
    Returns the runs of the group's branches, int32 [k], new."""
    if choice.operand.device.type == "cpu":
        return choose_ref(choice, runs, bids, n_active)
    one = Chooser(choice, runs, bids, n_active)
    try:
        one.launch()
        return one.ran.clone()
    finally:
        one.close()


def _clone(tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_clone(x) for x in tree)) if hasattr(
        tree, "_fields") else tuple(_clone(x) for x in tree)


class _Program:
    """Static buffers and one captured graph per variant; a subclass
    defines ``_warm(v)`` (one round of variant ``v`` on copies of the
    buffers, every branch taken) and ``_body(v)`` (one round that reads
    and writes the buffers), which ``_capture`` records.  ``pool``: the
    captures' memory pool, shared by the programs of one caller (every
    result lies in the programs' own buffers, outside the pool, so nothing
    in the pool outlives a replay); None makes one at the first capture."""

    def __init__(self, dev, pool=None):
        self.dev = dev
        self.pool = pool
        # The chooser nodes' runs of each branch body, then the loop's
        # counters: one buffer, which ``settle`` reads at once.
        self._runs = torch.zeros(MAX_BRANCHES + LOOP_WORDS,
                                 dtype=torch.int64, device=dev)
        self.branch_runs = self._runs[:MAX_BRANCHES]
        self.loop_runs = self._runs[MAX_BRANCHES:]
        # The rounds of each variant code the host sent through the loop
        # since the last settle, and the loop kernels it counted for them,
        # which the loop's counts must equal.
        self.looped = [0] * kernel.VARIANT_CODES
        self.loop_kernels = 0
        # The tail's live slots, written by its chooser node a replay.
        self.n_active = torch.zeros((), dtype=_I32, device=dev)
        self.branch_names: list = []
        self.graphs: dict = {}
        self.pool_bytes = 0  # what this program's captures reserved

    def new_branch(self, name: str) -> int:
        if len(self.branch_names) == MAX_BRANCHES:
            raise RuntimeError("too many captured branch bodies")
        self.branch_names.append(name)
        return len(self.branch_names) - 1

    def _capture(self, v) -> _Graph:
        """Warm variant ``v`` up and capture it."""
        global captures, capture_s, pool_bytes
        t0 = time.perf_counter()
        counts = _counts()
        kernel._recorder = _Warm()
        try:
            self._warm(v)
        finally:
            kernel._recorder = None
            _set_counts(counts)
        torch.cuda.synchronize(self.dev)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        reserved = torch.cuda.memory_reserved(self.dev)
        rec = _Recorder(self)
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        kernel._recorder = rec
        try:
            with torch.cuda.stream(side):
                rec.begin()
                self._body(v)
                rec.end()
        except BaseException:
            rec.abort()
            raise
        finally:
            kernel._recorder = None
            _set_counts(counts)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = _Graph(rec.segs, self.branch_runs)
        grown = torch.cuda.memory_reserved(self.dev) - reserved
        pool_bytes += grown
        self.pool_bytes += grown
        captures += 1
        capture_s += time.perf_counter() - t0
        return graph

    def graph(self, v) -> _Graph:
        g = self.graphs.get(v)
        if g is None:
            g = self.graphs[v] = self._capture(v)
        return g

    def replay(self, v) -> None:
        """One round of variant ``v`` (captured at its first replay)."""
        self.graph(v).launch()

    def settle(self) -> None:
        """Add the branch bodies' counts since the last settle to the
        host counters (one device read, none without branches); raise if
        the loop ran other rounds than the host sent it (a variant code it
        was not built with, or other counts), or another number of loop
        kernels than the host counted."""
        if not self.branch_names:
            return
        words = self._runs.tolist()
        self._runs.zero_()
        runs, loop = words[:len(self.branch_names)], words[MAX_BRANCHES:]
        for g in self.graphs.values():
            for bid, deltas in g.branch.items():
                _add_counts(deltas, runs[bid])
        for name, n in zip(self.branch_names, runs):
            if name in kernel.tail_rounds:
                kernel.tail_rounds[name] += n
            elif name == "join":
                kernel.join_rounds += n
        looped, self.looped = self.looped, [0] * kernel.VARIANT_CODES
        iterations, self.loop_kernels = self.loop_kernels, 0
        V = kernel.VARIANT_CODES
        if loop[V]:
            raise RuntimeError(f"the round's loop met variant code "
                               f"{loop[V + 1]}, which it was not built with "
                               f"({loop[V]} times)")
        if loop[:V] != looped:
            raise RuntimeError(f"the round's loop ran {loop[:V]} rounds a "
                               f"variant code, the host sent {looped}")
        if loop[V + 2] != iterations:
            raise RuntimeError(f"the round's loop ran {loop[V + 2]} loop "
                               f"kernels, the host counted {iterations}")

    def close(self) -> None:
        for g in self.graphs.values():
            g.close()
        self.graphs.clear()


class RoundProgram(_Program):
    """The captured rounds of one configuration: parameters, nemesis
    schedule, shard count and which of the join rounds, flight ring,
    banks, NemState and trace are threaded.  ``run`` is ``run_rounds``;
    a caller that interleaves programs (``multidc.MultiDCProgram``) uses
    ``load``, fills ``table`` and ``step`` (``round_table.fill``), and
    uses ``replay`` and ``result``."""

    def __init__(self, p, nem, sc, dev, state, fail_round, join_round,
                 flight, hist, nem_state, trace: bool, pool=None):
        super().__init__(dev, pool)
        self.p, self.nem, self.sc = p, nem, sc
        z = functools.partial(torch.zeros, device=dev)
        # The buffers (outside the pool): filled by each call.
        self.state = _clone(state)
        self.fail = fail_round.clone()
        self.join = None if join_round is None else join_round.clone()
        self.hist = _clone(hist)
        self.nem_state = _clone(nem_state)
        self.rows = None if flight is None else flight.rows.clone()
        lay = round_args.layout(p.fanout, p.indirect_k)
        self.table = z((TABLE_ROWS, lay.width), dtype=_I32)
        self.step = z(1, dtype=torch.int64)
        # The table's variant column and the chunk's rounds left, both
        # written by the table kernel, read by the loop (``self.loop``).
        self.variant = z(TABLE_ROWS, dtype=_I32)
        self.left = z(1, dtype=_I32)
        self.loop = None
        self.trace = ([z((TABLE_ROWS, p.slots), dtype=_I32)
                       for _ in RoundTrace._fields] if trace else None)
        self.dst = (self.state, self.hist, self.nem_state)
        # The observers' kernel's scratch: the program's own, zero between
        # its launches, which run one at a time on its stream; and the
        # probe tick's, which every round leaves as it found it.
        self.obs_scratch = observe.counts_scratch(p.slots, dev)
        self.probe_scratch = probe.scratch(p, dev)

    def _round(self, v, **bufs):
        return _round_once(self.p, self.table, bufs.get("step", self.step),
                           bufs.get("state", self.state), v,
                           self.fail, self.join,
                           bufs.get("hist", self.hist),
                           bufs.get("nem_state", self.nem_state), self.sc,
                           self.nem, bufs.get("rows", self.rows),
                           bufs.get("trace", self.trace),
                           bufs.get("dst"), self.obs_scratch,
                           probe_scratch=self.probe_scratch)

    def _warm(self, v) -> None:
        self._round(v, step=self.step.clone(),
                    state=_clone(self.state), hist=_clone(self.hist),
                    nem_state=_clone(self.nem_state),
                    rows=_clone(self.rows), trace=_clone(self.trace))

    def _body(self, v) -> None:
        self._round(v, dst=self.dst)

    def replay(self, v) -> None:
        """One round of variant ``v``: its tail's chooser runs, and its
        join tick's where the program has a join round."""
        global round_replays, join_replays
        super().replay(v)
        round_replays += 1
        join_replays += self.join is not None

    def load(self, state, fail_round, join_round=None, flight=None,
             hist=None, nem_state=None) -> None:
        """Copy a call's inputs into the buffers."""
        _copy_leaves(self.state, state)
        self.fail.copy_(fail_round)
        if self.join is not None:
            self.join.copy_(join_round)
        _copy_leaves(self.hist, hist)
        _copy_leaves(self.nem_state, nem_state)
        if flight is not None:
            self.rows.copy_(flight.rows)

    def result(self):
        """New tensors of the buffers: ``(state, rows, hist, nem_state)``."""
        return (_clone(self.state), _clone(self.rows), _clone(self.hist),
                _clone(self.nem_state))

    def run(self, state, base_key, fail_round, steps, join_round, flight,
            hist, nem_state, replays: bool = False):
        """``steps`` rounds from ``state``: ``(state, rows, hist,
        nem_state, trace columns)``, new tensors.  Two host reads (the
        round counter, the flight cursor); each chunk of up to
        ``TABLE_ROWS`` rounds is one fill of the table (``round_table``)
        and, on a card, one launch of the loop (``replays``: a replay a
        round instead, the loop's plain version, for a check)."""
        p = self.p
        self.load(state, fail_round, join_round, flight, hist, nem_state)
        rnd0 = kernel._host_int(state.round)
        cur, R = 0, 1
        if flight is not None:
            R = self.rows.shape[0]
            cur = kernel._host_int(flight.cursor)
        round_args._check_rounds(rnd0, steps)
        chunks = []
        for done in range(0, steps, TABLE_ROWS):
            n = min(TABLE_ROWS, steps - done)
            round_table.fill([round_table.Job(
                p, base_key, rnd0 + done, self.table, variant=self.variant,
                nem=self.nem, left=self.left, step=self.step,
                cursor=cur + done, ring=R)], n)
            self._rounds(kernel.variant_codes(p, self.nem, rnd0 + done, n),
                         replays)
            if self.trace is not None:
                chunks.append([b[:n].clone() for b in self.trace])
        tr = None
        if self.trace is not None:
            tr = [torch.cat(c) if c else
                  torch.zeros((0, p.slots), dtype=_I32, device=self.dev)
                  for c in (zip(*chunks) if chunks else [()] * 6)]
        return (*self.result(), tr)

    def _rounds(self, codes: np.ndarray, replays: bool) -> None:
        """A chunk's rounds from the table's first row, ``codes`` their
        variants as the host's mirror gives them: on a card one launch of
        the loop, whose counts the host adds here (each variant's
        unconditional launches times its rounds; the branch bodies' at
        ``settle``); with ``replays``, or off a card (the tests' emulated
        captures), a replay a round."""
        global choose_launches, loop_launches, round_replays, join_replays
        global looped_rounds
        if replays or self.dev.type != "cuda":
            for c in codes.tolist():
                self.replay(kernel.variant_of(c))
            return
        uniq, count = np.unique(codes, return_counts=True)
        self._looped(uniq.tolist()).launch()
        for c, m in zip(uniq.tolist(), count.tolist()):
            g = self.graphs[kernel.variant_of(c)]
            _add_counts(g.plain, m)
            choose_launches += len(g.groups) * m
            self.looped[c] += m
        iterations = loop_kernels(len(codes))
        self.loop_kernels += iterations
        loop_launches += iterations
        looped_rounds += len(codes)
        round_replays += len(codes)
        join_replays += len(codes) * (self.join is not None)

    def _looped(self, codes) -> _Loop:
        """The loop over every captured variant, ``codes`` among them:
        those missing are captured first, and the loop is built again
        when that adds one."""
        for c in codes:
            self.graph(kernel.variant_of(c))
        have = {kernel.variant_code(v): g for v, g in self.graphs.items()}
        if self.loop is None or self.loop.codes != set(have):
            if self.loop is not None:
                self.loop.close()
                self.loop = None
            self.loop = _Loop(have, self.left, self.step, self.variant,
                              self.loop_runs)
        return self.loop

    def close(self) -> None:
        if self.loop is not None:
            self.loop.close()
            self.loop = None
        super().close()


class EventProgram(_Program):
    """The captured event rounds of one configuration (the counterpart of
    ``jax.jit(run_event_rounds)``): the round's row read from the call's
    event table at ``step``, its flood one launch of
    ``csrc/event_flood.cu``.  Liveness is a buffer (``run_event_rounds``'
    ``alive``) or, with ``fail`` set, ``fail > round`` from the pool's own
    round counter before the round (the multi-DC pools); with ``cov`` the
    round's coverage row goes to the ``[TABLE_ROWS, E]`` trace buffer.

    Two sets of state buffers: a round reads set ``cur`` and the flood
    writes the other straight (the fields a round does not change, the
    slots' Lamport times, start rounds and drops, are one tensor in both),
    so no round copies ``has``.  So each push/pull variant is captured
    once per parity, ``(pushpull, cur)``; ``replay`` flips ``cur`` and
    ``state`` is the set the last round wrote.  A call's ``load`` fills set
    0."""

    def __init__(self, p, dev, state, alive=None, fail=None,
                 cov: bool = True, pool=None):
        super().__init__(dev, pool)
        self.p = p
        z = functools.partial(torch.zeros, device=dev)
        first = _clone(state)
        self.sets = (first, first._replace(**{
            f: getattr(first, f).clone() for f in events.ROUND_WRITES}))
        self.cur = 0
        self.alive = None if alive is None else alive.clone()
        self.fail = None if fail is None else fail.clone()
        E, N = state.has.shape
        self.table = z((TABLE_ROWS, round_args.event_layout(p.fanout).width),
                       dtype=_I32)
        self.step = z(1, dtype=torch.int64)
        self.cov = z((TABLE_ROWS, E), dtype=torch.float32) if cov else None
        self.held = z(E, dtype=_I32)  # the round's live holders a slot
        self.scratch = events.flood_scratch(E, N, dev)

    @property
    def state(self):
        """The buffers of the state after the last round."""
        return self.sets[self.cur]

    def _round(self, pushpull: bool, src, dst, step, cov, held,
               scratch) -> None:
        """One event round from row ``step``: reads state ``src`` and
        writes ``dst`` (the two sets, or their copies while warming up)."""
        row = self.table.index_select(0, step)[0]
        alive = self.alive if self.fail is None else self.fail > src.round
        events._event_round(src, row, alive, self.p, pushpull, dst=dst,
                            held=held, scratch=scratch)
        if cov is not None:
            cov.index_copy_(0, step, events._coverage_of(held, alive)[None])
        step.add_(1)

    def _warm(self, v) -> None:
        pushpull, cur = v
        self._round(pushpull, _clone(self.sets[cur]),
                    _clone(self.sets[1 - cur]), self.step.clone(),
                    _clone(self.cov), self.held.clone(),
                    self.scratch.clone())

    def _body(self, v) -> None:
        pushpull, cur = v
        self._round(pushpull, self.sets[cur], self.sets[1 - cur], self.step,
                    self.cov, self.held, self.scratch)

    def capture(self, pushpull: bool) -> None:
        """Capture variant ``pushpull`` at both parities."""
        for cur in (0, 1):
            self.graph((pushpull, cur))

    def replay(self, pushpull: bool) -> None:
        """One round of variant ``pushpull``, from set ``cur``."""
        super().replay((pushpull, self.cur))
        self.cur = 1 - self.cur

    def load(self, state, alive=None, fail=None) -> None:
        self.cur = 0
        _copy_leaves(self.sets[0], state)
        if alive is not None:
            self.alive.copy_(alive)
        if fail is not None:
            self.fail.copy_(fail)

    def run(self, state, base_key, alive, steps):
        """``steps`` event rounds from ``state``: ``(state, cov)``, new
        tensors.  One host read (the round counter); a chunk's table from
        one fill (``round_table``)."""
        p = self.p
        self.load(state, alive)
        rnd0 = kernel._host_int(state.round)
        covs = []
        for done in range(0, steps, TABLE_ROWS):
            n = min(TABLE_ROWS, steps - done)
            round_table.fill([round_table.Job(
                p, base_key, rnd0 + done, self.table, events=True,
                step=self.step)], n)
            for k in range(n):
                self.replay(events.is_pushpull(p, rnd0 + done + k))
            covs.append(self.cov[:n].clone())
        cov = (torch.cat(covs) if covs else
               torch.zeros((0, self.cov.shape[1]), dtype=torch.float32,
                           device=self.dev))
        return _clone(self.state), cov


_programs: collections.OrderedDict = collections.OrderedDict()
# Programs a caller owns (each multi-DC program's pools), outside the
# cache: ``settle_counts`` reads them too.
_owned: list = []


def _cached(key, make) -> _Program:
    """The cached program under ``key`` (``make()`` on first use; the
    least recently used of more than ``MAX_PROGRAMS`` is closed)."""
    prog = _programs.get(key)
    if prog is None:
        prog = _programs[key] = make()
        while len(_programs) > MAX_PROGRAMS:
            _, old = _programs.popitem(last=False)
            old.settle()
            old.close()
    _programs.move_to_end(key)
    return prog


def program_for(p, nem, sc, dev, state, fail_round, join_round, flight,
                hist, nem_state, trace: bool) -> RoundProgram:
    """The cached program of this configuration (built on first use; the
    least recently used of more than ``MAX_PROGRAMS`` is closed)."""
    key = (p, nem, sc, str(dev), join_round is not None,
           None if flight is None else tuple(flight.rows.shape),
           hist is not None, nem_state is not None, bool(trace))
    return _cached(key, lambda: RoundProgram(
        p, nem, sc, dev, state, fail_round, join_round, flight, hist,
        nem_state, trace))


def run_rounds(state, base_key, fail_round, p, steps, trace, join_round,
               flight, hist, sc, nem, nem_state):
    """``kernel.run_rounds`` (and ``run_rounds_sharded``, ``sc`` set) on a
    card, through the configuration's ``RoundProgram``; the arguments are
    on the card already."""
    prog = program_for(p, nem, sc, fail_round.device, state, fail_round,
                       join_round, flight, hist, nem_state, trace)
    st, rows, hb, ns, tr = prog.run(state, base_key, fail_round, steps,
                                    join_round, flight, hist, nem_state)
    return kernel._carry(st, flight, rows, steps, hb, ns), (
        None if tr is None else RoundTrace(*tr))


def run_event_rounds(state, base_key, alive, p, steps):
    """``events.run_event_rounds`` on a card, through the configuration's
    ``EventProgram``; the arguments are on the card already."""
    key = ("events", p, str(alive.device), tuple(state.has.shape))
    prog = _cached(key, lambda: EventProgram(p, alive.device, state,
                                             alive=alive))
    return prog.run(state, base_key, alive, steps)


def own(prog: _Program) -> None:
    """Count a caller's program in ``settle_counts``."""
    _owned.append(prog)


def disown(prog: _Program) -> None:
    """Settle, close and forget a caller's program."""
    prog.settle()
    prog.close()
    _owned[:] = [q for q in _owned if q is not prog]


def settle_counts() -> None:
    """Fold every program's device-side branch counts into the host
    counters (``prng``'s, ``fused``'s, ``events``', ``observe``'s,
    ``finish``'s, ``probe``'s and ``finish_slots``' launches,
    ``copy_bytes``, ``kernel.tail_rounds`` and
    ``kernel.join_rounds``); a reader of those counters calls this
    first."""
    for prog in list(_programs.values()) + _owned:
        prog.settle()
