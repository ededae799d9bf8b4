"""Where a round's time goes: the port's main path, timed and profiled.

    python -m consul_tpu_torch.profile_round [--churn-ppm 1000] [--rounds 30]
                                             [--ndev N] [--nemesis SCENARIO]
                                             [--eager] [--observers]
                                             [--observer-fn FN=OBSERVER]
                                             [--functions]
                                             [--round-fn FN=NAME]
    python -m consul_tpu_torch.profile_round --multidc [--ndev 8]
    python -m consul_tpu_torch.profile_round --split [--rounds 30]

Runs bench.py's LAN regime on the card (``lan_profile(N, SLOTS,
hot_slots=0)``, churn failures on a stride) for ``WARM`` rounds, then
twice ``--rounds`` more and prints one JSON line for the graphed round
(``gossip/program.py``: replayed CUDA graphs, the main path): host time a
round, device busy time, kernels and graph launches a round, the idle
share, the captures, their seconds and the graphs' pool bytes, and the
loop's builds, their host seconds and the card memory they took.  The
round's Python phases do not run in a replay, so the graphed line has no
phase rows.  ``--eager`` also profiles the eager round in the same call
(an A/B on one card) and prints its line after, with the phases below.
``--observers`` threads the flight ring, the hist banks and the trace
through the rounds, as the plane's dispatch does, and then attributes
the observers' device time: a third line, from ``--rounds`` eager rounds
under the profiler, gives each observer its device ms and kernels a
round and its kernels by name.  The observers' own kernel
(``csrc/observe.cu``) goes by its name: the spread's instance
(``<true>``, a verdict given; the want-masked one before the kernel's
redesign) is the hist banks' spread, the other the final matrix's, which
serves the flight row's dissemination bytes ``tx`` and the trace's
holders at once.  Any other kernel goes by the torch op that launched it,
which a dispatch mode runs under a profiler range naming the innermost
frame of ``gossip/kernel.py`` whose function is an observer's (those
``--observer-fn FN=OBSERVER`` names: a checkout whose observers are torch
ops in closures of their own names them so, and one that lacks a named
function is refused).  The rest is the round's, the banks' adds among it:
they run inside the finish step's record kernel
(``csrc/finish_slots.cu``).
``--functions`` attributes the round itself the same way, on another
line: ``--rounds`` rounds of the round program's own body
(``gossip/program.py``'s ``RoundProgram``) run eagerly, each branch taken
on a host read of its predicate and its result copied into the program's
buffers as the replayed conditional node does, so that its kernels are
the graph's; each kernel goes to the innermost function of
``ROUND_FUNCTIONS`` on the stack of the torch op that launched it: the
join tick, the probe tick, the finish step, push/pull, the copies into
the buffers (``program._copy_leaves``) and the rest of
``_swim_round_impl``, and those ``--round-fn FN=NAME`` adds (an older
checkout's closures, for an A/B: parent, change, change, parent; a
name the checkout lacks is refused); the hand kernels, launched through
ctypes and tied to no op by the profiler, go by their names
(``ROUND_KERNELS``: ``csrc/probe.cu``'s to the probe tick,
``csrc/finish_slots.cu``'s to the finish step, the draws', the wipe's and
the others' to labels of their own).
With ``--ndev N`` the
rounds are the sharded round (``run_rounds_sharded``, N column shards on
the card), and the phases add the sharded round's own: the halo pins
(``_roll_sharded``: the push/pull rounds' rolls only, the card's merge
reads its pins from the shards) and the merge kernel's launches
(``fused_merge``, one per round for all shards).  The single-device
round adds the launches of ``fused_dissem``.  With ``--nemesis`` the
rounds run under that scenario of the nemesis catalog
(``gossip/nemesis.py``; its kills join the churn failures), and the
profiled rounds lie inside its fault window (the warm-up ends at round
60; every scenario's window is open from round 40 to 160): the phase
``nemesis_drops`` is the partition's drop masks (their threefry draws
included), and ``dissem_launches``/``merge_launches`` the kernel launches,
each with its drop operand.

- pass A, no profiler: host time per round (the call, then a read that
  waits for the card), and the host time and the
  calls per round of each round phase (the probe tick, whose draws are
  made inside ``csrc/probe.cu``'s lanes_slots kernel; the uniform draws and
  the compared draws (``prng.below``), on a card each a launch of
  ``csrc/threefry.cu``, which no round of the main path makes now; the
  dissemination tail, the finish step, the kernel wrappers), each phase
  timed by a host clock around the round's own function; a kernel
  wrapper's host time over its calls is its host cost per launch;
- pass B, under torch.profiler, over pass A's rounds again from the same
  carry: the device kernels' time per round (busy
  time), each phase's device time (the kernels launched inside it), the
  number of kernels per round, the port's own kernels' calls and device
  time per round (``hand_kernels``: the draws', the tail's, the probe
  tick's and the others, which the profiler leaves out of the phases'
  device time), and the ops and kernels that take the most device
  time.

The device's idle share is ``1 - busy(B) / host time(A)``.  Phases are
timed by wrapping the round's functions for the duration of a pass; the
round's code is not changed.  Needs one CUDA card.

``--multidc`` profiles the multi-DC round instead (bench.py's regime:
4 DCs of N / 4 nodes, 3 servers each, 32 event slots, one event fired,
N / 4000 failures per DC on a stride; ``--ndev`` shards each DC's LAN
pool): the graphed route (``multidc.MultiDCProgram``) and then the eager
one in one process, each ``WARM`` rounds and then passes A and B of
``--rounds`` rounds in one call each: host ms a round, device busy ms a
round and idle share, device kernels and graph launches a round, the
flood's and the tail's kernels a round, and the host ms of the call's
table: the host's build (``multidc._tables``) on the eager route, the
table kernel's fill (``round_table.fill``) on the graphed one.

``--split`` splits the host time of a graphed call (``run_rounds`` on the
card, the flight ring, hist banks and trace threaded, as the plane runs
it) by part, on four paths in turn (churn, healthy, 8 shards and
``partition_heal``, each as the flags above would run it): ``SPLIT``'s
parts of ``gossip/program.py``'s call (the inputs' load, the results'
clones, the two host reads, the table: a host build and its copy, or the
table kernel's fill; the host's mirror of the variants; the graph
launches; per round the host's variant choice and its counters' adds;
captures and loop builds), each the host time of the functions named
(found by name, so a checkout without one times none: the split runs on
an older checkout too), exclusive of the parts called inside it, and
``rest``, the call's host time the parts leave (the trace's chunks and
their join, the entry point's own work).  ``SPLIT_CALLS`` calls of
``--rounds`` rounds after the warm-up, whose rounds are first run once
untimed (every variant they meet captured before them); each part's ms
a call and a round.
A line a path, with the graphed route's profile (``profile_route``)
beside the split.
"""

from __future__ import annotations

import argparse
import collections
import copy
import importlib
import inspect
import json
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from consul_tpu_torch import prng
from consul_tpu_torch.gossip import events, fused, kernel, program
from consul_tpu_torch.gossip import multidc as md
from consul_tpu_torch.gossip.nemesis import build as build_nemesis
from consul_tpu_torch.gossip.params import lan_profile

N, SLOTS, WARM = 1_000_000, 64, 60  # the main path's size; warm-up rounds
PHASES = {  # label -> (module, attribute) of the function timed
    "probe_tick": (kernel, "_probe_tick"),
    "uniform_draws": (prng, "uniform_tensor"),
    "below_draws": (prng, "below"),
    "disseminate": (kernel, "_disseminate"),
    "finish_round": (kernel, "_finish_round"),
    "nemesis_drops": (kernel, "_nem_edge_drops"),
}
SINGLE_PHASES = {  # the single-device round's own
    "dissem_launches": (fused, "fused_dissem"),
}
# The port's own kernels, by a part of their device names: the profiler
# does not tie a launch made through ctypes to the phase around it, so
# their device time is read from the kernel rows.
HAND_KERNELS = {"draws": "threefry::draw_kernel",
                "tail": "dissem_tail::tail_kernel",
                "conditions": "round_graph::choose_kernel",
                "loop": "round_graph::loop_kernel",
                "table": "round_table::table_kernel",
                "flood": "evflood::flood_kernel",
                "observe": "observe::counts_kernel",
                "finish": "finish::",
                "finish_slots": "finish_slots::",
                "probe": "probe::"}
SHARDED_PHASES = {  # the sharded round's own, inside the phases above
    "halo_pins": (fused, "_roll_sharded"),
    "merge_launches": (fused, "fused_merge"),
}


def timed(fn, device, iters: int = 4, warmup: int = 1) -> float:
    """Seconds per call of ``fn()`` on ``device``: CUDA events around
    ``iters`` warm calls on a card, the host clock on the CPU."""
    dev = torch.device(device)
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _timed(label, fn, acc):
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            s, n = acc.get(label, (0.0, 0))
            acc[label] = (s + time.perf_counter() - t0, n + 1)
    return wrapped


def _annotated(label, fn, acc):
    def wrapped(*a, **kw):
        with record_function(label):
            return fn(*a, **kw)
    return wrapped


def _device_us(evt) -> float:
    for name in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def self_device_us(evt) -> float:
    """A profiler row's own device time, microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def fresh_loops() -> None:
    """Have every cached round program build its loop graph again at its
    next call, once a profiler session has run in this process.  On the
    H100 a loop instantiated before the process's first profiler session
    shows each of its nodes to the profiler once a launch, whatever its
    rounds; one instantiated after a session shows every round's.  A
    profile of looped calls calls this, then runs a call, first."""
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    for prog in list(program._programs.values()):
        if getattr(prog, "loop", None) is not None:
            prog.loop.close()
            prog.loop = None


def device_kernels(prof, exclude=()) -> list:
    """The profile's device kernels (``key_averages`` rows on the card,
    except the labels in ``exclude``), busiest first."""
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in exclude),
                  key=lambda e: -self_device_us(e))


def device_timeline(prof, exclude=()) -> tuple:
    """The device's occupied time in the profile ``prof``, microseconds:
    the union of its device events' spans (kernels and copies; not the
    labels in ``exclude`` nor the observers' ranges).  Two kernels overlap
    where one was launched programmatically behind the other (the finish
    step's decide behind the tail, its span including its wait), so the
    busy time, a sum of durations, counts that time twice; this one counts
    it once.  Returns ``(occupied, exclusive, duration)``: ``exclusive``
    maps a device event's name to the us of its spans that no event
    started earlier covers (their sum is ``occupied``), ``duration`` to
    its spans' whole length."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.name not in exclude
                   and not e.name.startswith(_LABEL))
    busy, until, exclusive, duration = 0.0, float("-inf"), {}, {}
    for start, end, name in spans:
        own = max(0.0, end - max(start, until))
        exclusive[name] = exclusive.get(name, 0.0) + own
        duration[name] = duration.get(name, 0.0) + end - start
        busy += own
        until = max(until, end)
    return busy, exclusive, duration


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--churn-ppm", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--ndev", type=int, default=0,
                    help="profile the sharded round on this many shards")
    ap.add_argument("--nemesis", default="",
                    help="run the rounds under this nemesis catalog "
                         "scenario, profiling rounds inside its window")
    ap.add_argument("--eager", action="store_true",
                    help="also profile the eager round (A/B, one call)")
    ap.add_argument("--observers", action="store_true",
                    help="thread the flight ring, hist banks and trace "
                         "through the rounds, as the plane does")
    ap.add_argument("--observer-fn", action="append", default=[],
                    metavar="FN=OBSERVER",
                    help="with --observers, also attribute the torch ops "
                         "of gossip/kernel.py's function (or closure) FN "
                         "to OBSERVER")
    ap.add_argument("--functions", action="store_true",
                    help="attribute the round's device time by function "
                         "(the round program's body run eagerly)")
    ap.add_argument("--round-fn", action="append", default=[],
                    metavar="FN=NAME",
                    help="with --functions, also attribute the torch ops "
                         "of gossip/kernel.py's function (or closure) FN "
                         "to NAME")
    ap.add_argument("--multidc", action="store_true",
                    help="profile the multi-DC round, graphed and eager")
    ap.add_argument("--split", action="store_true",
                    help="split a graphed call's host time by part, on "
                         "churn, healthy, 8 shards and partition_heal")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA card")
    if args.split:
        for name, over in SPLIT_PATHS.items():
            a = copy.copy(args)
            a.observers = True
            for k, v in over.items():
                setattr(a, k, v)
            res = profile_route(a, True)
            res.update(path=name, split=profile_split(a))
            print(json.dumps(res), flush=True)
        return 0
    if args.multidc:
        for graphed in (True, False):
            print(json.dumps(profile_multidc(args, graphed)), flush=True)
        return 0
    for graphed in (True, False) if args.eager else (True,):
        print(json.dumps(profile_route(args, graphed)), flush=True)
    if args.observers:
        print(json.dumps(profile_observers(args)), flush=True)
    if args.functions:
        print(json.dumps(profile_functions(args)), flush=True)
    return 0


def profile_multidc(args, graphed: bool) -> dict:
    """One route of the multi-DC round (the module docstring)."""
    dev = torch.device("cuda")
    D = 4
    n_lan = N // D
    p = md.make_params(D, n_lan, n_servers=3, event_slots=32, slots=SLOTS,
                       lan_devices=args.ndev)
    R = args.rounds
    total = WARM + 2 * R
    n_fail = max(1, n_lan // 1000)
    lan_fail = np.full((D, n_lan), kernel.NEVER, np.int32)
    s0 = p.n_servers
    lan_fail[:, s0:s0 + n_fail] = ((np.arange(n_fail, dtype=np.int64)
                                    * total) // n_fail)[None, :]
    lan_fail_t = torch.from_numpy(lan_fail).to(dev)
    wan_fail_t = torch.full((D * s0,), kernel.NEVER, dtype=torch.int32,
                            device=dev)
    key = prng.key(42)
    # A call's tables: the host's build (the eager route's ``_tables``) or
    # the table kernel's fill (the graphed route's).
    table_s = []
    builds = {(md, "_tables"): md._tables}
    if hasattr(md, "round_table"):
        builds[md.round_table, "fill"] = md.round_table.fill

    def timed(fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            table_s.append(time.perf_counter() - t0)
            return out
        return call

    def run(st, steps):
        st, _ = md.run_multidc_rounds(st, key, lan_fail_t, wan_fail_t, p,
                                      steps, device=dev, graphed=graphed)
        int(st.wan.round)
        torch.cuda.synchronize()
        return st

    captures0, capture_s0 = program.captures, program.capture_s
    for (mod, attr), fn in builds.items():
        setattr(mod, attr, timed(fn))
    try:
        state = run(md.fire_in_dc(md.init_multidc(p, device=dev), 0, 7, p),
                    WARM)
        program.settle_counts()
        table_s.clear()
        counts0 = (prng.launches, program.launches, kernel.host_syncs,
                   events.launches, fused.launches + fused.merge_launches)
        t0 = time.perf_counter()
        state = run(state, R)
        wall_a = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state = run(state, R)
    finally:
        for (mod, attr), fn in builds.items():
            setattr(mod, attr, fn)
    program.settle_counts()
    d_draws, d_graphs, d_syncs, d_floods, d_tails = (
        b - a for a, b in zip(counts0, (
            prng.launches, program.launches, kernel.host_syncs,
            events.launches, fused.launches + fused.merge_launches)))
    kernels = device_kernels(prof)
    busy_us = sum(self_device_us(e) for e in kernels)
    span_us = device_timeline(prof)[0]
    res = {
        "device": torch.cuda.get_device_name(dev),
        "route": "graphed" if graphed else "eager", "multidc": True,
        "n": N, "dcs": D, "n_lan": n_lan, "slots": SLOTS,
        "lan_devices": args.ndev or None, "warm_rounds": WARM, "rounds": R,
        "host_ms_per_round": wall_a * 1e3 / R,
        "device_busy_ms_per_round": busy_us / 1e3 / R,
        "device_span_ms_per_round": span_us / 1e3 / R,
        "device_idle_share": 1 - busy_us / 1e6 / wall_a,
        "device_span_idle_share": 1 - span_us / 1e6 / wall_a,
        "device_kernels_per_round": sum(e.count for e in kernels) / R,
        "graph_launches_per_round": d_graphs / (2 * R),
        "host_syncs_per_round": d_syncs / (2 * R),
        "flood_launches_per_round": d_floods / (2 * R),
        "tail_launches_per_round": d_tails / (2 * R),
        "draw_launches_per_round": d_draws / (2 * R),
        "table_host_ms_per_call": 1e3 * sum(table_s) / len(table_s),
        "table_route": "table kernel" if graphed else "host build",
        "captures": program.captures - captures0,
        "capture_s": program.capture_s - capture_s0,
        "pool_bytes": ([prog.pool_bytes for prog in md._programs.values()]
                       if graphed else None),
        "hand_kernels": {
            label: {"calls_per_round": sum(e.count for e in rows) / R,
                    "device_ms_per_round":
                        sum(self_device_us(e) for e in rows) / 1e3 / R}
            for label, name in HAND_KERNELS.items()
            for rows in [[e for e in kernels if name in e.key]]},
        "top_kernels": [{"kernel": e.key[:90], "calls_per_round": e.count / R,
                         "device_ms_per_round": self_device_us(e) / 1e3 / R}
                        for e in kernels[:8]],
    }
    md.close_programs()
    torch.cuda.empty_cache()
    return res


# The observers' kernel's instances (csrc/observe.cu): <true> is the
# spread's launch (a verdict given; in older checkouts, the want-masked
# one: the same launch), <false> the final matrix's.
OBSERVER_KERNELS = (("observe::counts_kernel<true>", "spread"),
                    ("observe::counts_kernel<false>", "tx_and_trace_holders"))
# Functions of gossip/kernel.py whose torch ops are one observer's: none
# since the hist banks' adds run inside the finish step's record kernel
# (``csrc/finish_slots.cu``), which the observers' line leaves to the
# round; an older checkout names its ``_hist_add`` with ``--observer-fn
# _hist_add=hist_adds``.
OBSERVER_FUNCTIONS: dict = {}
_LABEL = "observer:"


def _kernel_functions() -> set:
    """The names of gossip/kernel.py's functions, closures included."""
    todo = [c for c in (getattr(inspect.unwrap(f), "__code__", None)
                        for f in vars(kernel).values() if callable(f))
            if c is not None and c.co_filename == kernel.__file__]
    names = set()
    while todo:
        code = todo.pop()
        names.add(code.co_name)
        todo += [c for c in code.co_consts if inspect.iscode(c)]
    return names


def _named_functions(base: dict, pairs, flag: str,
                     present: set) -> dict:
    """``base`` with the ``FN=NAME`` pairs given by ``flag``; raises for
    a name that is not in ``present``."""
    out = dict(base)
    for pair in pairs:
        fn, sep, name = pair.partition("=")
        if not (fn and sep and name):
            raise SystemExit(f"profile_round: {flag} takes FN=NAME, "
                             f"got {pair!r}")
        out[fn] = name
    missing = sorted(set(out) - present)
    if missing:
        raise SystemExit(f"profile_round: the tree has no function "
                         f"{missing}")
    return out


def _label_of(frame, functions: dict, files: tuple):
    """The label of the innermost frame, from ``frame`` outward, of a
    function in ``files`` whose name ``functions`` maps, or None."""
    while frame is not None:
        code = frame.f_code
        if code.co_filename in files and code.co_name in functions:
            return functions[code.co_name]
        frame = frame.f_back
    return None


def _observer_mode(functions: dict, files: tuple = (kernel.__file__,)):
    """A dispatch mode that runs each torch op under a profiler range
    naming the observer (or, with ``--functions``, the round's function)
    whose code calls it: the innermost frame of ``files`` (the kernel
    module), from the op outward, whose function ``functions`` names."""
    from torch.utils._python_dispatch import TorchDispatchMode

    def observer(frame):
        return _label_of(frame, functions, files)

    class Labels(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = observer(sys._getframe(1))
            if name is None:
                return func(*args, **(kwargs or {}))
            with record_function(_LABEL + name):
                return func(*args, **(kwargs or {}))

    return Labels()


def _observer_of(op, kernel_name: str, by_name=OBSERVER_KERNELS,
                 names_first: bool = True) -> str:
    """The observer a device kernel is one of (``op``: the CPU op that
    launched it, or None for a launch no op made), or ``round``: by the
    kernel's name (``by_name``) and by the labelled ranges around ``op``,
    the name first or, with ``names_first`` off, last."""
    def named():
        for part, name in by_name:
            if part in kernel_name:
                return name
        return None

    if names_first and named():
        return named()
    while op is not None:
        if op.name.startswith(_LABEL):
            return op.name[len(_LABEL):]
        op = op.cpu_parent
    return named() or "round"


def _attribute(events, by_name=OBSERVER_KERNELS,
               names_first: bool = True) -> dict:
    """observer -> kernel name -> (device us, launches) of a profile's
    device kernels: those a CPU event launched by that event and its
    ranges (``_observer_of``), the rest (launches the profiler ties to no
    event) by their names alone.  The profiler also puts each observer's
    range on the device's timeline, over its kernels; those spans are not
    kernels and are left out."""
    left: dict = {}
    for e in events:
        if e.device_type == DeviceType.CUDA \
                and not e.name.startswith(_LABEL):
            us, n = left.get(e.name, (0.0, 0))
            left[e.name] = (us + e.time_range.end - e.time_range.start, n + 1)
    acc: dict = {}

    def add(name, kname, us, n):
        rows = acc.setdefault(name, {})
        u0, n0 = rows.get(kname, (0.0, 0))
        rows[kname] = (u0 + us, n0 + n)

    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        for k in getattr(e, "kernels", ()):
            add(_observer_of(e, k.name, by_name, names_first), k.name,
                k.duration, 1)
            us, n = left.get(k.name, (0.0, 0))
            left[k.name] = (us - k.duration, n - 1)
    for kname, (us, n) in left.items():
        if n > 0:
            add(_observer_of(None, kname, by_name, names_first), kname,
                us, n)
    return acc


def _by_function(acc: dict, R: int, timeline=None) -> dict:
    """``_attribute``'s rows as device ms, kernels a round and the top
    kernels by name, for each label; with ``timeline``
    (``device_timeline``'s), also the ms each label adds to the device's
    occupied time, each kernel name's time scaled by the share of its
    spans that no earlier kernel covers."""
    out = {}
    for name, rows in sorted(acc.items()):
        top = sorted(rows.items(), key=lambda kv: -kv[1][0])
        out[name] = {
            "device_ms_per_round": sum(us for us, _ in rows.values())
            / 1e3 / R,
            "kernels_per_round": sum(n for _, n in rows.values()) / R,
            "by_kernel": [{"kernel": k[:90], "calls_per_round": n / R,
                           "device_ms_per_round": us / 1e3 / R}
                          for k, (us, n) in top[:6]]}
        if timeline is not None:
            _, exclusive, duration = timeline
            out[name]["exclusive_ms_per_round"] = sum(
                us * exclusive.get(k, 0.0) / duration[k]
                if duration.get(k) else us
                for k, (us, _) in rows.items()) / 1e3 / R
    return out


def profile_observers(args) -> dict:
    """The observers' device time a round by observer and kernel name
    (the module docstring): eager rounds of the 1M churn round with the
    flight ring, hist banks and trace threaded, each torch op run under a
    profiler range that names its observer."""
    functions = _named_functions(OBSERVER_FUNCTIONS, args.observer_fn,
                                 "--observer-fn", _kernel_functions())
    dev = torch.device("cuda")
    p = lan_profile(N, slots=SLOTS, hot_slots=0, dissem="fused")
    n_fail = max(1, N * args.churn_ppm // 1_000_000) if args.churn_ppm else 0
    R = args.rounds
    fail = np.full(p.n, kernel.NEVER, np.int32)
    if n_fail:
        fail[:n_fail] = ((np.arange(n_fail, dtype=np.int64) * (WARM + R))
                         // n_fail)
    fail_t = torch.from_numpy(fail).to(dev)
    key = prng.key(42)
    obs = {"flight": kernel.init_flight(device=dev),
           "hist": kernel.init_hist(device=dev)}

    def run(st, steps):
        (st, obs["flight"], obs["hist"]), _ = kernel.run_rounds(
            st, key, fail_t, p, steps, trace=True, device=dev,
            graphed=False, **obs)
        int(st.round)
        torch.cuda.synchronize()
        return st

    state = run(kernel.init_state(p, device=dev), WARM)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with _observer_mode(functions):
            state = run(state, R)
    out = _by_function(_attribute(list(prof.events())), R)
    observers = {k: v for k, v in out.items() if k != "round"}
    return {"device": torch.cuda.get_device_name(dev), "route": "eager",
            "attribution": "observers", "n": p.n, "slots": p.slots,
            "churn_ppm": args.churn_ppm, "warm_rounds": WARM, "rounds": R,
            "observers_device_ms_per_round": sum(
                v["device_ms_per_round"] for v in observers.values()),
            "round_device_ms_per_round": out.get("round", {}).get(
                "device_ms_per_round", 0.0),
            "observers": observers,
            "round_top_kernels": out.get("round", {}).get("by_kernel", [])}


# The round's functions (gossip/kernel.py, and program.py's copies into
# the buffers) that ``--functions`` names; the innermost on a stack wins.
ROUND_FUNCTIONS = {"_join_tick": "join_tick", "_probe_tick": "probe_tick",
                   "_finish_round": "finish_round",
                   "_maybe_pushpull": "pushpull",
                   "_copy_leaves": "copy_leaves",
                   "_swim_round_impl": "round_rest"}
# Hand kernels (ctypes launches, which the profiler ties to no op), by a
# part of their names.
ROUND_KERNELS = (("finish::fire_kernel", "fire_timers"),
                 ("finish::wipe_kernel", "wipe_rows"),
                 ("finish_slots::", "finish_round"),
                 ("dissem_tail::tail_kernel", "tail"),
                 ("threefry::draw_kernel", "draws"),
                 ("observe::counts_kernel", "observers"),
                 ("probe::", "probe_tick"))


class _EagerBranches:
    """``kernel._recorder`` for a round program's body run eagerly: each
    branch is taken on a host read of its predicate and its result is
    copied into the program's buffers (``program._copy_leaves``), as the
    replayed conditional node does; ``taken`` counts the branches run."""

    def __init__(self):
        self.taken: dict = {}

    def when(self, pred, fn, operand):
        if int(pred):
            self.taken["join"] = self.taken.get("join", 0) + 1
            program._copy_leaves(operand, fn(operand))
        return operand

    def switch(self, choice, branches, names, dst):
        which, n_active = kernel.choice_ref(choice)
        i = int(which)
        self.taken[names[i]] = self.taken.get(names[i], 0) + 1
        program._copy_leaves(dst, branches[i]())
        return dst, n_active


def profile_functions(args) -> dict:
    """The round's device time a round by function (the module
    docstring): the 1M round (churn as ``--churn-ppm`` says, on
    ``--ndev`` shards), ``WARM`` graphed rounds, then ``--rounds`` rounds
    of the round program's body run eagerly under the profiler."""
    from consul_tpu_torch.gossip import round_table
    dev = torch.device("cuda")
    p = lan_profile(N, slots=SLOTS, hot_slots=0, dissem="fused")
    n_fail = max(1, N * args.churn_ppm // 1_000_000) if args.churn_ppm else 0
    R = args.rounds
    fail = np.full(p.n, kernel.NEVER, np.int32)
    if n_fail:
        fail[:n_fail] = ((np.arange(n_fail, dtype=np.int64) * (WARM + R))
                         // n_fail)
    fail_t = torch.from_numpy(fail).to(dev)
    key = prng.key(42)
    sc = kernel._ShardCtx(args.ndev, N // args.ndev) if args.ndev else None
    if sc is None:
        state = kernel.run_rounds(kernel.init_state(p, device=dev), key,
                                  fail_t, p, WARM, device=dev)[0]
    else:
        state = kernel.run_rounds_sharded(kernel.init_state(p, device=dev),
                                          key, fail_t, p, WARM,
                                          ndev=args.ndev, device=dev)[0]
    rnd0 = int(state.round)
    prog = program.RoundProgram(p, None, sc, dev, state, fail_t, None, None,
                                None, None, False)
    prog.load(state, fail_t)
    round_table.fill([round_table.Job(p, key, rnd0, prog.table,
                                      step=prog.step)], R)
    functions = _named_functions(ROUND_FUNCTIONS, args.round_fn,
                                 "--round-fn",
                                 _kernel_functions() | {"_copy_leaves"})
    files = (kernel.__file__, program.__file__)
    torch.cuda.synchronize()
    branches = _EagerBranches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with _observer_mode(functions, files):
            for k in range(R):
                kernel._recorder = branches
                try:
                    prog._body(kernel.round_variant(p, None, rnd0 + k))
                finally:
                    kernel._recorder = None
            torch.cuda.synchronize()
    timeline = device_timeline(prof)
    out = _by_function(_attribute(list(prof.events()), ROUND_KERNELS,
                                  names_first=False), R, timeline)
    return {"device": torch.cuda.get_device_name(dev),
            "route": "program body, eager branches",
            "attribution": "functions", "n": p.n, "slots": p.slots,
            "churn_ppm": args.churn_ppm, "ndev": args.ndev or None,
            "warm_rounds": WARM, "rounds": R, "branches": branches.taken,
            "functions": sorted(functions),
            "device_ms_per_round": sum(v["device_ms_per_round"]
                                       for v in out.values()),
            "device_span_ms_per_round": timeline[0] / 1e3 / R,
            "kernels_per_round": sum(v["kernels_per_round"]
                                     for v in out.values()),
            "by_function": out}


# --split: the paths, as flags, and the parts of a graphed call, each the
# functions (module, then attribute path) whose host time it is.
SPLIT_PATHS = {"churn": {}, "healthy": {"churn_ppm": 0},
               "8_shards": {"ndev": 8},
               "partition_heal": {"nemesis": "partition_heal"}}
_G = "consul_tpu_torch.gossip."
SPLIT = {
    "load": [(_G + "program", "RoundProgram.load")],
    "result": [(_G + "program", "RoundProgram.result")],
    "reads": [(_G + "kernel", "_host_int")],
    "table": [(_G + "round_args", "build"), (_G + "program", "_pinned"),
              (_G + "program", "RoundProgram.set_rows"),
              (_G + "round_table", "fill")],
    "variant_mirror": [(_G + "kernel", "variant_codes")],
    "launches": [(_G + "program", "_Graph.launch"),
                 (_G + "program", "_Loop.launch")],
    "round_variant": [(_G + "program", "round_variant")],
    "add_counts": [(_G + "program", "_add_counts")],
    "captures": [(_G + "program", "_Program._capture"),
                 (_G + "program", "_Loop.__init__")],
}
SPLIT_CALLS = 10


class _Split:
    """Host seconds and calls a part, each call's time less that of the
    timed calls inside it."""

    def __init__(self):
        self.s = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._inner = []

    def wrap(self, label, fn):
        def timed_part(*a, **kw):
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                self.s[label] += dt - self._inner.pop()
                self.calls[label] += 1
                if self._inner:
                    self._inner[-1] += dt
        return timed_part


def _split_targets() -> list:
    """``(label, owner, attribute, function)`` of every ``SPLIT`` function
    this checkout has."""
    out = []
    for label, names in SPLIT.items():
        for mod, path in names:
            try:
                owner = importlib.import_module(mod)
            except ImportError:
                continue
            *outer, attr = path.split(".")
            for o in outer:
                owner = getattr(owner, o, None)
            if owner is not None and attr in vars(owner):
                out.append((label, owner, attr, vars(owner)[attr]))
    return out


def profile_split(args) -> dict:
    """The host split of a graphed call (the module docstring)."""
    dev = torch.device("cuda")
    calls, R = SPLIT_CALLS, args.rounds
    p, run, _ = _route(args, dev, True, calls * R)
    start = run(kernel.init_state(p, device=dev), WARM)
    # The timed calls' rounds once untimed, so that every variant they
    # meet is captured before them.
    state = start
    for _ in range(calls):
        state = run(state, R)
    state = start
    torch.cuda.synchronize()
    split, targets = _Split(), _split_targets()
    host = synced = 0.0
    for label, owner, attr, fn in targets:
        setattr(owner, attr, split.wrap(label, fn))
    try:
        for _ in range(calls):
            t0 = time.perf_counter()
            state = run(state, R)
            t1 = time.perf_counter()
            int(state.round)
            torch.cuda.synchronize()
            host += t1 - t0
            synced += time.perf_counter() - t0
    finally:
        for label, owner, attr, fn in targets:
            setattr(owner, attr, fn)
    parts = {label: {"ms_per_call": split.s[label] * 1e3 / calls,
                     "ms_per_round": split.s[label] * 1e3 / (calls * R),
                     "calls_per_call": split.calls[label] / calls}
             for label in SPLIT}
    rest = host - sum(split.s.values())
    parts["rest"] = {"ms_per_call": rest * 1e3 / calls,
                     "ms_per_round": rest * 1e3 / (calls * R)}
    return {"calls": calls, "rounds_per_call": R,
            "timed": sorted({label for label, *_ in targets}),
            "host_ms_per_call": host * 1e3 / calls,
            "host_ms_per_round": host * 1e3 / (calls * R),
            "synced_ms_per_round": synced * 1e3 / (calls * R),
            "parts": parts}


def _route(args, dev, graphed: bool, rounds: int | None = None):
    """The main path as the flags say: its parameters and ``run(state,
    steps)``, which runs a call and returns the state (carrying the
    scenario's NemState and, with ``--observers``, the flight ring and
    hist banks from call to call); the churn failures strided over
    ``WARM`` and ``rounds`` rounds (``--rounds``)."""
    # The scenario's schedule and its Lifeguard registers, carried from
    # call to call (``nem_kw["nem_state"]``).
    nem_kw = {}
    # With --observers, the flight ring and hist banks, carried likewise.
    obs = ({"flight": kernel.init_flight(device=dev),
            "hist": kernel.init_hist(device=dev)} if args.observers else {})

    def run(st, steps):
        kw = dict(nem_kw, **obs, trace=bool(obs), device=dev,
                  graphed=graphed)
        if args.ndev:
            out = kernel.run_rounds_sharded(st, key, fail_t, p, steps,
                                            ndev=args.ndev, **kw)[0]
        else:
            out = kernel.run_rounds(st, key, fail_t, p, steps, **kw)[0]
        if not isinstance(out, kernel.SwimState):
            out, *rest = out
            for k in ("flight", "hist", "nem_state"):
                if kw.get(k) is not None:
                    (obs if k in obs else nem_kw)[k] = rest.pop(0)
        return out

    p = lan_profile(N, slots=SLOTS, hot_slots=0, dissem="fused")
    n_fail = max(1, N * args.churn_ppm // 1_000_000) if args.churn_ppm else 0
    total = WARM + (args.rounds if rounds is None else rounds)
    fail = np.full(p.n, kernel.NEVER, np.int32)
    if n_fail:
        fail[:n_fail] = (np.arange(n_fail, dtype=np.int64) * total) // n_fail
    if args.nemesis:
        sc = build_nemesis(args.nemesis, N)
        fail = np.minimum(fail, sc.fail_round)
        nem_kw["nem"] = sc.nem
        if sc.join_round is not None:
            nem_kw["join_round"] = torch.from_numpy(sc.join_round).to(dev)
        if sc.nem.needs_state:
            nem_kw["nem_state"] = kernel.init_nem_state(N, device=dev)
    fail_t = torch.from_numpy(fail).to(dev)
    key = prng.key(42)

    def snapshot():
        """A function that puts the carried NemState, ring and banks back
        as they are now (for a second pass over the same rounds)."""
        saved = (dict(obs), dict(nem_kw))
        return lambda: (obs.update(saved[0]), nem_kw.update(saved[1]))

    return p, run, snapshot


class _LoopBuilds:
    """While entered, the round program's loop builds (``program._Loop``,
    where the checkout has one): their count, host seconds and the card's
    memory each took (free memory before less after: the executable graph
    and whatever else the build allocated outside PyTorch's pool)."""

    def __enter__(self):
        self.builds, self.seconds, self.device_bytes = 0, 0.0, 0
        loop = getattr(program, "_Loop", None)
        self._init = None if loop is None else loop.__init__
        if loop is not None:
            def init(obj, *a, **kw):
                torch.cuda.synchronize()
                free0 = torch.cuda.mem_get_info()[0]
                t0 = time.perf_counter()
                try:
                    return self._init(obj, *a, **kw)
                finally:
                    self.seconds += time.perf_counter() - t0
                    torch.cuda.synchronize()
                    self.device_bytes += free0 - torch.cuda.mem_get_info()[0]
                    self.builds += 1
            loop.__init__ = init
        return self

    def __exit__(self, *exc):
        if self._init is not None:
            program._Loop.__init__ = self._init


def profile_route(args, graphed: bool) -> dict:
    """One route's profile (the module docstring)."""
    with _LoopBuilds() as builds:
        res = _profile_route(args, graphed)
    res.update(loop_builds=builds.builds, loop_build_s=builds.seconds,
               loop_build_device_bytes=builds.device_bytes)
    return res


def _profile_route(args, graphed: bool) -> dict:
    dev = torch.device("cuda")
    phases = {} if graphed else dict(
        PHASES, **(SHARDED_PHASES if args.ndev else SINGLE_PHASES))
    p, run, snapshot = _route(args, dev, graphed)
    captures0, capture_s0 = program.captures, program.capture_s
    pool0 = program.pool_bytes
    state = run(kernel.init_state(p, device=dev), WARM)
    torch.cuda.synchronize()
    R = args.rounds
    saved = {label: getattr(mod, attr)
             for label, (mod, attr) in phases.items()}

    def measured_pass(wrap, acc, st):
        try:
            for label, (mod, attr) in phases.items():
                setattr(mod, attr, wrap(label, saved[label], acc))
            t0 = time.perf_counter()
            st = run(st, R)
            int(st.round)
            torch.cuda.synchronize()
            return st, time.perf_counter() - t0
        finally:
            for label, (mod, attr) in phases.items():
                setattr(mod, attr, saved[label])

    if graphed:
        # The loop built again after a profiler session (``fresh_loops``)
        # by a call before the measured ones.
        fresh_loops()
        state = run(state, R)
    program.settle_counts()
    tails0 = dict(kernel.tail_rounds)
    draws0, graphs0, syncs0 = prng.launches, program.launches, \
        kernel.host_syncs
    # Passes A and B run the same rounds from the same carry.
    host_s, start, restore = {}, state, snapshot()
    state, wall_a = measured_pass(_timed, host_s, start)
    restore()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, wall_b = measured_pass(_annotated, None, start)
    program.settle_counts()

    timed = {}
    for k in phases:
        s, n = host_s.get(k, (0.0, 0))
        timed[k] = {"host_ms_per_round": s * 1e3 / R, "calls_per_round": n / R,
                    "host_us_per_call": s * 1e6 / n if n else None,
                    "device_ms_per_round": 0.0}
    for e in prof.events():
        if e.name in timed and e.device_type == DeviceType.CPU:
            timed[e.name]["device_ms_per_round"] += _device_us(e) / 1e3 / R
    kernels = device_kernels(prof, phases)
    ops = sorted((e for e in prof.key_averages()
                  if e.key.startswith("aten::")),
                 key=lambda e: -(self_device_us(e) or e.self_cpu_time_total))
    busy_us = sum(self_device_us(e) for e in kernels)
    span_us, exclusive, _ = device_timeline(prof, phases)
    res = {
        "device": torch.cuda.get_device_name(dev),
        "route": "graphed" if graphed else "eager",
        "n": p.n, "slots": p.slots, "churn_ppm": args.churn_ppm,
        "ndev": args.ndev or None, "nemesis": args.nemesis or None,
        "observers": args.observers, "warm_rounds": WARM, "rounds": R,
        "drop_launches": fused.drop_launches + fused.merge_drop_launches,
        "draw_launches_per_round": (prng.launches - draws0) / (2 * R),
        "graph_launches_per_round": (program.launches - graphs0) / (2 * R),
        "host_syncs_per_round": (kernel.host_syncs - syncs0) / (2 * R),
        "captures": program.captures - captures0,
        "capture_s": program.capture_s - capture_s0,
        "pool_bytes": program.pool_bytes - pool0,
        "tail_rounds_both_passes": {k: kernel.tail_rounds[k] - tails0[k]
                        for k in tails0},
        "host_ms_per_round": wall_a * 1e3 / R,
        "profiled_host_ms_per_round": wall_b * 1e3 / R,
        "device_busy_ms_per_round": busy_us / 1e3 / R,
        "device_span_ms_per_round": span_us / 1e3 / R,
        "device_idle_share": 1 - busy_us / 1e6 / wall_a,
        "device_span_idle_share": 1 - span_us / 1e6 / wall_a,
        "device_kernels_per_round": sum(e.count for e in kernels) / R,
        "hand_kernels": {
            label: {"calls_per_round": sum(e.count for e in rows) / R,
                    "device_ms_per_round":
                        sum(self_device_us(e) for e in rows) / 1e3 / R,
                    "exclusive_ms_per_round": sum(
                        us for k, us in exclusive.items() if name in k)
                    / 1e3 / R}
            for label, name in HAND_KERNELS.items()
            for rows in [[e for e in kernels if name in e.key]]},
        "phases": timed,
        "top_ops": [{"op": e.key, "calls_per_round": e.count / R,
                     "device_ms_per_round": self_device_us(e) / 1e3 / R,
                     "host_ms_per_round": e.self_cpu_time_total / 1e3 / R}
                    for e in ops[:12]],
        "top_kernels": [{"kernel": e.key[:90], "calls_per_round": e.count / R,
                         "device_ms_per_round": self_device_us(e) / 1e3 / R}
                        for e in kernels[:8]],
    }
    return res


if __name__ == "__main__":
    raise SystemExit(main())
