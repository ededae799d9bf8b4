#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``consul_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Each phase prints one JSON line; any failure exits non-zero and the
result lines are not printed.

1. card: ``nvidia-smi`` name and power limit, torch's device name/count.
2. build: ``csrc/dissem_tail.cu`` (both entry points, ``fused_dissem``
   and ``fused_merge``) with nvcc for sm_90a (ptxas report).
3. sass: the instructions per 32-bit word in the word path's row loop at
   fanout 3, per execution unit, one alignment way
   (``consul_tpu_torch/sass_count.py``, cuobjdump).
4. kernel: the Hopper dissemination kernel against its plain torch
   version on the card (with and without a drop operand), adversarial
   bytes at [64, 1M], [8, 1M] and the ragged [64, 16,001], each under
   offset triples that start with 1,
   N-1 and a random one and together cover every residue mod 16;
   byte-identical results required; kernel time (``ms``: CUDA events
   over replays of a CUDA graph of 20 launches, the first triple; and
   ``eager_ms`` over back-to-back wrapper calls, which the wrapper's host
   time sets at small shapes), the plain version's time and the bound:
   the larger of the bytes over the memory rate and the per-byte rule's
   operations, counted four bytes to a 32-bit word (or the SASS count of
   the busiest execution unit where that is lower), over that unit's 32-bit
   integer rate.
5. merge_kernel: the sharded round's merge (``fused_merge``, all shards
   in one launch) against the plain composition ``merge_shards_ref`` in
   the same way, at [64, 1M] and [8, 1M] on 8 shards and at n = 16,000 on
   1, 2, 4 and 8 shards, with offsets above L.  Its bound is kernel 1's
   at the same [S, N]: the function is the same.
6. repeat: both kernels at [8, 1M] (the merge on 8 shards) over many
   seeds, each seed with its own offset triple and three launches, every
   launch byte-identical to the plain version.
7. full_path: ``run_rounds`` at n=16,000, S=64 (lan_profile, churn,
   loss, joins, flight ring, hist banks, trace) once on the card and
   once on the CPU (a worker process started with the script, which runs
   while the kernel phases do); every field of the carry and the trace
   must be bit-identical.
8. sharded_full_path: the same run through ``run_rounds_sharded(ndev=8)``
   on the card; every field must equal the card run of phase 7; merge
   launches = the non-quiescent rounds (one launch for all shards), none
   of fused_dissem; both the hot and the full tail must run.
9. main_path: ``lan_profile(1_000_000, slots=64, hot_slots=0)`` with
   bench.py's churn1000ppm failure stride — warm-up, timed blocks each
   ending in a device->host read; rounds/s, kernel launches (must equal
   the non-quiescent rounds), host syncs per round, peak device memory;
   ``n_detected > 0`` and ``n_false_dead == 0`` required.
10. sharded_main_path: the same churn run through
    ``run_rounds_sharded(ndev=8)``: rounds/s, merge launches (= the
    non-quiescent rounds), host syncs per round (equal to phase 9's),
    peak device memory; the final state, unsharded, must equal phase 9's
    field by field.  Then the healthy regime (no churn, single-device)
    for rounds/s.
11. events: the user-event flood (``gossip/events.py``) at E = 64,
    n = 16,000 for 300 rounds (fires with overflow, -1 entries and
    repeated nodes, push/pull rounds, an alive mask with holes, slot GC
    and reuse) on the card and on the CPU: every field and the coverage
    trace bit-identical.  Then at [64, 1M] with the plane's parameters:
    one fired event must reach coverage >= 0.99 within
    ``event_ttl_rounds``; the event round's time (CUDA events over 100
    rounds ending in a device->host read) and peak device memory.
12. plane: the port's gossip plane in this process on the card, universe
    1M (capacity 1,024 + 998,976 simulated nodes, 64 slots, 64 event
    slots, 20 ms rounds, suspicion_mult 1.0, 0.3 s heartbeat lapse),
    serving 8 bridge clients (4-byte big-endian length + msgpack):
    every client sees member-join for all the others; a user event
    reaches every client and ``event_coverage()`` reaches 0.99; one
    client stops its heartbeats and every other client gets
    member-failed for it and for no one else; the stats frame shows
    ``n_false_dead == 0``; ``fused_dissem`` launched; the device frame
    reports the card's memory; the profile frame has no error; no tick
    error on stderr.  Rounds/s sustained, dispatch p50/p99 from the
    device frame, peak device memory.  Then the join and failure flow
    again with ``shard_devices=8``: ``fused_merge`` launched.
13. gossipd: ``python -m consul_tpu_torch.gossipd -nemesis
    partition_heal`` as a subprocess on the card at a small capacity; one
    client registers, gets its welcome and a stats frame; SIGTERM; exit
    code 0.

The nemesis phases (the catalog of ``gossip/nemesis.py``):

- kernel, merge_kernel and repeat hold both kernels with a drop operand
  too (a random one and ``partition_heal``'s full bisection with its
  window open), and report ``ms_drop`` beside ``ms``;
- nemesis_full_path (after 8): all six scenarios at n = 16,000, S = 64,
  each over its window, on the card against the CPU (worker processes)
  and on 8 shards against the single-device card run: every field of
  state, hist, NemState and trace bit-identical;
- nemesis_main_path and sharded_nemesis_main_path (after 10):
  ``partition_heal`` at 1M, S = 64, on 1 and 8 shards: rounds/s before
  the fault window, in its first 30 rounds and in the 60 after those,
  launches with a drop operand (one per round inside), host syncs per
  round (equal), final states equal;
- plane_nemesis (after 12): the plane under ``partition_heal`` at
  universe 1M with 8 bridge clients for 200 rounds (no tick error, the
  slo frame's scenario, launches with a drop operand), then the card
  plane in lockstep with the CPU plane at universe 16,384.

Then the kernels line (each kernel's launches on the main path, on the
plane's path as ``plane_launches``, and with a drop operand on the
nemesis main paths as ``nemesis_launches``) and, last, the ok line.  Needs
one CUDA card: without one it exits 2 before printing anything else.
Imports nothing of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import multiprocessing
import os
import select
import signal
import socket
import struct
import subprocess
import sys
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import msgpack
import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
NEVER = 2**31 - 1
# H100 SXM peaks (NVIDIA data sheet, 700 W): the device memory rate, and
# the 8-bit integer rate of the tensor cores.  The merge's compares, maxima
# and selects cannot run on tensor cores: they run on the CUDA cores' 64
# INT32 lanes per SM, half the 128 FP32 lanes behind the sheet's 67 TFLOP/s
# of float32 (an FMA counts 2 FLOPs), so 67e12 / 4 integer ops/s.  The
# integer multiply-adds (IMAD) run on the FMA unit at the same 64 lanes
# per SM, beside the integer ALU, so each unit has this rate.
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1.979e15
INT32_OPS_PER_S = 67e12 / 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int, warm: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` warm calls (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device time of one ``fn`` call: ``per_graph`` calls captured in a
    CUDA graph, the graph replayed ``replays`` times between CUDA events.
    Unlike back-to-back eager calls, this leaves out the wrapper's host
    time, which exceeds a small kernel's device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    del graph
    torch.cuda.empty_cache()
    return ms


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed (rc {smi.returncode}): "
                           f"{smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "card", "nvidia_smi": line,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


# The port's kernel sources (csrc/<name>.cu), one nvcc each: both entry
# points, fused_dissem and fused_merge, are in dissem_tail.cu.
SOURCES = ("dissem_tail",)


def build() -> None:
    """Every kernel source of the port, one nvcc each, all started
    together."""
    from consul_tpu_torch import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        libs = list(pool.map(_build.build, SOURCES))
    for name in SOURCES:
        log = _build.build_logs.get(name, "(already built)")
        for ln in log.strip().splitlines():
            print(f"  nvcc {name}: {ln}", flush=True)
    emit({"phase": "build", "libraries": [so.name for so in libs],
          "seconds": time.perf_counter() - t0})


def adversarial(S: int, N: int, seed: int, dev):
    """Every byte value (message, confirmation count and age, the fresh
    sentinel included), senders dead/alive/non-member, receivers on and
    off, caps 0..3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    heard = torch.randint(0, 256, (S, N), generator=g, device=dev,
                          dtype=torch.uint8)
    choices = torch.tensor([-1, 10, 200, NEVER], dtype=torch.int32,
                           device=dev)
    mf = choices[torch.randint(0, 4, (N,), generator=g, device=dev)]
    rx_ok = torch.rand(N, generator=g, device=dev) < 0.9
    cap = torch.randint(0, 4, (S,), generator=g, device=dev,
                        dtype=torch.int32)
    return heard, mf, rx_ok, cap


def sass_phase() -> dict:
    """The SASS count of the word path's row loop at fanout 3, per execution
    unit (consul_tpu_torch/sass_count.py), for the operations bound."""
    from consul_tpu_torch import sass_count
    res = sass_count.row_loop_counts(sass_count.disassemble(), 3)
    emit({"phase": "sass", **res})
    return res


def _bound(S: int, N: int, F: int, sass: dict, drop: bool = False) -> dict:
    """The least time the card could take for the tail at [S, N] and
    fanout F (with a drop operand: ``drop``): the bytes it must move over
    the memory rate, or its integer operations over the INT32 rate of the
    busiest unit, whichever is larger."""
    # heard read once, out written once; mf (int32), rx (1 byte) and cap
    # (int32) read once; a drop operand's F bytes per column read once.
    nbytes = 2 * S * N + 5 * N + 4 * S + (F * N if drop else 0)
    # The per-byte rule's operations, counted from disseminate_ref: 10 to
    # age the current byte, 18 per leg (age the pin, gate it, priority-max,
    # count suspects), 22 to merge and pack; plus one sender-liveness
    # compare per leg and column.
    nops = S * N * (32 + 18 * F) + N * F
    # Four bytes to a 32-bit word: each counted operation covers a word.
    # Where the SASS of the word loop gives its busiest execution unit fewer
    # instructions per word than that (at fanout 3; one alignment way,
    # sass_count.py), the bound takes the SASS count.
    per_word = 32 + 18 * F
    if F == sass["fanout"] and sass["busiest_unit_per_word"] < per_word:
        per_word = sass["busiest_unit_per_word"]
    word_ops = S * N / 4 * per_word + N * F
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = word_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return {"bytes": nbytes, "bytes_ms": bytes_ms, "byte_operations": nops,
            "operations_per_word": per_word, "word_operations": word_ops,
            "operations_ms": ops_ms, "int32_ops_per_s": INT32_OPS_PER_S,
            "operations_ms_at_int8_tensor_rate":
                nops / INT8_TENSOR_OPS_PER_S * 1e3,
            "int8_tensor_ops_per_s": INT8_TENSOR_OPS_PER_S,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _offset_sets(N: int, L: int, seed: int) -> list:
    """Triples of gossip shifts: first 1, N - 1 and a random one (the
    timed set); then, together, every residue mod 16 (2..17 and large
    shifts of each residue), and shifts above L (pins from a shard
    further on)."""
    rng = np.random.default_rng(seed)
    first = [1, N - 1, int(rng.integers(2, N - 1))]
    big = [int(rng.integers(1, (N - 16) // 16)) * 16 + r for r in range(16)]
    rest = list(range(2, 18)) + big + [L + 1, 2 * L + 7, N - L - 3]
    return [first] + [rest[k:k + 3] for k in range(0, len(rest), 3)]


def _held(name: str, shape, kern, plain) -> int:
    """Run the kernel and its plain version; raise unless byte-identical."""
    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(out_k, torch.Tensor):
        out_k, out_p = (out_k,), (out_p,)
    err = max(int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
              for a, b in zip(out_k, out_p))
    if err != 0:
        n_bad = sum(int((a != b).sum()) for a, b in zip(out_k, out_p))
        raise AssertionError(f"{name} != plain at {shape}: {n_bad} bytes "
                             f"differ, max abs err {err}")
    return err


def _drops(N: int, F: int, seed: int):
    """Drop operands of the card's kernels: a random one (each byte set
    with probability 1/2, to any nonzero value), and the full bisection of
    ``partition_heal`` with its window open (every leg whose sender lies
    in the other half of the ids drops: ``drops(offs)``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rand = (torch.randint(1, 256, (F, N), generator=g, device="cuda",
                          dtype=torch.uint8)
            * (torch.rand((F, N), generator=g, device="cuda") < 0.5))
    grp = (torch.arange(N, device="cuda") >= N // 2)

    def bisection(offs):
        return torch.stack([torch.roll(grp, o) != grp for o in offs])
    return rand, bisection


def _drop_variants(N: int, sets, seed: int):
    """(offsets, drop) pairs: each offset set without a drop operand,
    with the random one and with the bisection."""
    rand, bisection = _drops(N, len(sets[0]), seed)
    return [(o, d) for o in sets
            for d in (None, rand[:len(o)], bisection(o))]


def kernel_vs_plain(S: int, N: int, seed: int, sass: dict) -> dict:
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(N, slots=S)
    heard, mf, rx_ok, cap = adversarial(S, N, seed, "cuda")
    rnd = 50
    budget = p.spread_budget_rounds
    sets = _offset_sets(N, N, seed)
    variants = _drop_variants(N, sets, seed)

    def kern(offs=sets[0], drop=None):
        return fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd, budget,
                                  drop)

    def plain(offs=sets[0], drop=None):
        return fused.disseminate_ref(p, rnd, offs, heard, mf, rx_ok, cap,
                                     drop)

    err = max(_held("fused_dissem", [S, N], lambda: kern(o, d),
                    lambda: plain(o, d)) for o, d in variants)
    drop = variants[1][1]
    ms = graph_ms(kern)
    ms_drop = graph_ms(lambda: kern(sets[0], drop))
    eager_ms = cuda_ms(kern, 200)
    plain_ms = cuda_ms(plain, 5, warm=1)
    bound = _bound(S, N, len(sets[0]), sass)
    bound_drop = _bound(S, N, len(sets[0]), sass, drop=True)
    res = {"phase": "kernel", "shape": [S, N], "offsets": sets[0],
           "offset_sets_held": len(sets), "drop_variants_held": len(variants),
           "tolerance": 0, "max_abs_err": err, "ms": ms, "ms_drop": ms_drop,
           "eager_ms": eager_ms, "plain_ms": plain_ms, **bound,
           "bound_ms_drop": bound_drop["bound_ms"],
           "share_of_bound": bound["bound_ms"] / ms,
           "share_of_bound_drop": bound_drop["bound_ms"] / ms_drop,
           "library_ms": None}
    emit(res)
    return res


def merge_vs_plain(S: int, N: int, ndev: int, seed: int,
                   sass: dict) -> dict:
    """fused_merge (all shards, one launch) against merge_shards_ref on
    the card: the whole [S, N] matrix as ndev shards."""
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(N, slots=S)
    L = N // ndev
    heard, mf, rx_ok, cap = adversarial(S, N, seed, "cuda")
    shards = tuple(h.contiguous() for h in heard.split(L, dim=1))
    del heard
    sc = kernel._ShardCtx(ndev, L)
    rnd = 50
    budget = p.spread_budget_rounds
    sets = _offset_sets(N, L, seed)
    variants = _drop_variants(N, sets, seed)

    def kern(offs=sets[0], drop=None):
        return fused.fused_merge(shards, offs, mf, rx_ok, cap, rnd, budget,
                                 drop)

    def plain(offs=sets[0], drop=None):
        return fused.merge_shards_ref(p, rnd, offs, shards, mf, rx_ok, cap,
                                      sc, drop)

    err = max(_held("fused_merge", [S, N, ndev], lambda: kern(o, d),
                    lambda: plain(o, d)) for o, d in variants)
    drop = variants[1][1]
    ms = graph_ms(kern)
    ms_drop = graph_ms(lambda: kern(sets[0], drop))
    eager_ms = cuda_ms(kern, 200)
    plain_ms = cuda_ms(plain, 5, warm=1)
    # The function is kernel 1's at [S, N]: its bytes and operations.
    bound = _bound(S, N, len(sets[0]), sass)
    bound_drop = _bound(S, N, len(sets[0]), sass, drop=True)
    res = {"phase": "merge_kernel", "shape": [S, N], "ndev": ndev, "L": L,
           "offsets": sets[0], "offset_sets_held": len(sets),
           "drop_variants_held": len(variants), "tolerance": 0,
           "max_abs_err": err, "ms": ms, "ms_drop": ms_drop,
           "eager_ms": eager_ms, "plain_ms": plain_ms, **bound,
           "bound_ms_drop": bound_drop["bound_ms"],
           "share_of_bound": bound["bound_ms"] / ms,
           "share_of_bound_drop": bound_drop["bound_ms"] / ms_drop,
           "library_ms": None}
    emit(res)
    return res


def repeat(S: int, N: int, seeds: int, ndev: int | None = None,
           launches: int = 3) -> dict:
    """``fused_dissem`` (or, with ``ndev``, ``fused_merge`` on ndev
    shards) against its plain version over ``seeds`` fresh inputs, each
    with its own random offset triple and, in turn, no drop operand, a
    random one and the bisection's, ``launches`` launches each: every
    launch must be byte-identical to the plain version."""
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(N, slots=S)
    rnd, budget = 50, p.spread_budget_rounds
    L = N if ndev is None else N // ndev
    sc = None if ndev is None else kernel._ShardCtx(ndev, L)
    bad = held = 0
    t0 = time.perf_counter()
    for seed in range(seeds):
        heard, mf, rx_ok, cap = adversarial(S, N, 1000 + seed, "cuda")
        offs = [int(o) for o in
                np.random.default_rng(seed).integers(1, N, 3)]
        drop = None
        if seed % 3:
            rand, bisection = _drops(N, 3, seed)
            drop = rand if seed % 3 == 1 else bisection(offs)
        if ndev is None:
            ref = (fused.disseminate_ref(p, rnd, offs, heard, mf, rx_ok,
                                         cap, drop),)
        else:
            heard = tuple(h.contiguous() for h in heard.split(L, dim=1))
            ref = fused.merge_shards_ref(p, rnd, offs, heard, mf, rx_ok,
                                         cap, sc, drop)
        for _ in range(launches):
            if ndev is None:
                out = (fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd,
                                          budget, drop),)
            else:
                out = fused.fused_merge(heard, offs, mf, rx_ok, cap, rnd,
                                        budget, drop)
            bad += sum(int((a != b).sum()) for a, b in zip(out, ref))
            held += 1
    res = {"phase": "repeat",
           "kernel": "fused_dissem" if ndev is None else "fused_merge",
           "shape": [S, N], "ndev": ndev, "seeds": seeds,
           "launches_held": held, "bytes_differing": bad,
           "seconds": time.perf_counter() - t0}
    emit(res)
    if bad:
        raise AssertionError(f"{res['kernel']} != plain at {[S, N]} in "
                             f"{bad} bytes over {seeds} seeds")
    return res


def _reset_counts() -> None:
    """Every kernel launch count and round counter to 0."""
    from consul_tpu_torch.gossip import fused, kernel
    fused.launches = 0
    fused.merge_launches = 0
    fused.drop_launches = 0
    fused.merge_drop_launches = 0
    kernel.host_syncs = 0
    for k in kernel.tail_rounds:
        kernel.tail_rounds[k] = 0


def _full_path_inputs(n: int, steps: int, seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)
    fail = np.full(n, NEVER, np.int32)
    fail[ids[:48]] = rng.integers(0, steps // 2, 48)
    join = np.full(n, NEVER, np.int32)
    join[ids[48:72]] = rng.integers(1, steps // 2, 24)
    return fail, join, join == NEVER


def _run(p, fail, join, member0, steps, seed, dev, ndev=None):
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel

    st = kernel.init_state(p, device=dev)
    st = st._replace(member=torch.from_numpy(member0).to(dev))
    kw = dict(trace=True, join_round=join,
              flight=kernel.init_flight(device=dev),
              hist=kernel.init_hist(device=dev), device=dev)
    if ndev is None:
        return kernel.run_rounds(st, prng.key(seed), fail, p, steps, **kw)
    return kernel.run_rounds_sharded(st, prng.key(seed), fail, p, steps,
                                     ndev=ndev, **kw)


def _diverged(pairs) -> list:
    from consul_tpu_torch.gossip import kernel
    out = []
    for a, b in pairs:
        if isinstance(a, kernel.SwimState):
            a, b = kernel.unshard_state(a), kernel.unshard_state(b)
        for f in a._fields:
            x, y = getattr(a, f).cpu(), getattr(b, f).cpu()
            if x.dtype != y.dtype or not torch.equal(x, y):
                out.append(f"{type(a).__name__}.{f}")
    return out


FULL_PATH = dict(n=16_000, S=64, steps=300, seed=11)


def _full_path_params(n: int, S: int):
    from consul_tpu_torch.gossip.params import lan_profile
    return lan_profile(n, slots=S, dissem="fused", loss_rate=0.01)


def _full_path_cpu(n: int, S: int, steps: int, seed: int):
    """full_path's run on the CPU, in a worker process, as numpy (two
    threads: it is the longest of the CPU runs)."""
    torch.set_num_threads(2)
    fail, join, member0 = _full_path_inputs(n, steps, seed)
    return _as_numpy(*_run(_full_path_params(n, S), fail, join, member0,
                           steps, seed, "cpu"))


def full_path(cpu, n: int, S: int, steps: int, seed: int):
    """The card run against the CPU run (``cpu``: the future of its
    worker process).  Returns the card run's (carry, trace) for
    sharded_full_path."""
    from consul_tpu_torch.gossip import fused

    p = _full_path_params(n, S)
    fail, join, member0 = _full_path_inputs(n, steps, seed)

    launches0 = fused.launches
    t0 = time.perf_counter()
    (st_g, fl_g, hb_g), tr_g = _run(p, fail, join, member0, steps, seed,
                                    "cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = fused.launches - launches0
    t0 = time.perf_counter()
    diverged = _diverged_np(_as_numpy((st_g, fl_g, hb_g), tr_g),
                            cpu.result())
    emit({"phase": "full_path", "n": n, "slots": S, "steps": steps,
          "kernel_launches": launches, "cuda_s": t_gpu,
          "cpu_wait_s": time.perf_counter() - t0,
          "n_detected": int(st_g.n_detected),
          "n_refuted": int(st_g.n_refuted),
          "members": int(st_g.member.sum()), "diverged": diverged})
    if diverged:
        raise AssertionError(f"card and CPU runs diverged in {diverged}")
    if launches == 0 or int(st_g.n_detected) == 0:
        raise AssertionError("the full-path run exercised no dissemination")
    return (st_g, fl_g, hb_g), tr_g


def sharded_full_path(single, n: int, S: int, steps: int, seed: int,
                      ndev: int = 8) -> None:
    """full_path's run through run_rounds_sharded on the card, held
    against full_path's card run (``single``)."""
    from consul_tpu_torch.gossip import fused, kernel

    p = _full_path_params(n, S)
    fail, join, member0 = _full_path_inputs(n, steps, seed)
    _reset_counts()
    t0 = time.perf_counter()
    carry, tr = _run(p, fail, join, member0, steps, seed, "cuda", ndev)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    merges, dissems = fused.merge_launches, fused.launches
    tails = dict(kernel.tail_rounds)
    (st_1, fl_1, hb_1), tr_1 = single
    diverged = _diverged(list(zip((st_1, fl_1, hb_1), carry)) + [(tr_1, tr)])
    emit({"phase": "sharded_full_path", "n": n, "slots": S, "steps": steps,
          "ndev": ndev, "merge_launches": merges,
          "dissem_launches": dissems, "tail_rounds": tails,
          "cuda_s": t_gpu, "n_detected": int(carry[0].n_detected),
          "diverged": diverged})
    if diverged:
        raise AssertionError(f"sharded and single-device card runs "
                             f"diverged in {diverged}")
    if merges != tails["hot"] + tails["full"] or dissems != 0:
        raise AssertionError("merge launches != non-quiescent rounds "
                             "(or fused_dissem ran)")
    if tails["hot"] == 0 or tails["full"] == 0:
        raise AssertionError(f"both tails must run: {tails}")


def main_path(n: int, S: int, churn_ppm: int, warm: int, block: int,
              blocks: int, ndev: int | None = None):
    """bench.py's LAN regime on the port: rounds/s over timed blocks;
    through run_rounds_sharded when ``ndev`` is given.  Returns the
    result line and the final state."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(n, slots=S, hot_slots=0, dissem="fused")
    n_fail = (n * churn_ppm) // 1_000_000 if churn_ppm else 0
    if churn_ppm and n_fail == 0:
        n_fail = 1
    total = warm + block * blocks
    fail = np.full(n, NEVER, np.int32)
    if n_fail:
        # Stride, not modulo: failures land across every block.
        fail[:n_fail] = (np.arange(n_fail, dtype=np.int64) * total) // n_fail
    fail_t = torch.from_numpy(fail).cuda()
    key = prng.key(42)

    def rounds(state, steps):
        if ndev is None:
            return kernel.run_rounds(state, key, fail_t, p, steps)[0]
        return kernel.run_rounds_sharded(state, key, fail_t, p, steps,
                                         ndev=ndev)[0]

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state = kernel.init_state(p)
    t0 = time.perf_counter()
    state = rounds(state, warm)
    int(state.round)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        state = rounds(state, block)
        int(state.round)
        times.append(time.perf_counter() - t0)
    tails = dict(kernel.tail_rounds)
    res = {"phase": "main_path" if ndev is None else "sharded_main_path",
           "n": n, "slots": S, "churn_ppm": churn_ppm, "ndev": ndev,
           "rounds": total, "warmup_s": warm_s, "block_rounds": block,
           "block_s": times,
           "rounds_per_s_mean": block * blocks / sum(times),
           "rounds_per_s_best_block": block / min(times),
           "kernel_launches": fused.launches,
           "merge_launches": fused.merge_launches, "tail_rounds": tails,
           "host_syncs_per_round": kernel.host_syncs / total,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "n_detected": int(state.n_detected),
           "n_false_dead": int(state.n_false_dead),
           "drops": int(state.drops)}
    emit(res)
    busy = tails["hot"] + tails["full"]
    if ndev is None and fused.launches != busy:
        raise AssertionError("kernel launches != non-quiescent rounds")
    if ndev is not None and (fused.merge_launches != busy
                             or fused.launches != 0):
        raise AssertionError("merge launches != non-quiescent rounds "
                             "(or fused_dissem ran)")
    return res, state


# -- nemesis ------------------------------------------------------------------

# Rounds per scenario at n = 16,000: each run covers the scenario's fault
# window and rounds on both sides of it (kills at round 30 or 40,
# asym_loss from 20, partition_heal [40, 160), flapping [30, 310): two
# down phases and two rejoins).
NEM_STEPS = {"block_kill": 150, "zone_kill": 150, "partition_heal": 180,
             "asym_loss": 100, "flapping": 320, "degraded_observer": 150}
NEM = dict(n=16_000, S=64, seed=13)


def _nem_run(name: str, n: int, S: int, steps: int, seed: int, dev: str,
             ndev: int | None = None):
    """``steps`` rounds of ``run_rounds`` (or ``run_rounds_sharded``)
    under the catalog scenario ``name`` with the hist banks, NemState
    when it needs one, and the trace: ``(carry, trace)``."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile

    sc = build(name, n)
    p = lan_profile(n, slots=S)
    kw = dict(trace=True, hist=kernel.init_hist(device=dev), nem=sc.nem,
              device=dev)
    if sc.join_round is not None:
        kw["join_round"] = sc.join_round
    if sc.nem.needs_state:
        kw["nem_state"] = kernel.init_nem_state(n, device=dev)
    st = kernel.init_state(p, device=dev)
    args = (st, prng.key(seed), sc.fail_round, p, steps)
    if ndev is None:
        return kernel.run_rounds(*args, **kw)
    return kernel.run_rounds_sharded(*args, ndev=ndev, **kw)


def _nem_run_cpu(name: str, n: int, S: int, steps: int, seed: int):
    """``_nem_run`` on the CPU, in a worker process: the carry and the
    trace as numpy, field by field."""
    torch.set_num_threads(1)
    return _as_numpy(*_nem_run(name, n, S, steps, seed, "cpu"))


def _as_numpy(carry, tr):
    from consul_tpu_torch.gossip import convert
    return ([(type(t).__name__, convert.state_to_numpy(t)) for t in carry],
            convert.state_to_numpy(tr))


def _diverged_np(a, b) -> list:
    """Fields that differ between two ``_as_numpy`` results."""
    (ca, ta), (cb, tb) = a, b
    out = []
    for (name, x), (_, y) in list(zip(ca, cb)) + [(("RoundTrace", ta),
                                                   ("RoundTrace", tb))]:
        out += [f"{name}.{f}" for f in x
                if x[f].dtype != y[f].dtype or not np.array_equal(x[f], y[f])]
    return out


def nemesis_full_path(cpu, n: int, S: int, seed: int) -> dict:
    """All six catalog scenarios at n = 16,000 on the card, each against
    the port's CPU run (``cpu``: scenario -> the future of its worker
    process) and against the card's run on 8 column shards: every field
    of the state, the hist banks, NemState and the trace bit-identical."""
    from consul_tpu_torch.gossip import fused

    rows, bad = {}, []
    t0 = time.perf_counter()
    for name, steps in NEM_STEPS.items():
        _reset_counts()
        t1 = time.perf_counter()
        card = _nem_run(name, n, S, steps, seed, "cuda")
        torch.cuda.synchronize()
        cuda_s = time.perf_counter() - t1
        drops = fused.drop_launches
        t1 = time.perf_counter()
        card8 = _nem_run(name, n, S, steps, seed, "cuda", ndev=8)
        torch.cuda.synchronize()
        cuda8_s = time.perf_counter() - t1
        single = _as_numpy(*card)
        rows[name] = {
            "steps": steps, "cuda_s": cuda_s, "cuda_8_shards_s": cuda8_s,
            "drop_launches": drops,
            "merge_drop_launches": fused.merge_drop_launches,
            "n_detected": int(card[0][0].n_detected),
            "n_false_dead": int(card[0][0].n_false_dead),
            "drops": int(card[0][0].drops),
            "diverged_8_shards": _diverged_np(single, _as_numpy(*card8))}
        del card, card8
        t1 = time.perf_counter()
        rows[name]["diverged_cpu"] = _diverged_np(single, cpu[name].result())
        rows[name]["cpu_wait_s"] = time.perf_counter() - t1
    res = {"phase": "nemesis_full_path", "n": n, "slots": S, "seed": seed,
           "seconds": time.perf_counter() - t0, "scenarios": rows}
    emit(res)
    for name, row in rows.items():
        if row["diverged_cpu"] or row["diverged_8_shards"]:
            bad.append(name)
        partition = name in ("partition_heal", "asym_loss")
        if partition and not (row["drop_launches"] > 0
                              and row["merge_drop_launches"] > 0):
            bad.append(f"{name}: no launch with a drop operand")
    if bad:
        raise AssertionError(f"nemesis_full_path: {bad}")
    return res


def nemesis_main_path(n: int = 1_000_000, S: int = 64, warm: int = 10,
                      before: int = 30, first: int = 30, inside: int = 60,
                      ndev: int | None = None):
    """``partition_heal`` at 1M nodes: rounds/s in a block of rounds
    before the fault window (rounds [warm, 40)), in the window's first
    ``first`` rounds and in the ``inside`` rounds after those, each block
    ending in a device->host read; launches with a drop operand, host
    syncs per round.  Returns the result line and the final state."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.nemesis import build
    from consul_tpu_torch.gossip.params import lan_profile

    sc = build("partition_heal", n)
    assert warm + before == sc.nem.start
    p = lan_profile(n, slots=S, hot_slots=0, dissem="fused")
    fail_t = torch.from_numpy(sc.fail_round).cuda()
    join_t = torch.from_numpy(sc.join_round).cuda()
    key = prng.key(42)

    def rounds(state, steps):
        kw = dict(join_round=join_t, nem=sc.nem)
        if ndev is None:
            return kernel.run_rounds(state, key, fail_t, p, steps, **kw)[0]
        return kernel.run_rounds_sharded(state, key, fail_t, p, steps,
                                         ndev=ndev, **kw)[0]

    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    state = rounds(kernel.init_state(p), warm)
    int(state.round)
    times = {}
    blocks = {"before": before, "first": first, "inside": inside}
    for label, steps in blocks.items():
        t0 = time.perf_counter()
        state = rounds(state, steps)
        int(state.round)
        times[label] = time.perf_counter() - t0
    total = warm + before + first + inside
    tails = dict(kernel.tail_rounds)
    res = {"phase": ("nemesis_main_path" if ndev is None
                     else "sharded_nemesis_main_path"),
           "scenario": "partition_heal", "n": n, "slots": S, "ndev": ndev,
           "window": [sc.nem.start, sc.nem.stop], "rounds": total,
           "block_rounds": blocks, "block_s": times,
           "rounds_per_s_before_window": before / times["before"],
           "rounds_per_s_window_first": first / times["first"],
           "rounds_per_s_inside_window": inside / times["inside"],
           "tail_rounds": tails,
           "kernel_launches": fused.launches,
           "merge_launches": fused.merge_launches,
           "drop_launches": fused.drop_launches,
           "merge_drop_launches": fused.merge_drop_launches,
           "host_syncs_per_round": kernel.host_syncs / total,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "n_false_dead": int(state.n_false_dead),
           "n_refuted": int(state.n_refuted), "drops": int(state.drops),
           "slots_live": int((state.slot_node >= 0).sum())}
    emit(res)
    launched = (fused.drop_launches if ndev is None
                else fused.merge_drop_launches)
    # Every round inside the window runs the tail with the drops; the
    # bisection opens far more episodes than there are slots.
    if launched != first + inside or res["drops"] == 0:
        raise AssertionError(f"{res['phase']}: {launched} launches with a "
                             f"drop operand in {first + inside} rounds "
                             f"inside the window, drops {res['drops']}")
    return res, state


# -- the event flood -----------------------------------------------------------

def _events_16k(dev, p, alive, fires, seed):
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import events

    key = prng.key(seed)
    al = torch.from_numpy(alive).to(dev)
    st = events.init_events(p, slots=64, device=dev)
    covs = []
    for nodes, steps in fires:
        st = events.fire_events(st, torch.from_numpy(nodes))
        st, cov = events.run_event_rounds(st, key, al, p, steps)
        covs.append(cov)
    return st, torch.cat(covs)


def events_phase(seed: int = 21) -> dict:
    """The event flood on the card against the CPU at n = 16,000, then
    its time and its coverage gate at [64, 1M]."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import events
    from consul_tpu_torch.gossip.params import SwimParams, lan_profile

    n = 16_000
    # push/pull every 10 rounds: 30 push/pull rounds, and slots freed by
    # GC (event_ttl_rounds = 155) before the second batch fires.
    p = lan_profile(n, pushpull_every=10)
    rng = np.random.default_rng(seed)
    alive = rng.random(n) >= 0.1
    first = rng.integers(0, n, 72).astype(np.int32)
    first[[3, 17, 40]] = -1
    first[50:54] = first[10]          # repeated nodes; 69 fires > 64 slots
    second = rng.integers(0, n, 12).astype(np.int32)
    second[5] = -1
    fires = [(first, 200), (second, 100)]
    t0 = time.perf_counter()
    st_g, cov_g = _events_16k("cuda", p, alive, fires, seed)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    st_c, cov_c = _events_16k("cpu", p, alive, fires, seed)
    diverged = _diverged([(st_g, st_c)])
    if not torch.equal(cov_g.cpu(), cov_c):
        diverged.append("coverage")
    drops = int(st_c.drops)

    # [64, 1M] with the plane's parameters (SwimParams defaults).
    N = 1_000_000
    pm = SwimParams(n=N, slots=64)
    key = prng.key(seed)
    alive_m = torch.ones(N, dtype=torch.bool, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    st = events.init_events(pm, slots=64, device="cuda")
    st = events.fire_events(st, torch.tensor([12345], dtype=torch.int32))
    st, cov = events.run_event_rounds(st, key, alive_m, pm,
                                      pm.event_ttl_rounds)
    trace = cov[:, 0].cpu().tolist()
    reached = next((r + 1 for r, c in enumerate(trace) if c >= 0.99), None)
    st = events.fire_events(st, torch.from_numpy(
        rng.integers(0, N, 64).astype(np.int32)))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    st, cov = events.run_event_rounds(st, key, alive_m, pm, 100)
    int(st.round)
    end.record()
    end.synchronize()
    res = {"phase": "events", "n": n, "slots": 64, "rounds": 300,
           "drops": drops, "cuda_s": cuda_s, "diverged": diverged,
           "n_1m": N, "event_ttl_rounds": pm.event_ttl_rounds,
           "coverage_trace_1m": trace, "rounds_to_coverage_99": reached,
           "event_round_ms_1m": start.elapsed_time(end) / 100,
           "max_memory_allocated_1m": torch.cuda.max_memory_allocated()}
    emit(res)
    if diverged:
        raise AssertionError(f"card and CPU event floods diverged in "
                             f"{diverged}")
    if drops == 0:
        raise AssertionError("the 16,000-node flood overflowed no slot")
    if reached is None:
        raise AssertionError(f"one event did not reach 0.99 of 1M nodes "
                             f"within {pm.event_ttl_rounds} rounds: {trace}")
    return res


# -- the gossip plane ------------------------------------------------------------

EV_JOIN, EV_FAILED = "member-join", "member-failed"


class _Client:
    """A minimal bridge client: 4-byte big-endian length + msgpack, a
    heartbeat at the welcome's interval, every received frame kept."""

    def __init__(self, name: str):
        self.name = name
        self.frames = []
        self.beating = True
        self._tasks = []

    def send(self, msg: dict) -> None:
        raw = msgpack.packb(msg, use_bin_type=True)
        self.writer.write(struct.pack(">I", len(raw)) + raw)

    async def _read(self) -> dict:
        (ln,) = struct.unpack(">I", await self.reader.readexactly(4))
        return msgpack.unpackb(await self.reader.readexactly(ln), raw=False)

    async def start(self, port: int) -> None:
        self.reader, self.writer = await asyncio.open_connection(
            "127.0.0.1", port)
        self.send({"t": "register", "name": self.name, "addr": "127.0.0.1",
                   "port": 0, "tags": {"role": "node"}})
        self.welcome = await self._read()
        if self.welcome.get("t") != "welcome":
            raise AssertionError(f"{self.name}: {self.welcome}")
        loop = asyncio.get_running_loop()
        self._tasks = [loop.create_task(self._pump()),
                       loop.create_task(self._beat())]

    async def _pump(self) -> None:
        while True:
            self.frames.append(await self._read())

    async def _beat(self) -> None:
        period = self.welcome["hb_interval_s"]
        while self.beating:
            self.send({"t": "hb"})
            await asyncio.sleep(period)

    def members_with(self, kind: str) -> set:
        out = set()
        for f in self.frames:
            evs = (f["events"] if f["t"] == "evbatch" else
                   [f] if f["t"] == "ev" else [])
            out |= {e["node"]["name"] for e in evs if e["kind"] == kind}
        return out

    def got_user(self, name: str) -> bool:
        return any(f["t"] == "user" and f["name"] == name
                   for f in self.frames)

    async def query(self, t: str, timeout: float = 60.0, **kw) -> dict:
        seen = len(self.frames)
        self.send({"t": t, **kw})
        await _until(lambda: any(f["t"] == t for f in self.frames[seen:]),
                     timeout, f"{self.name}: {t} reply")
        return next(f for f in self.frames[seen:] if f["t"] == t)

    async def close(self) -> None:
        for task in self._tasks:
            task.cancel()
        if getattr(self, "writer", None) is not None:
            self.writer.close()


async def _until(cond, timeout: float, what: str) -> float:
    t0 = time.perf_counter()
    while not cond():
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"timed out after {timeout} s: {what}")
        await asyncio.sleep(0.02)
    return time.perf_counter() - t0


async def _plane_run(ndev: int, full: bool, n_clients: int = 8) -> dict:
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip import plane as gp

    cfg = gp.PlaneConfig(
        bind_port=0, capacity=1024, sim_nodes=998_976, slots=64,
        event_slots=64, gossip_interval_s=0.02, probe_every=5,
        suspicion_mult=1.0, hb_lapse_s=0.3, shard_devices=ndev)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    plane = gp.GossipPlane(cfg)
    t0 = time.perf_counter()
    await plane.start()
    res = {"phase": "plane", "n": plane.n_universe, "ndev": plane._ndev,
           "start_s": time.perf_counter() - t0}
    # The event-coverage observable after every event dispatch (the
    # flood's slot is recycled event_ttl_rounds after it fires).
    cov_max = {}
    event_dispatch = plane._dispatch_events

    def tracked():
        event_dispatch()
        if plane._ev_meta:
            for s, c in plane.event_coverage().items():
                cov_max[s] = max(cov_max.get(s, 0.0), c)

    plane._dispatch_events = tracked
    clients = [_Client(f"agent-{i}") for i in range(n_clients)]
    try:
        t_serve = time.perf_counter()
        await asyncio.gather(*(c.start(plane.local_addr[1]) for c in clients))
        names = {c.name for c in clients}
        res["join_s"] = await _until(lambda: all(
            c.members_with(EV_JOIN) >= names - {c.name} for c in clients),
            60, "member-join for every other client")
        if full:
            clients[0].send({"t": "event", "name": "deploy",
                             "payload": b"v2", "coalesce": True})
            res["user_event_s"] = await _until(lambda: all(
                c.got_user("deploy") for c in clients), 30,
                "the user event at every client")
            res["coverage_s"] = await _until(
                lambda: max(cov_max.values(), default=0.0) >= 0.99, 30,
                "event coverage >= 0.99")
            res["event_coverage_max"] = max(cov_max.values())
        victim, others = clients[-1], clients[:-1]
        victim.beating = False
        res["failure_s"] = await _until(lambda: all(
            victim.name in c.members_with(EV_FAILED) for c in others),
            120, f"member-failed for {victim.name} at every other client")
        res["failed_others"] = sorted(
            set().union(*(c.members_with(EV_FAILED) for c in others))
            - {victim.name})
        stats = await others[0].query("stats")
        res["rounds"] = plane._rounds_done
        res["rounds_per_s"] = plane._rounds_done / (time.perf_counter()
                                                    - t_serve)
        res["kernel"] = stats["kernel"]
        if full:
            res["members"] = len((await others[0].query("members"))
                                 ["members"])
            device = await others[0].query("device")
            disp = device["dispatch"]["round_step"]
            res["dispatch"] = {"count": disp["count"],
                               "p50_ms": disp["p50_ms"],
                               "p99_ms": disp["p99_ms"],
                               "mean_ms": disp["sum_ms"] / disp["count"]}
            res["compile_wall_s"] = device["compile"]["wall_s"]
            res["roofline"] = device["roofline"]
            res["device_rows"] = device["devices"]
            profile = await others[0].query("profile", steps=8)
            res["profile"] = {k: profile.get(k) for k in (
                "rounds", "round_ms", "device_ms_per_round",
                "roofline_utilization", "error")}
            # The card's idle share in an unprofiled dispatch: its busy
            # time per round (profiled) over the host's (dispatch mean).
            if profile.get("device_ms_per_round") is not None:
                res["device_idle_share"] = 1 - (
                    profile["device_ms_per_round"]
                    / (res["dispatch"]["mean_ms"] / gp.STEPS_PER_TICK))
    finally:
        for c in clients:
            await c.close()
        await plane.stop()
    res.update(dissem_launches=fused.launches,
               merge_launches=fused.merge_launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    return res


def plane_phase(ndev: int, full: bool) -> dict:
    """The plane on the card serving bridge clients; its ticker swallows
    tick errors onto stderr, so stderr is captured and searched."""
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            res = asyncio.run(_plane_run(ndev, full))
    finally:
        sys.stderr.write(err.getvalue())
    res["tick_errors"] = err.getvalue().count("[gossip-plane] tick error")
    emit(res)
    launches = res["merge_launches"] if ndev > 1 else res["dissem_launches"]
    if res["tick_errors"] or res["failed_others"] or launches <= 0:
        raise AssertionError(f"plane (shard_devices={ndev}): tick errors "
                             f"{res['tick_errors']}, failed others "
                             f"{res['failed_others']}, launches {launches}")
    if res["kernel"]["n_false_dead"] != 0:
        raise AssertionError(f"plane: n_false_dead {res['kernel']}")
    if full:
        row = res["device_rows"][0] if res["device_rows"] else {}
        if not (row.get("hbm_bytes_limit", 0) > 0
                and row.get("hbm_bytes_in_use", 0) > 0):
            raise AssertionError(f"device frame without the card's memory: "
                                 f"{res['device_rows']}")
        if res["profile"]["error"] is not None:
            raise AssertionError(f"profile frame: {res['profile']}")
    return res


async def _plane_nemesis_run(n_clients: int = 8, rounds: int = 200) -> dict:
    """The plane at universe 1M under ``partition_heal`` (window [40,
    160), then the heal) serving ``n_clients`` bridge clients, until
    ``rounds`` rounds have run."""
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip import plane as gp

    cfg = gp.PlaneConfig(
        bind_port=0, capacity=1024, sim_nodes=998_976, slots=64,
        event_slots=64, gossip_interval_s=0.02, probe_every=5,
        suspicion_mult=1.0, hb_lapse_s=0.3, shard_devices=1,
        nemesis="partition_heal")
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    plane = gp.GossipPlane(cfg)
    await plane.start()
    res = {"phase": "plane_nemesis", "scenario": cfg.nemesis,
           "n": plane.n_universe, "ndev": plane._ndev}
    clients = [_Client(f"agent-{i}") for i in range(n_clients)]
    try:
        t_serve = time.perf_counter()
        await asyncio.gather(*(c.start(plane.local_addr[1]) for c in clients))
        names = {c.name for c in clients}
        res["join_s"] = await _until(lambda: all(
            c.members_with(EV_JOIN) >= names - {c.name} for c in clients),
            60, "member-join for every other client")
        await _until(lambda: plane._rounds_done >= rounds, 120,
                     f"{rounds} rounds of the plane")
        res["rounds"] = plane._rounds_done
        res["rounds_per_s"] = plane._rounds_done / (time.perf_counter()
                                                    - t_serve)
        slo = await clients[0].query("slo")
        res["slo_scenario"] = slo.get("scenario")
        res["slo_scenarios"] = sorted(slo.get("scenarios", {}))
        res["kernel"] = (await clients[0].query("stats"))["kernel"]
        disp = (await clients[0].query("device"))["dispatch"]["round_step"]
        res["dispatch"] = {"count": disp["count"], "p50_ms": disp["p50_ms"],
                           "p99_ms": disp["p99_ms"],
                           "mean_ms": disp["sum_ms"] / disp["count"]}
        res["member_failed_seen"] = sorted(
            set().union(*(c.members_with(EV_FAILED) for c in clients)))
    finally:
        for c in clients:
            await c.close()
        await plane.stop()
    res.update(dissem_launches=fused.launches,
               drop_launches=fused.drop_launches,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    return res


class _Recorder:
    """A bridge writer that keeps every frame it is sent."""

    def __init__(self):
        self.frames = []

    def write(self, raw):
        self.frames.append(bytes(raw))

    def close(self):
        pass


def _plane_lockstep(n: int = 16_384, dispatches: int = 15) -> dict:
    """The plane on the card and on the CPU under ``partition_heal``,
    same config and key, driven by one script without sockets: after
    every dispatch every state field and every frame sent must be
    identical."""
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import convert
    from consul_tpu_torch.gossip import plane as gp

    t0 = time.perf_counter()
    loop = asyncio.new_event_loop()
    journey, gp._journey.journey = gp._journey.journey, None
    planes = [gp.GossipPlane(gp.PlaneConfig(
        bind_port=0, capacity=32, sim_nodes=n - 32, slots=64, event_slots=8,
        gossip_interval_s=0.02, probe_every=5, suspicion_mult=1.0,
        hb_lapse_s=0.3, shard_devices=1, dissem="fused", hot_slots=0,
        fused_nb=1, unroll=1, flight_drain_every=2, nemesis="partition_heal",
        device=dev)) for dev in ("cuda", "cpu")]
    bad = []
    try:
        for plane in planes:
            loop.run_until_complete(plane.start())
            plane._tick_task.cancel()  # the script dispatches
            plane._key = prng.key(20260)
        writers = []
        for i in range(6):
            msg = {"t": "register", "name": f"n{i}", "addr": "127.0.0.1",
                   "port": 7000 + i, "tags": {"role": "node"}}
            pair = (_Recorder(), _Recorder())
            writers.append(pair)
            for plane, w in zip(planes, pair):
                plane._register(dict(msg), w)
        for d in range(dispatches):
            for plane in planes:
                plane._dispatch()
            g, c = planes
            for a, b in ((g._state, c._state), (g._ev_state, c._ev_state),
                         (g._flight, c._flight), (g._hist, c._hist)):
                x, y = convert.state_to_numpy(a), convert.state_to_numpy(b)
                bad += [f"dispatch {d}: {type(a).__name__}.{f}" for f in x
                        if not np.array_equal(x[f], y[f])]
            bad += [f"dispatch {d}: frames" for wg, wc in writers
                    if wg.frames != wc.frames]
        frames = sum(len(wg.frames) for wg, _ in writers)
        slo = [p._slo_wire() for p in planes]
        if slo[0] != slo[1]:
            bad.append("slo frame")
    finally:
        for plane in planes:
            loop.run_until_complete(plane.stop())
        loop.close()
        gp._journey.journey = journey
    return {"n": n, "dispatches": dispatches, "rounds": 4 * dispatches,
            "frames_compared": frames, "diverged": bad,
            "seconds": time.perf_counter() - t0}


def plane_nemesis_phase() -> dict:
    """The plane under ``partition_heal`` on the card (its ticker's
    errors captured from stderr), then the card plane in lockstep with
    the CPU plane.  A full bisection may rightly declare agents dead, so
    member-failed is reported, not gated."""
    from consul_tpu_torch.gossip import fused

    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            res = asyncio.run(_plane_nemesis_run())
    finally:
        sys.stderr.write(err.getvalue())
    res["tick_errors"] = err.getvalue().count("[gossip-plane] tick error")
    drops0 = fused.drop_launches
    res["lockstep"] = _plane_lockstep()
    res["lockstep"]["drop_launches"] = fused.drop_launches - drops0
    emit(res)
    if (res["tick_errors"] or res["drop_launches"] <= 0
            or res["slo_scenario"] != "partition_heal"
            or res["lockstep"]["diverged"]
            or res["lockstep"]["drop_launches"] <= 0):
        raise AssertionError(
            f"plane_nemesis: tick errors {res['tick_errors']}, launches "
            f"with a drop operand {res['drop_launches']}, slo scenario "
            f"{res['slo_scenario']}, lockstep {res['lockstep']}")
    return res


# -- the daemon ------------------------------------------------------------------

def _frame(sock: socket.socket) -> dict:
    def exact(n):
        buf = b""
        while len(buf) < n:
            chunk = sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("gossipd closed the connection")
            buf += chunk
        return buf
    (ln,) = struct.unpack(">I", exact(4))
    return msgpack.unpackb(exact(ln), raw=False)


def gossipd_phase(timeout: float = 120.0) -> dict:
    """``python -m consul_tpu_torch.gossipd -nemesis partition_heal`` on
    the card: register, welcome, stats, SIGTERM, exit 0."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "consul_tpu_torch.gossipd", "-port", "0",
         "-capacity", "64", "-sim-nodes", "960", "-gossip-interval", "0.05",
         "-nemesis", "partition_heal"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    try:
        ready, _, _ = select.select([proc.stdout], [], [], timeout)
        line = proc.stdout.readline() if ready else ""
        if "==> gossip plane running at" not in line:
            raise AssertionError(f"gossipd did not come up: {line!r}")
        start_s = time.perf_counter() - t0
        host, port = line.split(" at ")[1].split()[0].rsplit(":", 1)
        with socket.create_connection((host, int(port)), timeout=30) as sock:
            def send(msg):
                raw = msgpack.packb(msg, use_bin_type=True)
                sock.sendall(struct.pack(">I", len(raw)) + raw)
            send({"t": "register", "name": "probe", "addr": "127.0.0.1",
                  "port": 0, "tags": {}})
            welcome = _frame(sock)
            send({"t": "stats"})
            stats = _frame(sock)
            while stats["t"] != "stats":
                stats = _frame(sock)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err = proc.stderr.read()
    res = {"phase": "gossipd", "line": line.strip(), "start_s": start_s,
           "welcome_id": welcome.get("id"), "stats_capacity":
           stats.get("capacity"), "rc": rc}
    emit(res)
    if (welcome.get("t") != "welcome" or rc != 0
            or "nemesis=partition_heal" not in line):
        raise AssertionError(f"gossipd: rc {rc}, welcome {welcome}, "
                             f"stderr {err[-2000:]}")
    return res


def _churn_gates(res: dict, launches_key: str) -> None:
    if res["n_detected"] <= 0 or res["n_false_dead"] != 0:
        raise AssertionError(
            f"{res['phase']}: n_detected={res['n_detected']} "
            f"n_false_dead={res['n_false_dead']}")
    if res[launches_key] <= 0:
        raise AssertionError(f"{res['phase']} launched no kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "GPU", file=sys.stderr)
        return 2
    if not (ROOT / "consul_tpu_torch").is_dir():
        print("chip_smoke: the port package consul_tpu_torch is not beside "
              "this script; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    # The CPU runs that the card's runs are held against go to worker
    # processes at once (one thread each), and compute while the kernel
    # phases run; every one has finished before the first timed main
    # path.
    pool = ProcessPoolExecutor(
        1 + len(NEM_STEPS), mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_full = pool.submit(_full_path_cpu, **FULL_PATH)
        cpu_nem = {name: pool.submit(_nem_run_cpu, name, NEM["n"], NEM["S"],
                                     steps, NEM["seed"])
                   for name, steps in NEM_STEPS.items()}
        card()
        build()
        sass = sass_phase()
        big = kernel_vs_plain(64, 1_000_000, seed=1, sass=sass)
        kernel_vs_plain(8, 1_000_000, seed=2, sass=sass)
        kernel_vs_plain(64, 16_001, seed=5, sass=sass)
        mbig = merge_vs_plain(64, 1_000_000, 8, seed=3, sass=sass)
        merge_vs_plain(8, 1_000_000, 8, seed=4, sass=sass)
        for ndev in (1, 2, 4, 8):
            merge_vs_plain(64, 16_000, ndev, seed=6 + ndev, sass=sass)
        repeat(8, 1_000_000, seeds=256)
        repeat(8, 1_000_000, seeds=128, ndev=8)
        repeat(64, 1_000_000, seeds=16)
        single = full_path(cpu_full, **FULL_PATH)
        sharded_full_path(single, **FULL_PATH)
        del single
        nemesis_full_path(cpu_nem, **NEM)
        pool.shutdown()
        churn, churn_state = main_path(1_000_000, 64, 1000, warm=50,
                                       block=100, blocks=3)
        _churn_gates(churn, "kernel_launches")
        sharded, sharded_state = main_path(1_000_000, 64, 1000, warm=50,
                                           block=100, blocks=3, ndev=8)
        _churn_gates(sharded, "merge_launches")
        if sharded["host_syncs_per_round"] != churn["host_syncs_per_round"]:
            raise AssertionError("the sharded round reads the device more "
                                 "often than the single-device round")
        diverged = _diverged([(churn_state, sharded_state)])
        emit({"phase": "sharded_main_path_parity", "diverged": diverged,
              "rounds_per_s_mean": {"single": churn["rounds_per_s_mean"],
                                    "sharded": sharded["rounds_per_s_mean"]}})
        if diverged:
            raise AssertionError(f"sharded and single-device 1M churn runs "
                                 f"diverged in {diverged}")
        del churn_state, sharded_state
        main_path(1_000_000, 64, 0, warm=20, block=100, blocks=3)
        nem1, nem1_state = nemesis_main_path()
        nem8, nem8_state = nemesis_main_path(ndev=8)
        if nem8["host_syncs_per_round"] != nem1["host_syncs_per_round"]:
            raise AssertionError("under nemesis the sharded round reads the "
                                 "device more often than the single-device "
                                 "round")
        diverged = _diverged([(nem1_state, nem8_state)])
        emit({"phase": "sharded_nemesis_main_path_parity",
              "diverged": diverged})
        if diverged:
            raise AssertionError(f"sharded and single-device 1M "
                                 f"partition_heal runs diverged in "
                                 f"{diverged}")
        del nem1_state, nem8_state
        events_phase()
        plane1 = plane_phase(1, full=True)
        plane8 = plane_phase(8, full=False)
        plane_nem = plane_nemesis_phase()
        gossipd_phase()
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        pool.shutdown(cancel_futures=True)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": [{
        "name": "fused_dissem", "route": "cuda",
        "source": "consul_tpu_torch/csrc/dissem_tail.cu",
        "replaces": "consul_tpu/gossip/fused.py:141",
        "launches": churn["kernel_launches"],
        "plane_launches": plane1["dissem_launches"],
        "nemesis_launches": nem1["drop_launches"],
        "plane_nemesis_launches": plane_nem["drop_launches"],
        "max_abs_err": big["max_abs_err"], "ms": big["ms"],
        "ms_drop": big["ms_drop"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_ms_drop": big["bound_ms_drop"],
        "bound_by": big["bound_by"], "library_ms": None}, {
        "name": "fused_merge", "route": "cuda",
        "source": "consul_tpu_torch/csrc/dissem_tail.cu",
        "replaces": "consul_tpu/gossip/fused.py:199",
        "launches": sharded["merge_launches"],
        "plane_launches": plane8["merge_launches"],
        "nemesis_launches": nem8["merge_drop_launches"],
        "max_abs_err": mbig["max_abs_err"], "ms": mbig["ms"],
        "ms_drop": mbig["ms_drop"],
        "plain_ms": mbig["plain_ms"], "bound_ms": mbig["bound_ms"],
        "bound_ms_drop": mbig["bound_ms_drop"],
        "bound_by": mbig["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
