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
   version on the card, adversarial bytes at [64, 1M], [8, 1M] and the
   ragged [64, 16,001], each under offset triples that start with 1,
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
   once on the CPU; every field of the carry and the trace must be
   bit-identical.
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

Then the kernels line and, last, the ok line.  Needs one CUDA card:
without one it exits 2 before printing anything else.  Imports nothing
of JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

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


def _bound(S: int, N: int, F: int, sass: dict) -> dict:
    """The least time the card could take for the tail at [S, N] and
    fanout F: the bytes it must move over the memory rate, or its integer
    operations over the INT32 rate of the busiest unit, whichever is
    larger."""
    # heard read once, out written once; mf (int32), rx (1 byte) and cap
    # (int32) read once.
    nbytes = 2 * S * N + 5 * N + 4 * S
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


def kernel_vs_plain(S: int, N: int, seed: int, sass: dict) -> dict:
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(N, slots=S)
    heard, mf, rx_ok, cap = adversarial(S, N, seed, "cuda")
    rnd = 50
    budget = p.spread_budget_rounds
    sets = _offset_sets(N, N, seed)

    def kern(offs=sets[0]):
        return fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd, budget)

    def plain(offs=sets[0]):
        return fused.disseminate_ref(p, rnd, offs, heard, mf, rx_ok, cap)

    err = max(_held("fused_dissem", [S, N], lambda: kern(o),
                    lambda: plain(o)) for o in sets)
    ms = graph_ms(kern)
    eager_ms = cuda_ms(kern, 200)
    plain_ms = cuda_ms(plain, 5, warm=1)
    bound = _bound(S, N, len(sets[0]), sass)
    res = {"phase": "kernel", "shape": [S, N], "offsets": sets[0],
           "offset_sets_held": len(sets), "tolerance": 0,
           "max_abs_err": err, "ms": ms, "eager_ms": eager_ms,
           "plain_ms": plain_ms, **bound,
           "share_of_bound": bound["bound_ms"] / ms, "library_ms": None}
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

    def kern(offs=sets[0]):
        return fused.fused_merge(shards, offs, mf, rx_ok, cap, rnd, budget)

    def plain(offs=sets[0]):
        return fused.merge_shards_ref(p, rnd, offs, shards, mf, rx_ok, cap,
                                      sc)

    err = max(_held("fused_merge", [S, N, ndev], lambda: kern(o),
                    lambda: plain(o)) for o in sets)
    ms = graph_ms(kern)
    eager_ms = cuda_ms(kern, 200)
    plain_ms = cuda_ms(plain, 5, warm=1)
    # The function is kernel 1's at [S, N]: its bytes and operations.
    bound = _bound(S, N, len(sets[0]), sass)
    res = {"phase": "merge_kernel", "shape": [S, N], "ndev": ndev, "L": L,
           "offsets": sets[0], "offset_sets_held": len(sets),
           "tolerance": 0, "max_abs_err": err, "ms": ms,
           "eager_ms": eager_ms, "plain_ms": plain_ms, **bound,
           "share_of_bound": bound["bound_ms"] / ms, "library_ms": None}
    emit(res)
    return res


def repeat(S: int, N: int, seeds: int, ndev: int | None = None,
           launches: int = 3) -> dict:
    """``fused_dissem`` (or, with ``ndev``, ``fused_merge`` on ndev
    shards) against its plain version over ``seeds`` fresh inputs, each
    with its own random offset triple, ``launches`` launches each: every
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
        if ndev is None:
            ref = (fused.disseminate_ref(p, rnd, offs, heard, mf, rx_ok,
                                         cap),)
        else:
            heard = tuple(h.contiguous() for h in heard.split(L, dim=1))
            ref = fused.merge_shards_ref(p, rnd, offs, heard, mf, rx_ok,
                                         cap, sc)
        for _ in range(launches):
            if ndev is None:
                out = (fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd,
                                          budget),)
            else:
                out = fused.fused_merge(heard, offs, mf, rx_ok, cap, rnd,
                                        budget)
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


def full_path(n: int = 16_000, S: int = 64, steps: int = 300,
              seed: int = 11):
    """Returns the card run's (carry, trace) for sharded_full_path."""
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(n, slots=S, dissem="fused", loss_rate=0.01)
    fail, join, member0 = _full_path_inputs(n, steps, seed)

    launches0 = fused.launches
    t0 = time.perf_counter()
    (st_g, fl_g, hb_g), tr_g = _run(p, fail, join, member0, steps, seed,
                                    "cuda")
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    launches = fused.launches - launches0
    t0 = time.perf_counter()
    (st_c, fl_c, hb_c), tr_c = _run(p, fail, join, member0, steps, seed,
                                    "cpu")
    t_cpu = time.perf_counter() - t0

    diverged = _diverged(((st_g, st_c), (fl_g, fl_c), (hb_g, hb_c),
                          (tr_g, tr_c)))
    emit({"phase": "full_path", "n": n, "slots": S, "steps": steps,
          "kernel_launches": launches, "cuda_s": t_gpu, "cpu_s": t_cpu,
          "n_detected": int(st_c.n_detected),
          "n_refuted": int(st_c.n_refuted),
          "members": int(st_c.member.sum()), "diverged": diverged})
    if diverged:
        raise AssertionError(f"card and CPU runs diverged in {diverged}")
    if launches == 0 or int(st_c.n_detected) == 0:
        raise AssertionError("the full-path run exercised no dissemination")
    return (st_g, fl_g, hb_g), tr_g


def sharded_full_path(single, n: int = 16_000, S: int = 64,
                      steps: int = 300, seed: int = 11,
                      ndev: int = 8) -> None:
    """full_path's run through run_rounds_sharded on the card, held
    against full_path's card run (``single``)."""
    from consul_tpu_torch.gossip import fused, kernel
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(n, slots=S, dissem="fused", loss_rate=0.01)
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
    if not (Path(__file__).resolve().parent / "consul_tpu_torch").is_dir():
        print("chip_smoke: the port package consul_tpu_torch is not beside "
              "this script; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    try:
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
        single = full_path()
        sharded_full_path(single)
        del single
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
    except Exception:
        traceback.print_exc()
        return 1
    emit({"kernels": [{
        "name": "fused_dissem", "route": "cuda",
        "source": "consul_tpu_torch/csrc/dissem_tail.cu",
        "replaces": "consul_tpu/gossip/fused.py:141",
        "launches": churn["kernel_launches"],
        "max_abs_err": big["max_abs_err"], "ms": big["ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "library_ms": None}, {
        "name": "fused_merge", "route": "cuda",
        "source": "consul_tpu_torch/csrc/dissem_tail.cu",
        "replaces": "consul_tpu/gossip/fused.py:199",
        "launches": sharded["merge_launches"],
        "max_abs_err": mbig["max_abs_err"], "ms": mbig["ms"],
        "plain_ms": mbig["plain_ms"], "bound_ms": mbig["bound_ms"],
        "bound_by": mbig["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
