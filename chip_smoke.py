#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``consul_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Each phase prints one JSON line; any failure exits non-zero and the
result lines are not printed.

1. card: ``nvidia-smi`` name and power limit, torch's device name/count.
2. build: ``csrc/fused_dissem.cu`` with nvcc for sm_90a (ptxas report).
3. kernel: the Hopper dissemination kernel against its plain torch
   version on the card, adversarial bytes at [64, 1M] and [8, 1M],
   offsets including 1 and N-1; byte-identical results required; kernel
   time (CUDA events over warm launches), the plain version's time and
   the bound: the larger of the bytes over the memory rate and the
   per-byte rule's operations, packed four bytes to a 32-bit word, over
   the CUDA cores' 32-bit integer rate.
4. full_path: ``run_rounds`` at n=16,000, S=64 (lan_profile, churn,
   loss, joins, flight ring, hist banks, trace) once on the card and
   once on the CPU; every field of the carry and the trace must be
   bit-identical.
5. main_path: ``lan_profile(1_000_000, slots=64, hot_slots=0)`` with
   bench.py's churn1000ppm failure stride — warm-up, timed blocks each
   ending in a device->host read; rounds/s, kernel launches (must equal
   the non-quiescent rounds), host syncs per round, peak device memory;
   ``n_detected > 0`` and ``n_false_dead == 0`` required.  Then the
   healthy regime (no churn) for rounds/s.

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
from pathlib import Path

import numpy as np
import torch

NEVER = 2**31 - 1
# H100 SXM peaks (NVIDIA data sheet, 700 W): the device memory rate, and
# the 8-bit integer rate of the tensor cores.  The merge's compares, maxima
# and selects cannot run on tensor cores: they run on the CUDA cores' 64
# INT32 lanes per SM, half the 128 FP32 lanes behind the sheet's 67 TFLOP/s
# of float32 (an FMA counts 2 FLOPs), so 67e12 / 4 integer ops/s.
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


def build() -> None:
    from consul_tpu_torch import _build
    t0 = time.perf_counter()
    so = _build.build("fused_dissem")
    log = _build.build_logs.get("fused_dissem", "(already built)")
    for ln in log.strip().splitlines():
        print(f"  nvcc: {ln}", flush=True)
    emit({"phase": "build", "library": so.name,
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


def kernel_vs_plain(S: int, N: int, seed: int) -> dict:
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(N, slots=S)
    heard, mf, rx_ok, cap = adversarial(S, N, seed, "cuda")
    rnd = 50
    offs = [1, N - 1, int(np.random.default_rng(seed).integers(2, N - 1))]
    budget = p.spread_budget_rounds

    def kern():
        return fused.fused_dissem(heard, offs, mf, rx_ok, cap, rnd, budget)

    def plain():
        return fused.disseminate_ref(p, rnd, offs, heard, mf, rx_ok, cap)

    out_k, out_p = kern(), plain()
    torch.cuda.synchronize()
    err = int((out_k.to(torch.int32) - out_p.to(torch.int32)).abs().max())
    if err != 0:
        n_bad = int((out_k != out_p).sum())
        raise AssertionError(f"kernel != plain at [{S}, {N}]: {n_bad} bytes "
                             f"differ, max abs err {err}")
    ms = cuda_ms(kern, 200)
    plain_ms = cuda_ms(plain, 5, warm=1)
    # The least the function must move: heard read once, out written
    # once, mf (int32), rx (1 byte) and cap (int32) read once.
    nbytes = 2 * S * N + 5 * N + 4 * S
    # The operations of the per-byte rule, counted from disseminate_ref:
    # 10 to age the current byte, 18 per leg (age the pin, gate it,
    # priority-max, count suspects), 22 to merge and pack; plus one
    # sender-liveness compare per leg and column.
    nops = S * N * (32 + 18 * len(offs)) + N * len(offs)
    # A SWAR form does each byte operation on four bytes of a 32-bit word
    # (it needs extra masking, so this count is a floor).
    word_ops = nops // 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = word_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    res = {"phase": "kernel", "shape": [S, N], "offsets": offs,
           "tolerance": 0, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bytes": nbytes, "bytes_ms": bytes_ms,
           "byte_operations": nops, "word_operations": word_ops,
           "operations_ms": ops_ms,
           "int32_ops_per_s": INT32_OPS_PER_S,
           "operations_ms_at_int8_tensor_rate":
               nops / INT8_TENSOR_OPS_PER_S * 1e3,
           "int8_tensor_ops_per_s": INT8_TENSOR_OPS_PER_S,
           "bound_ms": bound_ms,
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "share_of_bound": bound_ms / ms, "library_ms": None}
    emit(res)
    return res


def _run(p, fail, join, member0, steps, seed, dev):
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import kernel

    st = kernel.init_state(p, device=dev)
    st = st._replace(member=torch.from_numpy(member0).to(dev))
    return kernel.run_rounds(
        st, prng.key(seed), fail, p, steps, trace=True, join_round=join,
        flight=kernel.init_flight(device=dev), hist=kernel.init_hist(device=dev),
        device=dev)


def full_path(n: int = 16_000, S: int = 64, steps: int = 300,
              seed: int = 11) -> None:
    from consul_tpu_torch.gossip import fused
    from consul_tpu_torch.gossip.params import lan_profile

    p = lan_profile(n, slots=S, dissem="fused", loss_rate=0.01)
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n)
    fail = np.full(n, NEVER, np.int32)
    fail[ids[:48]] = rng.integers(0, steps // 2, 48)
    join = np.full(n, NEVER, np.int32)
    join[ids[48:72]] = rng.integers(1, steps // 2, 24)
    member0 = join == NEVER

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

    diverged = []
    for a, b in ((st_g, st_c), (fl_g, fl_c), (hb_g, hb_c), (tr_g, tr_c)):
        for f in a._fields:
            x, y = getattr(a, f).cpu(), getattr(b, f)
            if x.dtype != y.dtype or not torch.equal(x, y):
                diverged.append(f"{type(a).__name__}.{f}")
    emit({"phase": "full_path", "n": n, "slots": S, "steps": steps,
          "kernel_launches": launches, "cuda_s": t_gpu, "cpu_s": t_cpu,
          "n_detected": int(st_c.n_detected),
          "n_refuted": int(st_c.n_refuted),
          "members": int(st_c.member.sum()), "diverged": diverged})
    if diverged:
        raise AssertionError(f"card and CPU runs diverged in {diverged}")
    if launches == 0 or int(st_c.n_detected) == 0:
        raise AssertionError("the full-path run exercised no dissemination")


def main_path(n: int, S: int, churn_ppm: int, warm: int, block: int,
              blocks: int) -> dict:
    """bench.py's LAN regime on the port: rounds/s over timed blocks."""
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

    torch.cuda.reset_peak_memory_stats()
    fused.launches = 0
    kernel.host_syncs = 0
    for k in kernel.tail_rounds:
        kernel.tail_rounds[k] = 0
    state = kernel.init_state(p)
    t0 = time.perf_counter()
    state, _ = kernel.run_rounds(state, key, fail_t, p, warm)
    int(state.round)
    warm_s = time.perf_counter() - t0
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        state, _ = kernel.run_rounds(state, key, fail_t, p, block)
        int(state.round)
        times.append(time.perf_counter() - t0)
    tails = dict(kernel.tail_rounds)
    res = {"phase": "main_path", "n": n, "slots": S, "churn_ppm": churn_ppm,
           "rounds": total, "warmup_s": warm_s, "block_rounds": block,
           "block_s": times,
           "rounds_per_s_mean": block * blocks / sum(times),
           "rounds_per_s_best_block": block / min(times),
           "kernel_launches": fused.launches, "tail_rounds": tails,
           "host_syncs_per_round": kernel.host_syncs / total,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "n_detected": int(state.n_detected),
           "n_false_dead": int(state.n_false_dead),
           "drops": int(state.drops)}
    emit(res)
    if fused.launches != tails["hot"] + tails["full"]:
        raise AssertionError("kernel launches != non-quiescent rounds")
    return res


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
        big = kernel_vs_plain(64, 1_000_000, seed=1)
        kernel_vs_plain(8, 1_000_000, seed=2)
        full_path()
        churn = main_path(1_000_000, 64, 1000, warm=50, block=100, blocks=3)
        if churn["n_detected"] <= 0 or churn["n_false_dead"] != 0:
            raise AssertionError(
                f"churn regime: n_detected={churn['n_detected']} "
                f"n_false_dead={churn['n_false_dead']}")
        if churn["kernel_launches"] <= 0:
            raise AssertionError("the main path launched no kernel")
        main_path(1_000_000, 64, 0, warm=20, block=100, blocks=3)
    except Exception:
        traceback.print_exc()
        return 1
    emit({"kernels": [{
        "name": "fused_dissem", "route": "cuda",
        "source": "consul_tpu_torch/csrc/fused_dissem.cu",
        "replaces": "consul_tpu/gossip/fused.py:141",
        "launches": churn["kernel_launches"],
        "max_abs_err": big["max_abs_err"], "ms": big["ms"],
        "plain_ms": big["plain_ms"], "bound_ms": big["bound_ms"],
        "bound_by": big["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
