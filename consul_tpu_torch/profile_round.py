"""Where a round's time goes: the port's main path, timed and profiled.

    python -m consul_tpu_torch.profile_round [--churn-ppm 1000] [--rounds 30]
                                             [--ndev N] [--nemesis SCENARIO]

Runs bench.py's LAN regime on the card (``lan_profile(N, SLOTS,
hot_slots=0)``, churn failures on a stride) for ``WARM`` rounds, then
twice ``--rounds`` more and prints one JSON line.  With ``--ndev N`` the
rounds are the sharded round (``run_rounds_sharded``, N column shards on
the card), and the phases add the sharded round's own: the halo pins
(``_roll_sharded``, which only the plain version runs now: the card's
merge reads its pins from the shards, so the phase must show no calls),
the merge kernel's launches (``fused_merge``, one per round for all
shards) and the probe tick's window read and write.  The single-device
round adds the launches of ``fused_dissem``.  With ``--nemesis`` the
rounds run under that scenario of the nemesis catalog
(``gossip/nemesis.py``; its kills join the churn failures), and the
profiled rounds lie inside its fault window (the warm-up ends at round
60; every scenario's window is open from round 40 to 160): the phase
``nemesis_drops`` is the partition's drop masks (their threefry draws
included), and ``dissem_launches``/``merge_launches`` the kernel launches,
each with its drop operand.

- pass A, no profiler: host time per round, and the host time and the
  calls per round of each round phase (the probe tick, the uniform draws
  inside it, the dissemination tail, the finish step, the kernel
  wrappers), each phase timed by a host clock around the round's own
  function; a kernel wrapper's host time over its calls is its host cost
  per launch;
- pass B, under torch.profiler: the device kernels' time per round (busy
  time), each phase's device time (the kernels launched inside it), the
  number of kernels per round, and the ops and kernels that take the
  most device time.

The device's idle share is ``1 - busy(B) / host time(A)``.  Phases are
timed by wrapping the round's functions for the duration of a pass; the
round's code is not changed.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from consul_tpu_torch import prng
from consul_tpu_torch.gossip import fused, kernel
from consul_tpu_torch.gossip.nemesis import build as build_nemesis
from consul_tpu_torch.gossip.params import lan_profile

N, SLOTS, WARM = 1_000_000, 64, 60  # the main path's size; warm-up rounds
PHASES = {  # label -> (module, attribute) of the function timed
    "probe_tick": (kernel, "_probe_tick"),
    "uniform_draws": (prng, "uniform_tensor"),
    "disseminate": (kernel, "_disseminate"),
    "finish_round": (kernel, "_finish_round"),
    "nemesis_drops": (kernel, "_nem_edge_drops"),
}
SINGLE_PHASES = {  # the single-device round's own
    "dissem_launches": (fused, "fused_dissem"),
}
SHARDED_PHASES = {  # the sharded round's own, inside the phases above
    "halo_pins": (fused, "_roll_sharded"),
    "merge_launches": (fused, "fused_merge"),
    "probe_window_read": (kernel, "_win_read"),
    "probe_window_write": (kernel, "_win_write"),
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


def device_kernels(prof, exclude=()) -> list:
    """The profile's device kernels (``key_averages`` rows on the card,
    except the labels in ``exclude``), busiest first."""
    return sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.key not in exclude),
                  key=lambda e: -self_device_us(e))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--churn-ppm", type=int, default=1000)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--ndev", type=int, default=0,
                    help="profile the sharded round on this many shards")
    ap.add_argument("--nemesis", default="",
                    help="run the rounds under this nemesis catalog "
                         "scenario, profiling rounds inside its window")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_round: needs a CUDA card")
    dev = torch.device("cuda")
    phases = dict(PHASES,
                  **(SHARDED_PHASES if args.ndev else SINGLE_PHASES))

    # The scenario's schedule and its Lifeguard registers, carried from
    # call to call (``nem_kw["nem_state"]``).
    nem_kw = {}

    def run(st, steps):
        if args.ndev:
            out = kernel.run_rounds_sharded(st, key, fail_t, p, steps,
                                            ndev=args.ndev, device=dev,
                                            **nem_kw)[0]
        else:
            out = kernel.run_rounds(st, key, fail_t, p, steps, device=dev,
                                    **nem_kw)[0]
        if nem_kw.get("nem_state") is not None:
            out, nem_kw["nem_state"] = out
        return out

    p = lan_profile(N, slots=SLOTS, hot_slots=0, dissem="fused")
    n_fail = max(1, N * args.churn_ppm // 1_000_000) if args.churn_ppm else 0
    total = WARM + args.rounds
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

    tails0 = dict(kernel.tail_rounds)
    host_s = {}
    state, wall_a = measured_pass(_timed, host_s, state)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, wall_b = measured_pass(_annotated, None, state)

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
    res = {
        "device": torch.cuda.get_device_name(dev),
        "n": p.n, "slots": p.slots, "churn_ppm": args.churn_ppm,
        "ndev": args.ndev or None, "nemesis": args.nemesis or None,
        "warm_rounds": WARM, "rounds": R,
        "drop_launches": fused.drop_launches + fused.merge_drop_launches,
        "tail_rounds_both_passes": {k: kernel.tail_rounds[k] - tails0[k]
                        for k in tails0},
        "host_ms_per_round": wall_a * 1e3 / R,
        "profiled_host_ms_per_round": wall_b * 1e3 / R,
        "device_busy_ms_per_round": busy_us / 1e3 / R,
        "device_idle_share": 1 - busy_us / 1e6 / wall_a,
        "device_kernels_per_round": sum(e.count for e in kernels) / R,
        "phases": timed,
        "top_ops": [{"op": e.key, "calls_per_round": e.count / R,
                     "device_ms_per_round": self_device_us(e) / 1e3 / R,
                     "host_ms_per_round": e.self_cpu_time_total / 1e3 / R}
                    for e in ops[:12]],
        "top_kernels": [{"kernel": e.key[:90], "calls_per_round": e.count / R,
                         "device_ms_per_round": self_device_us(e) / 1e3 / R}
                        for e in kernels[:8]],
    }
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
