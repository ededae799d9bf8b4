"""A/B of two checkouts of the PyTorch/CUDA port on one card: seams of the
round on the 1M main path's data, as the checkout in the current
directory runs them: the probe tick (the tick, its lanes and slot step,
and the rearmed rows' wipe and the marks with no rearmed row and with
three), the dissemination tail followed by the finish step's decide, the
spread's count followed by the finish step's record with the hist banks
(one slot expiring with its verdict), and the fire pass followed by the
finish step's settle (seven rows whose timers have run out).

    cd <checkout> && PYTHONPATH=. python3 <repo>/tools/torch_pair_ab.py

Run it in each checkout in turns (parent, change, change, parent) in one
call.  It calls only entry points that every checkout since the probe
tick's lanes and slot step merged has (``kernel._probe_tick``,
``probe.probe_lanes_slots``, ``fused.disseminate``,
``finish_slots.finish_decide`` and ``decide``, ``finish_settle`` and
``settle``,
``finish_record`` and ``record``, ``observe.count``,
``finish.fire_timers``), and, for the wipe and the
marks, whichever form the checkout has: one launch of
``probe.probe_rearm_marks``, or ``finish.wipe_rows`` then
``probe.probe_marks``.  The data: every node a live member but 1,000 per
million failed (on a stride), 8 live slots on failed nodes, the matrix
zero but those rows (random bytes), loss 0, S = 64; one device and 8
shards.  Times from CUDA-graph replays (20 calls a graph, 10 replays; the
state carried from call to call), so the wrappers' host time is left
out.  Prints the card's name and power limit, then one JSON line.  Needs
a card.  Not part of the port: ``chip_smoke.py`` times the same seams
of its own checkout.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

N, S, RND = 1_000_000, 64, 52
NEVER = 2**31 - 1


def graph_ms(fn, per_graph: int = 20, replays: int = 10) -> float:
    """Device ms of one ``fn`` call, from replays of a graph of
    ``per_graph`` calls."""
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


def _shard(x, ndev: int):
    if ndev == 1:
        return x
    L = x.shape[1] // ndev
    return tuple(x[:, i * L:(i + 1) * L].clone() for i in range(ndev))


def _row(p, seed: int):
    from consul_tpu_torch import prng
    from consul_tpu_torch.gossip import round_args
    return round_args.row_args(
        round_args.layout(p.fanout, p.indirect_k),
        torch.from_numpy(round_args.build(p, prng.key(seed), RND, 1)[0])
        .to("cuda"))


def _main_state(seed: int = 5):
    """mf, the slot registers, slot_of_node and the matrix of the main
    path: 8 live SUSPECT slots on failed nodes, their rows random."""
    dev = "cuda"
    mf = torch.full((N,), NEVER, dtype=torch.int32, device=dev)
    dead = torch.arange(0, N, 1000, device=dev)
    mf[dead] = 10
    live = dead[:8]
    regs = [torch.full((S,), v, dtype=torch.int32, device=dev)
            for v in (-1, 0, 0, 0, 0, -1)]
    regs[0][:8] = live.to(torch.int32)
    regs[1][:8] = 1
    son = torch.full((N,), -1, dtype=torch.int32, device=dev)
    son[live] = torch.arange(8, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    heard = torch.zeros((S, N), dtype=torch.uint8, device=dev)
    heard[:8] = torch.randint(0, 256, (8, N), device=dev, dtype=torch.uint8,
                              generator=g)
    return mf, regs, son, heard


def probe_times(ndev: int) -> dict:
    """The probe tick on the main path's data: the tick as the round runs
    it, its lanes and slot step, the wipe and marks with no rearmed row
    and with three (rows 0-2), each alone."""
    from consul_tpu_torch.gossip import finish, kernel, probe
    from consul_tpu_torch.gossip.params import SwimParams
    p = SwimParams(n=N, slots=S, probe_every=5, indirect_k=3,
                   loss_rate=0.0)
    v = kernel.round_variant(p, None, RND)
    cfg = probe.config(p, v, None)
    ra = _row(p, 5)
    mf, regs, son, heard = _main_state()
    heard = _shard(heard, ndev)
    inc = torch.zeros(N, dtype=torch.int32, device="cuda")
    member = torch.ones(N, dtype=torch.bool, device="cuda")
    drops = torch.zeros((), dtype=torch.int32, device="cuda")
    sp = probe.scratch(p, "cuda")
    carry = (heard, *regs, son, inc, member, drops)
    t = probe.Tick(heard, ra, mf, son, None, tuple(regs), inc, drops, sp)
    none = torch.zeros(S, dtype=torch.bool, device="cuda")
    three = none.clone()
    three[:3] = True
    merged = hasattr(probe, "probe_rearm_marks")

    def rearm_marks(rearm):
        if merged:
            probe.probe_rearm_marks(cfg, t, rearm)
        else:
            finish.wipe_rows(t.heard, rearm)
            probe.probe_marks(cfg, t)

    out = {"form": "probe_rearm_marks" if merged
           else "wipe_rows + probe_marks",
           "tick_ms": graph_ms(lambda: kernel._probe_tick(
               p, ra, v, mf, carry, sp)),
           "lanes_slots_ms": graph_ms(lambda: probe.probe_lanes_slots(cfg,
                                                                      t)),
           "rearm_marks_none_ms": graph_ms(lambda: rearm_marks(none)),
           "rearm_marks_three_ms": graph_ms(lambda: rearm_marks(three))}
    if not merged:
        out["marks_ms"] = graph_ms(lambda: probe.probe_marks(cfg, t))
        out["wipe_none_ms"] = graph_ms(lambda: finish.wipe_rows(t.heard,
                                                                none))
    return out


def tail_decide_setup(ndev: int):
    """The tail's and decide's inputs on the main path's data (the LAN
    profile at 1M, S = 64, every slot a row): ``(cfg, t, tail)``, the
    step's configuration, its tensors (``finish_slots.Step``) and the
    tail as a function of none that returns its output."""
    from consul_tpu_torch.gossip import finish_slots, fused, kernel
    from consul_tpu_torch.gossip.params import lan_profile
    p = lan_profile(N, slots=S, hot_slots=0)
    cfg = finish_slots.config(p, None)
    ra = _row(p, 7)
    rnd = int(ra.rnd)
    mf, regs, son, heard = _main_state()
    fail = torch.where(mf < 0, NEVER, mf)
    alive = fail > rnd
    member = torch.ones(N, dtype=torch.bool, device="cuda")
    rx_ok = alive & member
    cap = torch.zeros(S, dtype=torch.int32, device="cuda")
    sc = None if ndev == 1 else kernel._ShardCtx(ndev, N // ndev)
    heard = _shard(heard, ndev)
    fregs = (regs[0], regs[1], regs[4], regs[5])  # node, phase, start, dead
    t = finish_slots.Step(
        heard, ra.rnd, torch.arange(S, dtype=torch.int32, device="cuda"),
        fregs, cap, alive, member, fail, son,
        torch.zeros(N, dtype=torch.int32, device="cuda"),
        tuple(torch.zeros((), dtype=torch.int32, device="cuda")
              for _ in range(4)), None, None)

    def tail():
        return fused.disseminate(p, ra.rnd, ra.gossip, heard, mf, rx_ok,
                                 cap, sc, None)

    return cfg, t, tail


def tail_decide_times(ndev: int) -> dict:
    """The tail and decide on the main path's data, each alone, and the
    pair as the round runs it (the tail, then the round's
    ``finish_slots.decide`` on its output)."""
    from consul_tpu_torch.gossip import finish_slots
    cfg, t, tail = tail_decide_setup(ndev)

    def pair():
        finish_slots.decide(cfg, t._replace(heard=tail()))

    return {"tail_ms": graph_ms(tail),
            "decide_ms": graph_ms(lambda: finish_slots.finish_decide(cfg,
                                                                     t)),
            "pair_ms": graph_ms(pair)}


def count_record_setup(ndev: int):
    """The spread's count's and record's inputs on the main path's data
    with the hist banks: slot 7 made DEAD past its GC window (its
    subject's own byte DEAD), then decide, the fire and settle run, so
    that the slot expires with its verdict and drops its subject.
    Returns ``(cfg, t, dec, st, scratch)``."""
    from consul_tpu_torch.gossip import finish, finish_slots, kernel, observe
    from consul_tpu_torch.gossip.params import lan_profile
    p = lan_profile(N, slots=S, hot_slots=0)
    cfg = finish_slots.config(p, None)
    ra = _row(p, 7)
    rnd = int(ra.rnd)
    mf, regs, son, heard = _main_state()
    regs[1][7], regs[5][7] = 2, rnd - cfg.gc_rounds - 1
    subject = int(regs[0][7])
    heard[7, subject] = 0x80
    fail = torch.where(mf < 0, NEVER, mf)
    alive = fail > rnd
    member = torch.ones(N, dtype=torch.bool, device="cuda")
    cap = torch.zeros(S, dtype=torch.int32, device="cuda")
    t = finish_slots.Step(
        _shard(heard, ndev), ra.rnd,
        torch.arange(S, dtype=torch.int32, device="cuda"),
        (regs[0], regs[1], regs[4], regs[5]), cap, alive, member, fail,
        son, torch.zeros(N, dtype=torch.int32, device="cuda"),
        tuple(torch.zeros((), dtype=torch.int32, device="cuda")
              for _ in range(4)), None, kernel.init_hist(device="cuda"))
    scratch = observe.counts_scratch(S, "cuda")
    torch.cuda.synchronize()
    dec = finish_slots.finish_decide(cfg, t)
    fired = finish.fire_timers(t.heard, alive & member, dec.ok_mask,
                               dec.refute, scratch)
    st = finish_slots.finish_settle(cfg, t, fired)
    torch.cuda.synchronize()
    return cfg, t, dec, st, scratch


def count_record_times(ndev: int) -> dict:
    """The spread's count (one row wanted) and record with the banks on
    the main path's data, each alone, and the pair as the round runs it
    (``observe.count``, then ``finish_slots.record`` on its holders)."""
    from consul_tpu_torch.gossip import finish_slots, observe
    cfg, t, dec, st, scratch = count_record_setup(ndev)

    def count():
        return observe.count(t.heard, t.member, cfg.budget, st.verdict,
                             st.spread, scratch)[observe.HOLD]

    n_hold = count()

    def pair():
        finish_slots.record(cfg, t, dec, st, count())

    return {"rows_wanted": int(st.spread.sum()),
            "count_ms": graph_ms(count),
            "record_ms": graph_ms(lambda: finish_slots.finish_record(
                cfg, t, dec, st, n_hold)),
            "pair_ms": graph_ms(pair)}


def fire_settle_setup(ndev: int):
    """The fire's and settle's inputs on the main path's data: slots 0-6
    (SUSPECT on failed nodes) with their timers run out, so those rows
    fire, and decide run.  Returns ``(cfg, t, dec, rx, scratch)``."""
    from consul_tpu_torch.gossip import finish_slots, observe
    from consul_tpu_torch.gossip.params import lan_profile
    p = lan_profile(N, slots=S, hot_slots=0)
    cfg = finish_slots.config(p, None)
    ra = _row(p, 7)
    rnd = int(ra.rnd)
    mf, regs, son, heard = _main_state()
    regs[4][:7] = rnd - cfg.tbl[0]
    fail = torch.where(mf < 0, NEVER, mf)
    alive = fail > rnd
    member = torch.ones(N, dtype=torch.bool, device="cuda")
    cap = torch.zeros(S, dtype=torch.int32, device="cuda")
    t = finish_slots.Step(
        _shard(heard, ndev), ra.rnd,
        torch.arange(S, dtype=torch.int32, device="cuda"),
        (regs[0], regs[1], regs[4], regs[5]), cap, alive, member, fail,
        son, torch.zeros(N, dtype=torch.int32, device="cuda"),
        tuple(torch.zeros((), dtype=torch.int32, device="cuda")
              for _ in range(4)), None, None)
    scratch = observe.counts_scratch(S, "cuda")
    torch.cuda.synchronize()
    dec = finish_slots.finish_decide(cfg, t)
    torch.cuda.synchronize()
    return cfg, t, dec, alive & member, scratch


def fire_settle_times(ndev: int) -> dict:
    """The fire and settle on the main path's data, each alone, and the
    pair as the round runs it (``finish.fire_timers``, then
    ``finish_slots.settle`` on its ``fired``); the first fire turns the
    rows DEAD, so the timed fires read rows and change none."""
    from consul_tpu_torch.gossip import finish, finish_slots
    cfg, t, dec, rx, scratch = fire_settle_setup(ndev)

    def fire():
        return finish.fire_timers(t.heard, rx, dec.ok_mask, dec.refute,
                                  scratch)

    fired = fire()
    fired_rows = int(fired.sum())

    def pair():
        finish_slots.settle(cfg, t, fire())

    return {"fired_rows": fired_rows, "fire_ms": graph_ms(fire),
            "settle_ms": graph_ms(lambda: finish_slots.finish_settle(
                cfg, t, fired)),
            "pair_ms": graph_ms(pair)}


def card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed (rc {smi.returncode})"


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pair_ab: no CUDA device", file=sys.stderr)
        return 1
    line = card()
    print(line, flush=True)
    out = {"card": line, "kind": torch.cuda.get_device_name(0)}
    for ndev in (1, 8):
        out[f"probe/{ndev}"] = probe_times(ndev)
        out[f"tail_decide/{ndev}"] = tail_decide_times(ndev)
        out[f"count_record/{ndev}"] = count_record_times(ndev)
        out[f"fire_settle/{ndev}"] = fire_settle_times(ndev)
    out["card_after"] = card()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
