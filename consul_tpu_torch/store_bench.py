"""Time the device store's two kernels (``kv_apply``, ``watch_match``) at
``chip_smoke.py``'s store shapes, for the checkout in the current
directory, so that two checkouts can be compared on one card in one call
(parent, change, change, parent):

    cd <checkout> && python3 <this repo>/consul_tpu_torch/store_bench.py

The inputs come from this repo's ``chip_smoke.py`` (its store stream, its
watch set and events), the kernels from the ``consul_tpu_torch`` of the
current directory, through the public wrappers only.  ``kv_apply``: the
capacity-65,536 table filled to half and run through the mixed stream,
then the last batch of 4,096, 64 and 1 ops, 4,096 ops on one key, and
2,049 ops padded to 4,096 as the bridge pads a chunk, each timed on a
copy of the table; ``watch_match``: 65,536 and 1,048,576 watches against
256 events.  Times are CUDA-graph replays (``chip_smoke.graph_ms``).
Prints nvidia-smi's name and power limit, then one JSON line a shape.
Needs a card.
"""

import importlib.util
import json
import os
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    if not torch.cuda.is_available():
        print("store_bench: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path[0] = os.getcwd()  # the checkout under test, not this file's
    cs = _chip_smoke()
    from consul_tpu_torch.state import device_store as tds
    card = cs.card()
    C, P = cs.STORE["capacity"], cs.STORE["probe"]
    enc = cs._store_encoder()
    chunks, _ = cs._store_stream(cs.STORE["seed"], C // 2, 2**31 - 50_000,
                                 cs.STORE_BATCHES)
    tab = tds.DeviceKVTable(C, P, device="cuda").tab
    last = {}
    for chunk in chunks:
        ops = enc._encode_ops(chunk)[0].cuda()
        tds.kv_apply(tab, ops, P)
        last[len(chunk)] = ops
    last["one_key"] = enc._encode_ops(cs._one_key_ops(4096, 2**31 - 10))[0]
    last["trailing_pads"] = enc._encode_ops(
        [c for c in chunks if len(c) == 4096][-1][:2049])[0]
    out = {"checkout": os.getcwd(), "card": card}
    for name, ops in last.items():
        ops = ops.cuda()
        copy = tuple(t.clone() for t in tab)
        sched = {}
        if hasattr(tds, "kv_apply_schedule"):  # not in older checkouts
            sched = tds.kv_apply_schedule(copy, ops, P)[1]
        ms = cs.graph_ms(lambda: tds.kv_apply(copy, ops, P))
        print(json.dumps({**out, "kernel": "kv_apply", "shape": name,
                          "ops": ops.shape[0], "ms": ms, **sched}),
              flush=True)
    bridge = tds.DeviceStoreBridge(capacity=64, stats=None, device="cuda",
                                   lmax=cs.WATCH["lmax"])
    for W in cs.WATCH_W:
        watches = bridge.encode_predicates([cs._watch_pred(i)
                                            for i in range(W)])
        ev, hp = bridge._encode_events(cs._watch_events(
            W, 0, cs.WATCH["events"], cs.WATCH["seed"]))
        counts = {}
        if hasattr(tds, "watch_match_stats"):
            counts = tds.watch_match_stats(watches, ev, hp, cs.WATCH["lmax"])
        ms = cs.graph_ms(lambda: tds.watch_match(watches, ev, hp,
                                                 cs.WATCH["lmax"]))
        print(json.dumps({**out, "kernel": "watch_match", "shape": W,
                          "events": ev.shape[1], "ms": ms, **counts}),
              flush=True)
        del watches
    return 0


if __name__ == "__main__":
    sys.exit(main())
