"""The port's cross-validation rows of two catalog scenarios at the
reference's own slot provisioning, on the CPU, written to
``CROSSVAL_WIDE.json``: ``crossval.run_nemesis_config`` for
``partition_heal`` and ``zone_kill`` at n = 4,096, one seed, its default
slots (``max(64, next_pow2(n))`` = 4,096); ``zone_kill`` with the oracle,
``partition_heal`` without it (the pure-Python oracle walks the full
bisection's cross-side suspicions message by message: a run of it at
n = 4,096 does not end in useful time).

    PYTHONPATH=. python3 tools/wide_nemesis_rows.py [--threads T]

``chip_smoke.py``'s wide_slots phase holds the card's kernel side of the
same configuration against these rows, field for field (the kernel's of
each per-model pair), as its crossval phase holds the card against
``CROSSVAL.json``.  The CPU side takes seconds of one core a
non-quiescent round at [4,096, 4,096] (the plain dissemination tail),
400 rounds a scenario, far past the smoke run's time limit, so it is
recorded here rather than run in a worker beside the card.  Each scenario
runs in a process of its own, both at once.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N, SEEDS = 4096, 1
ORACLE = {"partition_heal": False, "zone_kill": True}


def _row(name: str, threads: int) -> dict:
    import torch

    from consul_tpu_torch.gossip import crossval
    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    row = crossval.run_nemesis_config(name, N, SEEDS, oracle=ORACLE[name],
                                      device="cpu")
    return {"row": row, "cpu_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--threads", type=int, default=4,
                    help="torch threads a scenario's process")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    with ProcessPoolExecutor(len(ORACLE), mp_context=get_context("spawn")) \
            as pool:
        futs = {name: pool.submit(_row, name, args.threads)
                for name in ORACLE}
        rows = {name: f.result() for name, f in futs.items()}
    out = {"definition": "crossval.run_nemesis_config(name, n, seeds, "
                         "oracle=..., device='cpu') of consul_tpu_torch; "
                         "default slots max(64, next_pow2(n))",
           "oracle": ORACLE,
           "generated_by": "tools/wide_nemesis_rows.py",
           "n": N, "seeds": SEEDS,
           "rows": {name: r["row"] for name, r in rows.items()},
           "cpu_s": {name: r["cpu_s"] for name, r in rows.items()},
           "threads": args.threads}
    (ROOT / "CROSSVAL_WIDE.json").write_text(json.dumps(out, indent=1)
                                             + "\n")
    print(json.dumps(out["cpu_s"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
